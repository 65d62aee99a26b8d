"""Model configurations of the LM families (dense, Mixture-of-Experts,
cross attention, enc-dec, Mamba-2, Griffin): the published numbers of
each architecture the port serves, plus a same-family ``smoke_config()``
for CPU tests. Importing a config module registers it
(`repro_torch.models.api.register`)."""
