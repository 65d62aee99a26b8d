"""Model registry: one API over the model families the port serves.

`Model` exposes init / specs / loss / forward / prefill / decode /
init_cache; the server and the tests talk only to it. Under an active
mesh with a ``model`` axis above 1 (`repro_torch.parallel.tp.tp_scope`,
or `repro_torch.parallel.ctx.use_mesh` for data block 0) they run
tensor-parallel; `place` / `place_cache` put a params tree or a decode
cache on a group's positions once (`tp_cuts` / `cache_cuts`). The port
serves the ``lm`` family (dense, Mixture-of-Experts, and
llama-3.2-vision's cross layers), the enc-dec family, Mamba-2 and
Griffin. A batch may carry ``src_embed`` (B, S_src, d), the stubbed
frontend's output that the enc-dec encoder and the vision cross layers
read.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, griffin, lm, mamba
from repro_torch.nn.module import init_params, logical_specs
from repro_torch.parallel import tp
from repro_torch.parallel.ctx import active_mesh

_FAMILIES = {
    "lm": (lm.lm_def, lm.forward, lm.decode_step, lm.lm_init_cache,
           lm.lm_cuts, lm.lm_cache_cuts),
    "encdec": (encdec.encdec_def, encdec.forward, encdec.decode_step,
               encdec.encdec_init_cache, encdec.encdec_cuts,
               encdec.encdec_cache_cuts),
    "mamba": (mamba.mamba_lm_def, mamba.forward, mamba.decode_step,
              mamba.mamba_lm_init_cache, mamba.mamba_lm_cuts,
              mamba.mamba_lm_cache_cuts),
    "griffin": (griffin.griffin_def, griffin.forward, griffin.decode_step,
                griffin.griffin_init_cache, griffin.griffin_cuts,
                griffin.griffin_cache_cuts),
}


def _scope():
    """The ambient group: the one `tp_scope` set, else data block 0 of
    an active mesh (`parallel.ctx.use_mesh`), else none."""
    mesh = active_mesh()
    if tp.ambient() is not None or mesh is None or \
            tp.model_size(mesh) == 1:
        return contextlib.nullcontext()
    return tp.tp_scope(tp.TPGroup(mesh, 0))


def _family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not in the "
            f"reference; the port serves {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        _family(self.cfg)

    @property
    def _fns(self):
        return _family(self.cfg)

    # ---- params ----
    def defs(self):
        pd = (torch.float32 if self.cfg.param_dtype == "float32"
              else torch.bfloat16)
        return self._fns[0](self.cfg, pd)

    def init(self, seed: int, device="cuda"):
        """Seeded random parameters on ``device`` (default the card)."""
        return init_params(self.defs(), seed, device)

    def specs(self):
        return logical_specs(self.defs())

    # ---- tensor parallelism ----
    def tp_cuts(self, m: int):
        """The params tree's `Cut`s over ``m`` model positions."""
        return self._fns[4](self.cfg, m)

    def cache_cuts(self, cache, mesh):
        """A decode cache's `Cut`s over ``mesh``'s model positions (its
        KV where `cache_shardings` puts the ``model`` entry)."""
        return self._fns[5](self.cfg, cache, mesh)

    def place(self, params, group):
        """``params`` split over ``group`` (weight-stationary): each
        position keeps its slices, replicated leaves stay on the
        leader."""
        return tp.place(params, self.tp_cuts(group.m), group)

    def place_cache(self, cache, group):
        return tp.place(cache, self.cache_cuts(cache, group.mesh), group)

    # ---- training loss (teacher-forced) ----
    def loss(self, params, batch, aux_weight: float = 0.01):
        with _scope():
            logits, aux, _ = self._fns[1](params, batch["tokens"], self.cfg,
                                          src_embed=batch.get("src_embed"))
        logits = logits.to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[
            ..., 0]
        # z-loss keeps logits bounded (stability at scale)
        zl = 1e-4 * torch.square(torch.logsumexp(logits, dim=-1))
        return nll.mean() + zl.mean() + aux_weight * aux

    def forward(self, params, batch):
        with _scope():
            return self._fns[1](params, batch["tokens"], self.cfg,
                                src_embed=batch.get("src_embed"))

    # ---- serving ----
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda"):
        return self._fns[3](self.cfg, batch, max_len, dtype, device)

    def prefill(self, params, batch):
        """Full forward over the prompt; returns last-position logits and
        the stacked (k, v) of every layer, the latent (c_kv, k_pe) of a
        latent-attention arch (None for the recurrent, the enc-dec and
        the vision families); `models/lm.py::cache_from_prefill` puts an
        ``lm`` prefill's into a decode cache."""
        with _scope():
            logits, _, kvs = self._fns[1](params, batch["tokens"],
                                          self.cfg,
                                          src_embed=batch.get("src_embed"),
                                          collect_kv=True)
        return logits[:, -1:], kvs

    def fill_cross_kv(self, params, cache, src_embed):
        """Set ``cache["cross_kv"]`` to the cross K/V of ``src_embed`` (B,
        S_src, d), in the cache's dtype (S_src may differ from the
        config's src_len; a placed cache is filled under its group's
        `tp_scope`); returns the cache. An enc-dec model projects
        its encoder's states, a vision arch the embeddings themselves."""
        if not _needs_src(self.cfg):
            raise ValueError(f"{self.cfg.name} has no cross attention")
        fam = encdec if self.cfg.family == "encdec" else lm
        with _scope():
            kv = fam.source_kv(params, src_embed, self.cfg)
        old = cache["cross_kv"]
        kv = kv.to(old.dtype)
        if isinstance(old, tp.Split):   # a placed cache keeps its split
            kv = tp.place_leaf(kv, old.cut, tp.ambient())
        cache["cross_kv"] = kv
        return cache

    def decode(self, params, cache, token, index, src_embed=None):
        """One step; ``src_embed`` is read by no family (the cache
        carries the cross K/V)."""
        with _scope():
            return self._fns[2](params, cache, token, index, self.cfg,
                                src_embed=src_embed)


def _needs_src(cfg: ModelConfig) -> bool:
    """Whether the model's forward reads ``src_embed``."""
    return cfg.family == "encdec" or cfg.cross_every > 0


_REGISTRY: dict = {}
_LOADED = False  # importing one config module registers it alone


def register(cfg: ModelConfig):
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _LOADED:
        _load_all()
    return _REGISTRY[name]


def list_archs():
    if not _LOADED:
        _load_all()
    return sorted(_REGISTRY)


def _config_modules():
    import importlib
    import pkgutil

    import repro_torch.configs as cpkg
    for mod in pkgutil.iter_modules(cpkg.__path__):
        if mod.name != "base":
            yield importlib.import_module(f"repro_torch.configs.{mod.name}")


def _load_all():
    global _LOADED
    for _ in _config_modules():
        pass
    _LOADED = True


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for the arch with this registry name."""
    for m in _config_modules():
        if getattr(m, "CONFIG", None) is not None and m.CONFIG.name == name:
            return m.smoke_config()
    raise KeyError(name)


def build(name_or_cfg) -> Model:
    cfg = (name_or_cfg if isinstance(name_or_cfg, ModelConfig)
           else get_config(name_or_cfg))
    return Model(cfg)
