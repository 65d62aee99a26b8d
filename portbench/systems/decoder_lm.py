"""The port's decoder LM (`repro_torch.models`, the ``lm`` family) served
W{w_bits}A{a_bits} as the system under test, through `Model.prefill`.

Set-up: the configuration's file as a `ModelConfig` (its published
sizes; the sliding window as the port's local-attention schedule, every
layer ``local``), float weights made on the device from the seed by the
benchmark (one draw per leaf), packed by the port's
`launch/convert.py::convert_params` into the int-mode tree, as
``launch/serve.py --quant`` does; the float tree is then dropped. The
traffic's pool of token batches; one warm-up call.

A unit of work is one `Model.prefill` call over a (batch, seq) pool
batch, which returns the last-position logits and every layer's K/V,
then a device synchronize. Spans: ``prefill.call``, ``prefill.sync``.

The check runs the plain reference (`reference/decoder_lm.py`) over
every pool batch: every call's logits against its batch's, and the last
call's K/V layer by layer.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.harness import traffic as traffic_mod
from portbench.harness import work

WARMUP = 1
VOCAB_PAD = 256


def padded_vocab(v: int) -> int:
    return v + (-v) % VOCAB_PAD


def leaf_shapes(cfg: dict) -> dict:
    """The float tree the port's ``lm`` family reads: path -> (shape,
    init, fan-in)."""
    m = work.lm_dims(cfg)
    L, d, ff, vp = m["layers"], m["d"], m["ff"], padded_vocab(m["vocab"])
    q, kv = m["h"] * m["dh"], m["hk"] * m["dh"]
    out = {
        "embed/table": ((vp, d), "normal", 1),
        "layers/ln1/scale": ((L, d), "ones", 0),
        "layers/ln2/scale": ((L, d), "ones", 0),
        "layers/attn/wq/w": ((L, d, q), "normal", d),
        "layers/attn/wk/w": ((L, d, kv), "normal", d),
        "layers/attn/wv/w": ((L, d, kv), "normal", d),
        "layers/attn/wo/w": ((L, q, d), "normal", q),
        "layers/mlp/wi/w": ((L, d, ff), "normal", d),
        "layers/mlp/wg/w": ((L, d, ff), "normal", d),
        "layers/mlp/wo/w": ((L, ff, d), "normal", ff),
        "final_norm/scale": ((d,), "ones", 0),
    }
    if not cfg["tie_word_embeddings"]:
        out["head/w"] = ((d, vp), "normal", d)
    return out


def make_fp_params(cfg: dict, seed: int, device) -> dict:
    """Float32 weights on the device: N(0, 1/fan_in) matrices, N(0, 1)
    embeddings, unit norm scales; one draw per leaf, each from its own
    generator seeded from the run's seed and the leaf's path."""
    tree: dict = {}
    for path, (shape, init, fan_in) in leaf_shapes(cfg).items():
        if init == "ones":
            t = torch.ones(shape, device=device)
        else:
            gen = torch.Generator(device=device).manual_seed(
                traffic_mod.sub_seed(seed, "weights/" + path))
            t = torch.randn(shape, generator=gen, device=device)
            if fan_in > 1:
                t.mul_(fan_in ** -0.5)
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree


def port_config(cfg: dict, a_bits: int):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.nn.layers import QuantConfig
    m = work.lm_dims(cfg)
    window = cfg.get("sliding_window") or 0
    return ModelConfig(
        name=cfg["name"], family="lm", n_layers=m["layers"],
        d_model=m["d"], n_heads=m["h"], kv_heads=m["hk"], d_ff=m["ff"],
        vocab=m["vocab"], head_dim=m["dh"], act="swiglu", norm="rmsnorm",
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]), window=window,
        pattern=("local",) if window else (), remat=False,
        compute_dtype=cfg["compute_dtype"],
        quant=QuantConfig(mode="int", w_bits=cfg["w_bits"], a_bits=a_bits,
                          a_absmax=cfg["a_absmax"]))


class State:
    pass


def setup(cell, seed: int, device, span):
    from repro_torch.deploy.apply import int_skeleton
    from repro_torch.launch.convert import convert_params
    from repro_torch.models.api import build
    from repro_torch.nn.layers import QOFF

    cfg = cell.config
    st = State()
    st.model = build(port_config(cfg, cfg["a_bits"]))
    fp = make_fp_params(cfg, seed, device)
    _check_shapes(build(dataclasses.replace(st.model.cfg, quant=QOFF))
                  .defs(), fp)
    st.params = convert_params(int_skeleton(st.model.defs()), fp,
                               cfg["w_bits"])
    del fp
    st.pool = traffic_mod.make_pool(cell.traffic, cfg, seed, device)
    st.device = torch.device(device)
    st.logits, st.kv = [], None
    for i in range(WARMUP):
        step(st, i, span)
    st.logits, st.kv = [], None
    return st


def _check_shapes(defs, fp, path=""):
    """The benchmark's tree has the leaves and shapes the port defines."""
    if isinstance(defs, dict):
        if set(defs) != set(fp):
            raise ValueError(f"{path or '/'}: the port defines "
                             f"{sorted(defs)}, the benchmark makes "
                             f"{sorted(fp)}")
        for k in defs:
            _check_shapes(defs[k], fp[k], f"{path}/{k}")
    elif tuple(defs.shape) != tuple(fp.shape):
        raise ValueError(f"{path}: port {tuple(defs.shape)} vs benchmark "
                         f"{tuple(fp.shape)}")


def step(st, i: int, span) -> dict:
    slot = i % len(st.pool)
    tokens = st.pool[slot]["tokens"]
    st.kv = None                   # the previous call's K/V may go
    with torch.inference_mode():
        with span("prefill.call"):
            logits, kv = st.model.prefill(st.params, {"tokens": tokens})
        with span("prefill.sync"):
            if st.device.type == "cuda":
                torch.cuda.synchronize(st.device)
    # a copy: the returned row is a view that would keep the call's
    # whole (batch, seq, vocab) logits alive
    st.logits.append((slot, logits.clone()))
    st.kv = (slot, kv)
    b, s = tokens.shape
    return {"tokens": b * s, "rows": b, "seq": s}


def outputs(st):
    return {"logits": st.logits, "kv": st.kv}


def reference_outputs(cell, seed: int, device, a_bits: int, kv_slot=None,
                      on_layer=None) -> list:
    """The reference's last-position logits (float32) of every pool
    batch; ``on_layer(i, k, v)`` sees the K/V of pool batch ``kv_slot``
    layer by layer."""
    cfg = cell.config
    fp = make_fp_params(cfg, seed, device)
    pool = traffic_mod.make_pool(cell.traffic, cfg, seed, device)
    return [cell.reference.last_logits(
        cfg, fp, b["tokens"], a_bits,
        on_layer=on_layer if slot == kv_slot else None)
        for slot, b in enumerate(pool)]


def compare(cell, seed: int, device, outs, a_bits: int) -> dict:
    """Relative gaps against the reference: every call's logits (over
    the real vocabulary, against the row's largest |logit|), and the K/V
    of the last call, per layer against the layer's largest |value|."""
    vocab = cell.config["vocab_size"]
    kv_slot, (k_all, v_all) = outs["kv"]
    kv_err = [0.0]

    def on_layer(i, k, v):
        for got, want in ((k_all[i], k), (v_all[i], v)):
            gap = (got.to(torch.float32) - want.to(torch.float32)).abs()
            kv_err[0] = max(kv_err[0], float(gap.max()
                                             / want.abs().max()))

    ref = reference_outputs(cell, seed, device, a_bits, kv_slot, on_layer)
    lg_err = 0.0
    for slot, lg in outs["logits"]:
        got = lg.reshape(lg.shape[0], -1)[:, :vocab].to(torch.float32)
        want = ref[slot].to(got.device)
        row = ((got - want).abs().amax(dim=-1)
               / want.abs().amax(dim=-1))
        lg_err = max(lg_err, float(row.max()))
    return {"logits_rel_err": lg_err, "kv_rel_err": kv_err[0],
            "calls_compared": len(outs["logits"])}


def check(cell, seed: int, device, outs) -> dict:
    return compare(cell, seed, device, outs, cell.config["a_bits"])


def control_outputs(cell, seed: int, device) -> dict:
    """The control: the reference in the program's place, its dense
    layers' activations at the control's lower precision; one call per
    pool batch, the last one's K/V kept."""
    cfg = cell.config
    low = cfg["control"]["a_bits"]
    fp = make_fp_params(cfg, seed, device)
    pool = traffic_mod.make_pool(cell.traffic, cfg, seed, device)
    logits, ks, vs = [], [], []
    for slot, b in enumerate(pool):
        last = slot == len(pool) - 1
        ks.clear()
        vs.clear()
        lg = cell.reference.last_logits(
            cfg, fp, b["tokens"], low,
            on_layer=(lambda i, k, v: (ks.append(k), vs.append(v)))
            if last else None)
        logits.append((slot, lg))
    return {"logits": logits,
            "kv": (len(pool) - 1, (torch.stack(ks), torch.stack(vs)))}
