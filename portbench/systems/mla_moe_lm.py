"""The port's DeepSeek-V3-block LM (`repro_torch.models`, the ``lm`` family
with latent attention, leading dense layers and the dropless MoE over
the experts held here: the registered ``kimi-k2-instruct``) served
W{w_bits}A{a_bits} as the system under test, through `Model.prefill`.

Set-up: the registered config the file names (``arch``) with its depth and
expert share (``num_hidden_layers``; ``n_routed_experts`` held from
``experts_offset``), every other published number checked equal to the
file's, in int mode. Float weights are made on the device one layer at a
time, one draw per leaf from a sub-seed of the run's seed and the leaf's
path (`layer_fp`); each layer is packed by the port's
`launch/convert.py::convert_params` (every dense of the layer, the held
experts per expert along their own K), copied into the stacked int tree
and dropped, so the whole float tree never exists. The traffic's pool of
token batches; one warm-up call.

A unit of work is one `Model.prefill` call over a (batch, seq) pool
batch, which returns the last-position logits and every layer's latent
(c_kv, k_pe), then a device synchronize. Spans: ``prefill.call``,
``prefill.sync``.

The check runs the plain reference (`reference/mla_moe_lm.py`) over
every pool batch, layer by layer from the same `layer_fp` weights:
every call's logits against its batch's, and the last call's latent
layer by layer, as root-mean-square gaps (`compare`). After the window,
one more call of the last call's batch records each MoE layer's expert
choices (`program_routes`), and the reference routed as the program
routed is held against that call's logits.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.harness import traffic as traffic_mod

WARMUP = 1


def top_shapes(cfg: dict) -> dict:
    """path -> (shape, init, fan-in) of the leaves outside the layers."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return {"embed/table": ((v, d), "normal", 1),
            "final_norm/scale": ((d,), "ones", 0),
            "head/w": ((d, v), "normal", d)}


def layer_shapes(cfg: dict, i: int) -> dict:
    """path -> (shape, init, fan-in) of layer i's leaves, in the port's
    layout (a dense layer's ``mlp``, a MoE layer's ``moe``)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    rq, rkv = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    out = {
        "ln1/scale": ((d,), "ones", 0),
        "attn/wq_a/w": ((d, rq), "normal", d),
        "attn/q_norm/scale": ((rq,), "ones", 0),
        "attn/wq_b/w": ((rq, h * (nope + rope)), "normal", rq),
        "attn/wkv_a/w": ((d, rkv + rope), "normal", d),
        "attn/kv_norm/scale": ((rkv,), "ones", 0),
        "attn/wkv_b/w": ((rkv, h * (nope + dv)), "normal", rkv),
        "attn/wo/w": ((h * dv, d), "normal", h * dv),
        "ln2/scale": ((d,), "ones", 0),
    }
    if i < cfg["first_k_dense_replace"]:
        ff = cfg["intermediate_size"]
        out.update({"mlp/wi/w": ((d, ff), "normal", d),
                    "mlp/wg/w": ((d, ff), "normal", d),
                    "mlp/wo/w": ((ff, d), "normal", ff)})
        return out
    f, e = cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    routed = cfg["published"]["n_routed_experts"]
    out.update({"moe/router": ((d, routed), "normal", d),
                "moe/router_bias": ((routed,), "bias", 0),
                "moe/wi/w": ((e, d, f), "normal", d),
                "moe/wg/w": ((e, d, f), "normal", d),
                "moe/wo/w": ((e, f, d), "normal", f)})
    if cfg["n_shared_experts"]:
        sf = f * cfg["n_shared_experts"]
        out.update({"moe/shared/wi/w": ((d, sf), "normal", d),
                    "moe/shared/wg/w": ((d, sf), "normal", d),
                    "moe/shared/wo/w": ((sf, d), "normal", sf)})
    return out


def _make(cfg: dict, shapes: dict, prefix: str, seed: int, device) -> dict:
    """Float32 leaves on the device: N(0, 1/fan_in) matrices, N(0, 1)
    embeddings, unit norm scales, the router bias N(0, router_bias_std^2);
    one draw per leaf, from a generator seeded from the run's seed and
    the leaf's path."""
    tree: dict = {}
    for path, (shape, init, fan_in) in shapes.items():
        if init == "ones":
            t = torch.ones(shape, device=device)
        else:
            gen = torch.Generator(device=device).manual_seed(
                traffic_mod.sub_seed(seed, f"weights/{prefix}{path}"))
            t = torch.randn(shape, generator=gen, device=device)
            if init == "bias":
                t.mul_(float(cfg["router_bias_std"]))
            elif fan_in > 1:
                t.mul_(fan_in ** -0.5)
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree


def top_fp(cfg: dict, seed: int, device) -> dict:
    return _make(cfg, top_shapes(cfg), "", seed, device)


def layer_fp(cfg: dict, seed: int, i: int, device) -> dict:
    """Layer i's float weights (dense layers first)."""
    return _make(cfg, layer_shapes(cfg, i), f"layers/{i}/", seed, device)


# (the file's key, the port config's value) of every published number
# the port reads
def _published(c) -> dict:
    m, ys = c.moe, c.rope_scaling
    return {
        "hidden_size": c.d_model, "num_attention_heads": c.n_heads,
        "q_lora_rank": c.q_lora_rank, "kv_lora_rank": c.kv_lora_rank,
        "qk_nope_head_dim": c.qk_nope_dim, "qk_rope_head_dim": c.qk_rope_dim,
        "v_head_dim": c.v_head_dim, "intermediate_size": c.dense_d_ff,
        "moe_intermediate_size": m.d_ff, "num_experts_per_tok": m.top_k,
        "first_k_dense_replace": c.first_dense_layers,
        "n_shared_experts": int(m.shared_expert),
        "routed_scaling_factor": m.routed_scale,
        "norm_topk_prob": m.norm_topk, "rope_theta": c.rope_theta,
        "vocab_size": c.vocab, "tie_word_embeddings": c.tie_embeddings,
        "rope_scaling": {"factor": ys.factor, "original_max_position_"
                         "embeddings": ys.original_max_position,
                         "beta_fast": ys.beta_fast,
                         "beta_slow": ys.beta_slow, "mscale": ys.mscale,
                         "mscale_all_dim": ys.mscale_all_dim},
        "n_routed_experts": m.n_experts, "num_hidden_layers": c.n_layers,
        "scoring_func": {"sigmoid_noaux": "sigmoid"}.get(m.scoring),
    }


def port_config(cfg: dict, a_bits: int):
    """The registered config at the file's depth and expert share, in
    int mode at ``a_bits``; a published number that differs raises."""
    from repro_torch.models.api import get_config
    from repro_torch.nn.layers import QuantConfig
    base = get_config(cfg["arch"])
    for key, got in _published(base).items():
        want = cfg.get("published", {}).get(key, cfg[key])
        if key == "rope_scaling":
            want = {k: v for k, v in want.items() if k != "type"}
        if got != want:
            raise ValueError(f"{cfg['arch']}: the port's {key} {got!r} is "
                             f"not the configuration's {want!r}")
    return dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"],
        compute_dtype=cfg["compute_dtype"], remat=False,
        moe=dataclasses.replace(base.moe,
                                experts_held=cfg["n_routed_experts"],
                                experts_offset=cfg["experts_offset"]),
        quant=QuantConfig(mode="int", w_bits=cfg["w_bits"], a_bits=a_bits,
                          a_absmax=cfg["a_absmax"]))


def _where(cfg: dict, i: int):
    """(stacked tree, row) of layer i."""
    n_dense = cfg["first_k_dense_replace"]
    return ("dense_layers", i) if i < n_dense else ("layers", i - n_dense)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _check_shapes(defs, fp, where: str):
    """The benchmark's layer has the leaves and shapes the port defines
    (``defs``: the port's stacked float defs, one row)."""
    got = {p: tuple(t.shape) for p, t in _leaves(fp)}
    want = {p: tuple(d.shape[1:]) for p, d in _leaves(defs)}
    if got != want:
        raise ValueError(f"{where}: the port defines {want}, the benchmark "
                         f"makes {got}")


class State:
    pass


def setup(cell, seed: int, device, span):
    from repro_torch.deploy.apply import int_skeleton
    from repro_torch.launch.convert import convert_params
    from repro_torch.models.api import build
    from repro_torch.models.lm import layer_params
    from repro_torch.nn.layers import QOFF

    cfg = cell.config
    st = State()
    st.model = build(port_config(cfg, cfg["a_bits"]))
    fdefs = build(dataclasses.replace(st.model.cfg, quant=QOFF)).defs()
    skel = int_skeleton(st.model.defs())
    params = top_fp(cfg, seed, device)
    for stack in ("dense_layers", "layers"):
        params[stack] = {}
        for path, t in _leaves(skel[stack]):
            node = params[stack]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.empty(t.shape, dtype=t.dtype,
                                         device=device)
    for i in range(cfg["num_hidden_layers"]):
        stack, row = _where(cfg, i)
        fp = layer_fp(cfg, seed, i, device)
        _check_shapes(fdefs[stack], fp, f"layer {i} ({stack})")
        packed = convert_params(layer_params(skel[stack], 0), fp,
                                cfg["w_bits"])
        for path, t in _leaves(packed):
            _get(params[stack], path)[row].copy_(t)
        del fp, packed
    st.params = params
    st.pool = traffic_mod.make_pool(cell.traffic, cfg, seed, device)
    st.device = torch.device(device)
    st.logits, st.kv = [], None
    for i in range(WARMUP):
        step(st, i, span)
    st.logits, st.kv = [], None
    return st


def step(st, i: int, span) -> dict:
    slot = i % len(st.pool)
    tokens = st.pool[slot]["tokens"]
    st.kv = None                   # the previous call's latent may go
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


def program_routes(st, slot: int):
    """One more `Model.prefill` of pool batch ``slot``, after the window:
    its last-position logits and each MoE layer's expert choices (B*S,
    k), in layer order, as `repro_torch.nn.mlp.moe_select` returned
    them."""
    from repro_torch.nn import mlp
    select, routes = mlp.moe_select, []

    def record(tokens, p, cfg):
        w, idx = select(tokens, p, cfg)
        routes.append(idx)
        return w, idx

    mlp.moe_select = record
    try:
        with torch.inference_mode():
            logits, _ = st.model.prefill(
                st.params, {"tokens": st.pool[slot]["tokens"]})
    finally:
        mlp.moe_select = select
    return logits.clone(), routes


def outputs(st):
    slot = st.kv[0]
    return {"logits": st.logits, "kv": st.kv,
            "pinned": (slot, *program_routes(st, slot))}


def reference_logits(cell, seed: int, device, a_bits: int,
                     on_latent=None, on_route=None, slots=None) -> list:
    """The reference's last-position logits (float32) of the pool batches
    ``slots`` (default: every one), from the same per-layer float weights
    as the program's; the hooks are the reference's, with the batches
    numbered in that list."""
    cfg = cell.config
    pool = traffic_mod.make_pool(cell.traffic, cfg, seed, device)
    slots = range(len(pool)) if slots is None else slots
    return cell.reference.logits(
        cfg, top_fp(cfg, seed, device),
        lambda i: layer_fp(cfg, seed, i, device),
        [pool[s]["tokens"] for s in slots], a_bits, on_latent=on_latent,
        on_route=on_route)


def _gaps(got, want):
    """(root-mean-square gap over the reference's root-mean-square,
    largest |gap| over the largest |value|), float32."""
    d = got.to(torch.float32) - want.to(torch.float32)
    w = want.to(torch.float32)
    return float(d.norm() / w.norm()), float(d.abs().max() / w.abs().max())


def compare(cell, seed: int, device, outs, a_bits: int) -> dict:
    """Gaps against the reference: of every call's logits (over the
    vocabulary, the call's rows together), and of the last call's latent
    (c_kv, k_pe) per layer and tensor, the largest over calls and layers;
    and of the ``pinned`` call's logits against the reference given that
    call's expert choices in every MoE layer (``pinned_logits_*``), which
    sees the held experts' arithmetic without the routing flips.

    The limited ones are root-mean-square: a routing choice at a near-tie
    that the program and the reference take apart (a one-rounding
    difference upstream is enough) moves that token by a whole expert's
    output from then on, and the number of such tokens grows layer by
    layer (PERF.md), so the largest single gap (``*_max_rel_err``,
    reported beside them) reads those tokens and not the arithmetic."""
    vocab = cell.config["vocab_size"]
    kv_slot, (c_all, p_all) = outs["kv"]
    kv = [0.0, 0.0]

    def on_latent(i, slot, c, p):
        if slot != kv_slot:
            return
        for got, want in ((c_all[i], c), (p_all[i], p)):
            kv[:] = [max(a, b) for a, b in zip(kv, _gaps(got, want))]

    ref = reference_logits(cell, seed, device, a_bits, on_latent)
    lg = [0.0, 0.0]
    for slot, out in outs["logits"]:
        got = out.reshape(out.shape[0], -1)[:, :vocab]
        lg = [max(a, b) for a, b in zip(lg, _gaps(
            got, ref[slot].to(got.device)))]
    del ref
    slot, out, routes = outs["pinned"]
    n_dense = cell.config["first_k_dense_replace"]
    (want,) = reference_logits(
        cell, seed, device, a_bits, slots=[slot],
        on_route=lambda i, _, e: routes[i - n_dense])
    got = out.reshape(out.shape[0], -1)[:, :vocab]
    pinned = _gaps(got, want.to(got.device))
    return {"logits_rms_rel_err": lg[0], "kv_rms_rel_err": kv[0],
            "pinned_logits_rms_rel_err": pinned[0],
            "logits_max_rel_err": lg[1], "kv_max_rel_err": kv[1],
            "pinned_logits_max_rel_err": pinned[1],
            "calls_compared": len(outs["logits"])}


def check(cell, seed: int, device, outs) -> dict:
    return compare(cell, seed, device, outs, cell.config["a_bits"])


def control_outputs(cell, seed: int, device) -> dict:
    """The control: the reference in the program's place, every dense
    layer's activations at the control's lower precision; one call per
    pool batch, the last one's latent and expert choices kept."""
    cfg = cell.config
    low = cfg["control"]["a_bits"]
    last = int(cell.traffic["pool"]) - 1
    cs, ps, routes = [], [], []

    def keep(i, slot, c, p):
        if slot == last:
            cs.append(c)
            ps.append(p)

    def keep_route(i, slot, e):
        if slot == last:
            routes.append(e)

    ref = reference_logits(cell, seed, device, low, keep, keep_route)
    return {"logits": list(enumerate(ref)),
            "kv": (last, (torch.stack(cs), torch.stack(ps))),
            "pinned": (last, ref[last], routes)}
