"""LM serving in the port (`repro_torch.serve.engine.Engine`, the
`LMDecodeAdapter`, `repro_torch.launch.serve`) against the reference's
`Engine`, on the CPU.

qwen smoke at W4A8 with bf16 compute, as the CLI serves it, from the same
numpy weights (the embedding table scaled by 0.1, so the layers and not
the tied embedding decide the next token). Tolerance: 0.1 on a logit
(rows of magnitude about 1.3; bf16 rounding drifts by up to 0.03 through
the two layers). The port's greedy token must equal the reference's at
every step whose reference top-1 margin exceeds it, until the first step
where they may differ; the logit rows must agree within it on the common
history. Inside the port the wave and continuous policies must give
identical per-request outputs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.models import api as r_api
from repro.nn import layers as r_layers
from repro.serve import engine as r_engine
from repro_torch.convert import fp_params_from_numpy
from repro_torch.deploy import policy as p_policy
from repro_torch.launch import convert as p_convert
from repro_torch.launch import serve as p_serve
from repro_torch.models import api as p_api
from repro_torch.nn import layers as p_layers
from repro_torch.serve import engine as p_engine
from repro_torch.serve.runtime.scheduler import Scheduler

from torch_bridge import fp_numpy, jax_tree

TOL = 0.1
QUANT = dict(mode="int", w_bits=4, a_bits=8)


@pytest.fixture(scope="module")
def served():
    """(reference model, params), (port model, params) at qwen smoke W4A8:
    the port packs the numpy weights, the reference serves those bytes
    (the packers are held identical in tests/test_torch_lm.py)."""
    base = p_api.get_smoke_config("qwen2.5-3b")
    fp = fp_numpy(p_api.build(base).defs())
    fp["embed"]["table"] *= 0.1
    pm = p_api.build(dataclasses.replace(
        base, quant=p_layers.QuantConfig(**QUANT)))
    pp = p_convert.convert_params(pm.init(0, device="cpu"),
                                  fp_params_from_numpy(fp, "cpu"), 4)
    rm = r_api.build(dataclasses.replace(
        r_api.get_smoke_config("qwen2.5-3b"),
        quant=r_layers.QuantConfig(**QUANT)))
    return (rm, jax_tree(pp)), (pm, pp)


def _prompts(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 128, size=int(rng.integers(2, 8))).astype(
        np.int32) for _ in range(n)]


def _generate(engine, request_cls, prompts, max_new=8):
    """Tokens per request and the logit row each one was sampled from."""
    rows = {}
    consume = engine._adapter.consume

    def record(cur, row):
        rows.setdefault(cur.rid, []).append(np.array(row, np.float32))
        return consume(cur, row)

    engine._adapter.consume = record
    out = engine.generate([request_cls(prompt=p, max_new_tokens=max_new)
                           for p in prompts])
    # the rows that sampled a token: the last prompt position onwards
    return ([r.out for r in out],
            [rows[i][len(p) - 1:] for i, p in enumerate(prompts)])


def test_engine_tokens_match_reference_engine(served):
    (rm, rp), (pm, pp) = served
    prompts = _prompts()
    want, r_rows = _generate(r_engine.Engine(rm, rp, 4, 32),
                             r_engine.Request, prompts)
    got, p_rows = _generate(p_engine.Engine(pm, pp, 4, 32, device="cpu"),
                            p_engine.Request, prompts)
    vocab = rm.cfg.vocab
    compared = 0
    for w, g, rr, pr in zip(want, got, r_rows, p_rows):
        assert len(g) == len(w)
        for k, (a, b) in enumerate(zip(w.tolist(), g.tolist())):
            np.testing.assert_allclose(pr[k][:vocab], rr[k][:vocab],
                                       atol=TOL)
            top2 = np.sort(rr[k][:vocab])[-2:]
            if top2[1] - top2[0] <= TOL:
                break               # a near tie: histories may part here
            assert a == b, (k, w, g)
            compared += 1
    assert compared >= len(prompts) * 4


def test_wave_and_continuous_policies_identical(served):
    _, (pm, pp) = served
    prompts = _prompts(7, seed=1)
    max_new = [1, 5, 3, 8, 2, 6, 4]

    def reqs():
        return [p_engine.Request(prompt=p, max_new_tokens=m)
                for p, m in zip(prompts, max_new)]

    wave = p_engine.Engine(pm, pp, 3, 24, device="cpu").generate(reqs())
    adapter = p_engine.Engine(pm, pp, 3, 24, device="cpu")._adapter
    cont = Scheduler(adapter, 2, policy="continuous").serve(reqs())
    for a, b, m in zip(wave, cont, max_new):
        assert a.out.tolist() == b.out.tolist()
        assert len(a.out) == m


def test_serve_cli_on_the_cpu(tmp_path, capsys):
    out = p_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--quant", "w4a8",
                        "--device", "cpu", "--requests", "2", "--batch",
                        "2", "--max-new", "4"])
    text = capsys.readouterr().out
    assert "qwen-smoke [w4a8] params" in text and "tok/s (CPU" in text
    assert [len(r.out) for r in out] == [4, 4]
    # a plan: wi as two channel runs (one launch of the mixed-operand
    # GEMM), the attention projections at W2, the rest at the default W8
    plan = p_policy.PrecisionPlan(rules=(
        p_policy.PlanRule("layers/mlp/wi", 4, segments=((0, 128, 4),)),
        p_policy.PlanRule("layers/attn/w*", 2)), default_w_bits=8)
    path = tmp_path / "plan.json"
    p_policy.save_plan(plan, path)
    out = p_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--plan",
                        str(path), "--device", "cpu", "--requests", "3",
                        "--batch", "2", "--max-new", "3", "--kv-bits", "8"])
    text = capsys.readouterr().out
    assert "w_bits=(2, 4, 8)" in text and "wave latency" in text
    assert [len(r.out) for r in out] == [3, 3, 3]


def test_engine_defaults_to_the_card(served, monkeypatch):
    _, (pm, pp) = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_engine.Engine(pm, pp, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_serve.main(["--arch", "qwen2.5-3b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.init(0)
