"""Serving the recurrent families in the port (`Engine`, the
`LMDecodeAdapter`'s carried-state reset, `repro_torch.launch.serve`)
against the reference's `Engine`, on the CPU.

mamba-smoke and rgemma-smoke at W4A8 with bf16 compute, as the CLI
serves them, from the same numpy weights (the embedding table scaled by
0.1, so the layers and not the tied embedding decide the next token).
Tolerance: 0.1 on a logit, as `tests/test_torch_lm_serve.py` (bf16
rounding drifts through the layers). The port's greedy token must equal
the reference's at every step whose reference top-1 margin exceeds it,
until the first step where they may differ (mamba-smoke's rows are flat,
with a median top-1 margin near 0.09, so about half its requests may
part at their first token). Inside the port, with more
requests than slots (so slots are reused and their SSM / RG-LRU state
must be cleared), the wave and continuous policies must give identical
per-request outputs, equal to each request served alone.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.models import api as r_api
from repro.nn import layers as r_layers
from repro.serve import engine as r_engine
from repro_torch.convert import fp_params_from_numpy
from repro_torch.launch import convert as p_convert
from repro_torch.launch import serve as p_serve
from repro_torch.models import api as p_api
from repro_torch.nn import layers as p_layers
from repro_torch.serve import engine as p_engine
from repro_torch.serve.runtime.scheduler import Scheduler

from test_torch_lm_serve import QUANT, TOL, _generate, _prompts
from torch_bridge import fp_numpy, jax_tree

ARCHS = ["mamba2-370m", "recurrentgemma-9b"]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(reference model, params), (port model, params) at smoke W4A8:
    the port packs the numpy weights, the reference serves those bytes
    (the packers are held identical in tests/test_torch_griffin.py)."""
    base = p_api.get_smoke_config(request.param)
    fp = fp_numpy(p_api.build(base).defs())
    fp["embed"]["table"] *= 0.1
    pm = p_api.build(dataclasses.replace(
        base, quant=p_layers.QuantConfig(**QUANT)))
    pp = p_convert.convert_params(pm.init(0, device="cpu"),
                                  fp_params_from_numpy(fp, "cpu"), 4)
    rm = r_api.build(dataclasses.replace(
        r_api.get_smoke_config(request.param),
        quant=r_layers.QuantConfig(**QUANT)))
    return (rm, jax_tree(pp)), (pm, pp)


def test_engine_tokens_match_reference_engine(served):
    (rm, rp), (pm, pp) = served
    # 12 requests on 4 slots: three waves, the later two on reused slots
    prompts = _prompts(12)
    want, r_rows = _generate(r_engine.Engine(rm, rp, 4, 32),
                             r_engine.Request, prompts)
    got, p_rows = _generate(p_engine.Engine(pm, pp, 4, 32, device="cpu"),
                            p_engine.Request, prompts)
    vocab = rm.cfg.vocab
    compared = 0
    for w, g, rr, pr in zip(want, got, r_rows, p_rows):
        for k, (a, b) in enumerate(zip(w.tolist(), g.tolist())):
            np.testing.assert_allclose(pr[k][:vocab], rr[k][:vocab],
                                       atol=TOL)
            top2 = np.sort(rr[k][:vocab])[-2:]
            if top2[1] - top2[0] <= TOL:
                break               # a near tie: histories may part here
            assert a == b, (k, w, g)
            compared += 1
        else:
            assert len(g) == len(w)
    assert compared >= len(prompts) // 2


def test_slot_reuse_clears_carried_state(served):
    """7 requests on 3 slots (wave) or 2 (continuous): every logit row
    each request consumes, and so its tokens, is identical to those of
    the request served alone by a fresh one-slot engine. Without the
    adapter's ``reset_state`` a re-admitted slot starts from its last
    request's state (rows then differ by up to 0.2 for rgemma-smoke and 2
    for mamba-smoke)."""
    _, (pm, pp) = served
    prompts = _prompts(7, seed=1)
    max_new = [1, 5, 3, 8, 2, 6, 4]

    def serve(slots, policy, idx=range(7)):
        adapter = p_engine.Engine(pm, pp, slots, 24, device="cpu")._adapter
        rows = {}
        consume = adapter.consume

        def record(cur, row):
            rows.setdefault(cur.rid, []).append(np.array(row))
            return consume(cur, row)

        adapter.consume = record
        out = Scheduler(adapter, slots, policy=policy).serve([
            p_engine.Request(prompt=prompts[i], max_new_tokens=max_new[i])
            for i in idx])
        return [r.out.tolist() for r in out], [rows[r] for r in sorted(rows)]

    wave, wave_rows = serve(3, "wave")
    cont, cont_rows = serve(2, "continuous")
    for i in range(7):
        alone, alone_rows = serve(1, "wave", [i])
        assert wave[i] == cont[i] == alone[0], i
        assert len(wave[i]) == max_new[i]
        for a, b, c in zip(wave_rows[i], cont_rows[i], alone_rows[0],
                           strict=True):
            assert np.array_equal(a, c) and np.array_equal(b, c), i


def test_reset_state_zeroes_only_the_masked_slots(served):
    _, (pm, pp) = served
    adapter = p_engine.Engine(pm, pp, 3, 16, device="cpu")._adapter
    cache = adapter.init_state(3)
    for tree in cache.values():
        for leaf in tree.values():
            leaf.fill_(1)
    out = adapter.reset_state(cache, np.array([False, True, False]))
    assert out is cache
    for name, tree in cache.items():
        for leaf in tree.values():
            cleared = name in ("ssm", "rec")
            assert bool((leaf[:, 1] == 0).all()) == cleared, name
            assert bool((leaf[:, [0, 2]] == 1).all()), name


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    out = p_serve.main(["--arch", arch, "--smoke", "--quant", "w4a8",
                        "--device", "cpu", "--requests", "2", "--batch",
                        "2", "--max-new", "4"])
    text = capsys.readouterr().out
    name = p_api.get_smoke_config(arch).name
    assert f"{name} [w4a8] params" in text and "tok/s (CPU" in text
    assert [len(r.out) for r in out] == [4, 4]


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_the_card(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = p_api.build(p_api.get_smoke_config(arch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_engine.Engine(model, model.init(0, device="cpu"), 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_serve.main(["--arch", arch, "--smoke"])
