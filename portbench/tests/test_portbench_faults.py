"""A whole run at smoke size on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: each fault the cells
can have turns ``correct`` false. One card each, so no exchange between
chips can be left out."""
import time

import pytest
import torch

import smoke
from portbench.harness import runner, spec


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("root"))


def _run(root, cell):
    c = spec.resolve(root, cell)
    return runner.run(c, 2**31 + 77, 0.3, False, "cpu", time.perf_counter())


def _vision_half(orig):
    def f(qnet, x, **kw):
        y = orig(qnet, x[: (x.shape[0] + 1) // 2], **kw)
        return torch.cat([y, y])[: x.shape[0]]
    return f


def _vision_altered(orig):
    def f(qnet, x, **kw):
        y = orig(qnet, x, **kw).clone()
        y[0, 0] += 1
        return y
    return f


def _lm_half(orig):
    """Half of the batch left out: its rows filled from the other half."""
    def f(self, params, batch):
        t = batch["tokens"]
        n = t.shape[0]
        lg, (k, v) = orig(self, params, {"tokens": t[: (n + 1) // 2]})
        return (torch.cat([lg, lg])[:n],
                (torch.cat([k, k], 1)[:, :n], torch.cat([v, v], 1)[:, :n]))
    return f


def _lm_altered(orig):
    def f(self, params, batch):
        lg, kv = orig(self, params, batch)
        lg = lg.clone()
        lg[0, 0, 0] += 1.0
        return lg, kv
    return f


def _lm_state_unchanged(orig):
    def f(self, params, batch):
        lg, (k, v) = orig(self, params, batch)
        return lg, (torch.zeros_like(k), torch.zeros_like(v))
    return f


def test_sound_runs_are_correct(root):
    for cell in (smoke.VISION, smoke.LM):
        res = _run(root, cell)
        assert res["correct"] is True, res["checks"]
        assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [_vision_half, _vision_altered])
def test_vision_faults_fail(root, monkeypatch, fault):
    from repro_torch.vision import models
    monkeypatch.setattr(models, "forward_int", fault(models.forward_int))
    res = _run(root, smoke.VISION)
    assert res["correct"] is False
    assert res["checks"]["logit_mismatches"]["value"] > 0


@pytest.mark.parametrize("fault", [_lm_half, _lm_altered,
                                   _lm_state_unchanged])
def test_lm_faults_fail(root, monkeypatch, fault):
    from repro_torch.models.api import Model
    monkeypatch.setattr(Model, "prefill", fault(Model.prefill))
    res = _run(root, smoke.LM)
    assert res["correct"] is False, res["checks"]
