"""The Kimi-K2 prefill cell and the short-prompt Phi-3 cell resolved by
name from ``BENCHMARK.json``: their end-to-end and per-layer metrics, in
the file's order, and the readers of idle that every prefill cell
shares."""
import pytest

import smoke
from portbench.harness import spec

KIMI = "kimi-k2-w4a8-ep8.prefill-8x2048"
SHORT = "phi3-mini-w4a8.prefill-64x256"
LM_CELLS = ("phi3-mini-w4a8.prefill-8x2048", KIMI, SHORT)


@pytest.mark.parametrize("cell,per", [
    (SHORT, ["mfu.prefill", "qmatmul_roofline.prefill",
             "idle_share.prefill", "forward_idle.prefill"]),
    (KIMI, ["idle_share.prefill", "forward_idle.prefill",
            "mfu.moe-prefill", "qmatmul_roofline.moe-prefill",
            "moe_idle.moe-prefill"]),
])
def test_cells_resolve_by_name(cell, per):
    c = spec.resolve(smoke.ROOT, cell)
    assert [m.name for m in c.end_to_end] == ["setup_s", "prefill_tok_s"]
    assert [m.name for m in c.per_layer] == per
    assert c.chips == 1 and "limits" in c.limits
    for name in ("setup", "step", "outputs", "check", "control_outputs"):
        assert callable(getattr(c.system, name))


@pytest.mark.parametrize("cell", LM_CELLS)
@pytest.mark.parametrize("name", ["idle_share.prefill",
                                  "forward_idle.prefill"])
def test_idle_readers_resolve_in_every_prefill_cell(cell, name):
    m = {m.name: m for m in spec.resolve(smoke.ROOT, cell).per_layer}[name]
    assert m.unit == "%" and m.better == "lower"
    assert m.source == "device_trace" and set(m.workloads) == set(LM_CELLS)
    assert callable(m.reader.read)


def test_the_mha_yardstick_stays_off_the_kimi_cell():
    # mfu.prefill and qmatmul_roofline.prefill count MHA / SwiGLU shapes
    names = [m.name for m in spec.resolve(smoke.ROOT, KIMI).per_layer]
    assert "mfu.prefill" not in names
    assert "qmatmul_roofline.prefill" not in names
