"""The trace reading on a made-up timeline: three steps of 100 us, each
quantize [0, 10), forward [10, 60), readback [60, 90), then 10 us
between steps."""
import pytest

from portbench.harness import trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _timeline(drop_last=False):
    evs = []
    for i, t in enumerate((0.0, 100.0, 200.0)):
        evs += [_ev("user_annotation", "step", t, 90),
                _ev("user_annotation", "wave.quantize", t, 10),
                _ev("user_annotation", "wave.forward", t + 10, 50),
                _ev("user_annotation", "wave.readback", t + 60, 30),
                _ev("gpu_user_annotation", "wave.forward", t + 10, 50),
                _ev("cpu_op", "aten::add", t + 10, 5),
                _ev("kernel", "void qconv_kernel<1>(ConvArgs)", t + 12, 20)]
        if not (drop_last and i == 2):
            evs.append(_ev("kernel", "void qconv_kernel<2>(ConvArgs)",
                           t + 30, 20))
        evs += [_ev("kernel", "elementwise", t + 40, 20),   # overlaps
                _ev("gpu_memcpy", "Memcpy DtoH", t + 62, 8)]
    return trace.parse(evs)


def test_busy_is_the_union_in_the_window():
    tr = _timeline()
    assert tr.window == (0.0, 290.0)
    # per step [12, 60) and [62, 70): 56 us
    assert tr.busy_s == pytest.approx(3 * 56e-6)
    assert tr.window_s == pytest.approx(290e-6)


def test_idle_gaps_split_over_host_spans():
    gaps = dict(_timeline().idle_gaps())
    assert gaps["wave.quantize"] == pytest.approx(30e-6)
    assert gaps["wave.forward"] == pytest.approx(6e-6)
    assert gaps["wave.readback"] == pytest.approx(66e-6)
    assert gaps["between steps"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(290e-6 - 3 * 56e-6)


def test_steps_that_lost_a_record_are_left_out():
    n, secs, usual = trace.matching_steps(_timeline(drop_last=True),
                                          ("qconv_kernel",))
    assert (n, usual) == (2, 2) and secs == pytest.approx(80e-6)
    assert trace.matching_steps(_timeline(), ("nothing",)) == (0, 0.0, 0)


def test_top_device_ops():
    ops = dict(_timeline().device_ops())
    assert ops["elementwise"] == pytest.approx(60e-6)
    assert ops["Memcpy DtoH"] == pytest.approx(24e-6)
    assert "wave.forward" not in ops and "aten::add" not in ops
