"""The two readers of device idle under the program's spans,
`forward_idle.vision` and `forward_idle.prefill`, on hand-built traces,
and their resolution from ``BENCHMARK.json``.

The vision timeline: two steps of 100 us at 0 and 100; in each,
``wave.forward`` [10, 80) holds ``vision/stem`` [10, 40) and
``vision/head`` [40, 70) back to back; the card runs [12, 30) and
[50, 60), then a readback copy [82, 90)."""
import pytest

import smoke
from portbench.harness import span_idle, spec, trace

VISION_CELL = "resnet8-w4a8.frames-16384"
LM_CELL = "phi3-mini-w4a8.prefill-8x2048"


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _vision(spans=True):
    evs = []
    for t in (0.0, 100.0):
        evs += [_ev("user_annotation", "step", t, 100),
                _ev("user_annotation", "wave.forward", t + 10, 70),
                _ev("user_annotation", "wave.readback", t + 80, 20),
                _ev("kernel", "qconv_kernel", t + 12, 18),
                _ev("kernel", "elementwise", t + 50, 10),
                _ev("gpu_memcpy", "Memcpy DtoH", t + 82, 8)]
        if spans:
            evs += [_ev("user_annotation", "vision/stem", t + 10, 30),
                    _ev("user_annotation", "vision/head", t + 40, 30)]
    return trace.parse(evs)


def _reader(name):
    return spec.load_module(smoke.BENCH / "metrics" / f"{name}.py")


def _read(name, tr):
    return _reader(name).read({"trace": tr})


def test_vision_reads_the_idle_inside_its_spans():
    # per step: [10, 70) less busy [12, 30) and [50, 60) = 32 us idle;
    # two steps over a 200 us window
    assert _read("forward_idle.vision", _vision()) \
        == pytest.approx(100.0 * 64 / 200)


def test_idle_outside_every_program_span_does_not_count():
    # [0, 10), [70, 82) and [90, 100) per step are idle too, under the
    # harness's spans or none: not the program's
    tr = _vision()
    assert tr.window_s - tr.busy_s == pytest.approx(2 * 64e-6)
    assert span_idle.idle_inside(tr, "vision/") == pytest.approx(64e-6)


def test_a_gap_across_two_adjacent_spans_counts_once():
    # the gap [30, 50) crosses stem's end and head's start: 20 us, once
    tr = trace.parse([
        _ev("user_annotation", "step", 0, 100),
        _ev("user_annotation", "lm/attn.core", 0, 40),
        _ev("user_annotation", "lm/attn.out", 40, 60),
        _ev("kernel", "a", 0, 30),
        _ev("kernel", "b", 50, 50)])
    assert span_idle.idle_inside(tr, "lm/") == pytest.approx(20e-6)
    assert _read("forward_idle.prefill", tr) == pytest.approx(20.0)


def test_overlapping_spans_count_their_union():
    tr = trace.parse([
        _ev("user_annotation", "step", 0, 100),
        _ev("user_annotation", "lm/embed", 0, 60),
        _ev("user_annotation", "lm/head", 40, 60),
        _ev("kernel", "a", 90, 10)])
    assert span_idle.idle_inside(tr, "lm/") == pytest.approx(90e-6)


@pytest.mark.parametrize("name", ["forward_idle.vision",
                                  "forward_idle.prefill"])
def test_no_span_of_the_prefix_leaves_the_metric_out(name):
    # a program that opens no span: no reading, not 0%
    assert _read(name, _vision(spans=False)) is None
    assert _read(name, None) is None


def test_no_device_record_leaves_the_metric_out():
    tr = trace.parse([_ev("user_annotation", "step", 0, 100),
                      _ev("user_annotation", "vision/stem", 0, 50)])
    assert _read("forward_idle.vision", tr) is None


@pytest.mark.parametrize("cell,name", [
    (VISION_CELL, "forward_idle.vision"),
    (LM_CELL, "forward_idle.prefill")])
def test_metrics_resolve_for_their_cells(cell, name):
    c = spec.resolve(smoke.ROOT, cell)
    m = {m.name: m for m in c.per_layer}[name]
    assert m.unit == "%" and m.better == "lower"
    assert m.source == "device_trace" and m.workloads == (cell,)
    assert callable(m.reader.read)
    other = VISION_CELL if cell == LM_CELL else LM_CELL
    assert name not in [m.name for m in spec.resolve(smoke.ROOT,
                                                      other).per_layer]
