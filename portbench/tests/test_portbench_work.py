"""The work arithmetic against the numbers worked by hand."""
import pytest

import smoke
from portbench.harness import peaks, work

H100 = peaks.peaks_for("NVIDIA H100 80GB HBM3")


def test_resnet8_macs_per_image():
    cfg = smoke.real_config("resnet8-w4a8")
    per = {tr["layer"]["path"]: work.layer_macs(tr)
           for tr in work.vision_layers(cfg)}
    assert per["stem"] == 442_368
    assert per["s1/c1"] == per["s1/c2"] == 2_359_296
    assert (per["s2/c1"], per["s2/c2"], per["s2/skip"]) == (
        1_179_648, 2_359_296, 131_072)
    assert (per["s3/c1"], per["s3/c2"], per["s3/skip"]) == (
        1_179_648, 2_359_296, 131_072)
    assert per["head"] == 640
    assert work.vision_macs_per_image(cfg) == 12_501_632


def test_resnet8_stem_bytes():
    cfg = smoke.real_config("resnet8-w4a8")
    stem = work.conv_work(cfg, 16384)[0]
    assert stem["bytes"] == (16384 * 32 * 32 * 3 + 27 * 16 // 2
                             + 12 * 16 + 16384 * 32 * 32 * 16)
    assert len(work.conv_work(cfg, 1)) == 9


def test_phi3_dense_and_attention():
    cfg = smoke.real_config("phi3-mini-3.8b-w4a8")
    assert work.lm_dense_macs_per_token(cfg) == 3_623_878_656
    dense_ms = 2 * 3_623_878_656 * 16384 / H100["int8_ops"] * 1e3
    assert dense_ms == pytest.approx(60.0, abs=0.05)
    # window 2047 over 2048 positions drops one pair per head and row
    assert work.attention_pairs(2048, 2047) == 2048 * 2049 // 2 - 1
    assert work.attention_pairs(2048) == 2048 * 2049 // 2
    fl = work.lm_attention_flops(cfg, 8, 2048)
    assert fl == 4 * (2048 * 2049 // 2 - 1) * 96 * 32 * 8 * 32
    assert fl / 1e12 == pytest.approx(6.6, abs=0.01)
    assert fl / H100["bf16_flops"] * 1e3 == pytest.approx(6.67, abs=0.01)


def test_phi3_q_gemm_is_compute_bound():
    cfg = smoke.real_config("phi3-mini-3.8b-w4a8")
    q = work.dense_gemm_work(cfg, 16384)[0]
    assert q["name"] == "wq"
    assert 2 * q["macs"] / H100["int8_ops"] * 1e3 == pytest.approx(
        0.156, abs=0.001)
    assert q["bytes"] / H100["hbm_bytes"] * 1e3 == pytest.approx(
        0.046, abs=0.001)


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError):
        peaks.peaks_for("NVIDIA A100-SXM4-40GB")
