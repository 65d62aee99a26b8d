"""The port stands alone: no jax, no repro, no quiet CPU fallback."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.qconv.kernel import KERNEL as QCONV
from repro_torch.kernels.qmatmul.kernel import KERNEL as QMATMUL
from repro_torch.kernels.qmatmul.kernel import \
    SEGMENTED_KERNEL as QMATMUL_SEGMENTED

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "tools" / "gemm_ab.py",
           ROOT / "tools" / "profiler_check.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES + SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_port_covers_the_lm_modules_and_configs():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES}
    assert {"configs/base.py", "configs/qwen2p5_3b.py", "models/lm.py",
            "models/api.py", "nn/attention.py", "nn/mlp.py",
            "nn/module.py", "deploy/apply.py", "launch/convert.py",
            "launch/serve.py", "configs/mamba2_370m.py",
            "configs/recurrentgemma_9b.py", "nn/ssm.py", "nn/rglru.py",
            "models/mamba.py", "models/griffin.py", "models/encdec.py",
            "configs/seamless_m4t_large_v2.py",
            "configs/llama3p2_vision_90b.py", "configs/kimi_k2_1t.py",
            "configs/llama4_maverick_400b.py", "core/calibration.py",
            "core/quantize.py", "ckpt/checkpoint.py",
            "launch/deploy.py"} <= names


def test_port_covers_the_parallel_modules():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES}
    assert {"parallel/mesh.py", "parallel/sharding.py", "parallel/ctx.py",
            "parallel/ring.py", "parallel/pipeline.py",
            "launch/mesh.py"} <= names


def test_port_covers_the_training_modules():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES}
    assert {"qat/fakequant.py", "qat/data.py", "qat/train.py",
            "qat/evaluate.py", "train/optimizer.py", "train/compress.py",
            "train/step.py", "runtime/trainer.py", "data/pipeline.py",
            "launch/qat.py", "launch/train.py"} <= names
    code = ("import sys, repro_torch.qat, repro_torch.launch.qat, "
            "repro_torch.launch.train, repro_torch.train.step, "
            "repro_torch.runtime.trainer, repro_torch.data.pipeline; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_port_covers_the_launch_modules():
    """With the dry run the port mirrors every module of the reference's
    ``launch/`` but the XLA walkers, whose counterpart is
    ``launch/costs.py`` (docs/port_map.md)."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES}
    ref = {p.name for p in (ROOT / "src" / "repro" / "launch").glob("*.py")}
    mine = {n.split("/")[1] for n in names if n.startswith("launch/")}
    assert ref - mine == {"hlo_costs.py", "hlo_analysis.py"}
    assert {"launch/dryrun.py", "launch/report.py", "launch/breakdown.py",
            "launch/costs.py", "obs/accounting.py"} <= names
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.report, repro_torch.launch.breakdown; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.launch.vision, "
            "repro_torch.convert, repro_torch.serve.engine, "
            "repro_torch.deploy.planner, repro_torch.deploy.calibrate, "
            "repro_torch.launch.serve, repro_torch.launch.convert, "
            "repro_torch.deploy.apply, repro_torch.models.api as api, "
            "repro_torch.models.mamba, repro_torch.models.griffin, "
            "repro_torch.models.encdec, "
            "repro_torch.nn.ssm, repro_torch.nn.rglru, "
            "repro_torch.ckpt.checkpoint, repro_torch.launch.deploy; "
            "api.list_archs(); "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch import convert
    from repro_torch.launch import vision as launch
    from repro_torch.serve.engine import VisionEngine
    from repro_torch.vision import models
    from repro_torch.vision.configs import get_vision_config

    cfg = get_vision_config("resnet8", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init_fp(cfg, 0)
    fp = models.init_fp(cfg, 0, device="cpu")
    absmax = {k: 1.0 for k in ["__input__"] + [L.path for L in cfg.layers]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.quantize_net(cfg, fp, absmax)
    qnet = models.quantize_net(cfg, fp, absmax, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VisionEngine(qnet, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--net", "resnet8", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.fp_params_from_numpy({"w": np.zeros(3, np.float32)})
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.serve.engine import Engine
    model = api.build(api.get_smoke_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, model.init(0, device="cpu"), 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2.5-3b", "--smoke"])
    from repro_torch.launch import deploy
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deploy.main(["--arch", "qwen2.5-3b", "--smoke"])


def test_engine_refuses_a_net_on_another_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    from repro_torch.serve.engine import VisionEngine
    from repro_torch.vision import models
    from repro_torch.vision.configs import get_vision_config

    cfg = get_vision_config("resnet8", smoke=True)
    absmax = {k: 1.0 for k in ["__input__"] + [L.path for L in cfg.layers]}
    qnet = models.quantize_net(cfg, models.init_fp(cfg, 0, device="cpu"),
                               absmax, device="cpu")
    with pytest.raises(ValueError, match="lives on cpu"):
        VisionEngine(qnet, 4, device="cuda")


def test_kernels_build_lazily_from_the_repo_sources(monkeypatch, tmp_path):
    root = pathlib.Path(build.__file__).resolve().parents[3]
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    for k, src in ((QMATMUL, "qmatmul.cu"), (QCONV, "qconv.cu"),
                   (QMATMUL_SEGMENTED, "qmatmul_segmented.cu")):
        assert k.source == build.CSRC / src and k.source.exists()
        lib = k.library_path()
        assert lib.parent == root / "build" / "repro_torch_kernels"
        assert lib.name.startswith(f"lib{k.name}-")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert QMATMUL.library_path().parent == tmp_path
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
