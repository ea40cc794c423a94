"""The PyTorch port stands alone: no JAX, no JAX package, no silent CPU fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lwdetr_tpu_torch.config import ModelConfig
from lwdetr_tpu_torch.models import lwdetr as port_model
from lwdetr_tpu_torch.ops import _build
from lwdetr_tpu_torch.ops import deform_attn as tda
from lwdetr_tpu_torch.ops import flash_attention as tfa

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "lwdetr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "lwdetr_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_build_model_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(vit_encoder_num_layers=1, out_feature_indexes=(0,), hidden_dim=32,
                      dim_feedforward=32, sa_nheads=2, ca_nheads=2, dec_layers=1,
                      num_queries=4, group_detr=1, num_classes=3, two_stage=True,
                      bbox_reparam=True, lite_refpoint_refine=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_model.build_model(cfg)
    assert port_model.build_model(cfg, device="cpu").class_embed.weight.device.type == "cpu"


def test_cpu_tensors_take_the_plain_versions_without_building_kernels():
    kernels = (tfa.window_attention_bias_kernel, tfa.flash_attention_cm_kernel,
               tda.deform_attn_cm_kernel, tda.deform_attn_sep_kernel)
    before = [k.launches for k in kernels]
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(1, 3 * 32, 20, generator=g)
    tfa.attention_cm(qkv, 2, bias=torch.randn(96, generator=g))
    tfa.attention_cm(qkv, 2)
    tda.ms_deform_attn_cm(torch.randn(1, 32, 12, generator=g), [(3, 4)],
                          torch.rand(1, 5, 2, 1, 2, 2, generator=g),
                          torch.rand(1, 5, 2, 1, 2, generator=g), 2)
    tda.ms_deform_attn_sep_panels([torch.randn(1, 2, 3, 4 * 16, generator=g)], [(3, 4)],
                                  torch.rand(1, 5, 2, 1, 2, 2, generator=g),
                                  torch.rand(1, 5, 2, 1, 2, generator=g))
    assert [k.launches for k in kernels] == before
    assert all(k._fn is None for k in kernels)


def test_every_kernel_source_is_registered_for_the_parallel_build():
    assert set(_build.SOURCES) == {p.name for p in _build.CSRC.glob("*.cu")}
    bound = {k.source for k in (tfa.window_attention_bias_kernel, tfa.flash_attention_cm_kernel,
                                tda.deform_attn_cm_kernel, tda.deform_attn_sep_kernel)}
    assert bound == set(_build.SOURCES)


def test_kernel_build_targets_hopper_from_the_checkout():
    for src in _build.SOURCES:
        assert (_build.CSRC / src).is_file()
        out = _build.library_path(src)
        assert out.parent == ROOT / "build" / "lwdetr_tpu_torch"
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags


def _run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
