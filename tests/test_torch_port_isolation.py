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

KERNELS = (tfa.window_attention_bias_kernel, tfa.flash_attention_cm_kernel,
           tda.deform_attn_cm_kernel, tda.deform_attn_sep_kernel,
           tda.deform_attn_sep_bwd_kernel, tfa.flash_attention_cm_bwd_kernel,
           tfa.window_attention_bias_bwd_kernel, tfa.window_attention_bwd_kernel,
           tda.deform_attn_cm_bwd_kernel, tfa.window_attention_kernel,
           tda.deform_attn_rowmajor_kernel, tda.deform_attn_rowmajor_bwd_kernel)
TINY = ModelConfig(vit_encoder_num_layers=1, out_feature_indexes=(0,), hidden_dim=32,
                   dim_feedforward=32, sa_nheads=2, ca_nheads=2, dec_layers=1,
                   num_queries=4, group_detr=1, num_classes=3, two_stage=True,
                   bbox_reparam=True, lite_refpoint_refine=True)
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


@pytest.mark.parametrize("path", [p for p in PORT_FILES if p.name != "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_catches_no_exception(path):
    """No `except` anywhere in the package: a kernel that fails to build or to
    launch raises, and nothing falls back to another path."""
    handlers = [n.lineno for n in ast.walk(ast.parse(path.read_text(), filename=str(path)))
                if isinstance(n, ast.ExceptHandler)]
    assert not handlers, f"{path.name} catches exceptions at lines {handlers}"


def test_the_train_modules_are_in_the_walk():
    names = {str(p.relative_to(ROOT / "lwdetr_tpu_torch")) for p in PORT_FILES[:-1]}
    assert {"models/matcher.py", "models/criterion.py", "train/optim.py", "train/engine.py",
            "bench_train.py", "config.py", "models/transformer.py", "ops/deform_attn.py",
            "ops/flash_attention.py", "ops/_build.py", "bench.py", "breakdown.py"} <= names


def test_train_entry_points_raise_without_a_card(monkeypatch):
    from lwdetr_tpu_torch import bench_train
    from lwdetr_tpu_torch.config import TrainConfig
    from lwdetr_tpu_torch.train import engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.create_train_state(TINY, TrainConfig(), niter_per_ep=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_train.make_train_step("small", 1)
    state = engine.create_train_state(TINY, TrainConfig(use_ema=True), niter_per_ep=10,
                                      device="cpu")
    assert state.model.training and state.ema is not None and state.step == 0
    assert next(state.model.parameters()).device.type == "cpu"


def test_build_model_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TINY
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_model.build_model(cfg)
    assert port_model.build_model(cfg, device="cpu").class_embed.weight.device.type == "cpu"


def test_cpu_tensors_take_the_plain_versions_without_building_kernels():
    kernels = KERNELS
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
    tda.ms_deform_attn(torch.randn(1, 12, 2, 16, generator=g), [(3, 4)],
                       torch.rand(1, 5, 2, 1, 2, 2, generator=g),
                       torch.rand(1, 5, 2, 1, 2, generator=g))
    # and the backwards: autograd through each Function on CPU tensors (20
    # tokens take the short attention, 200 the long one)
    qkv.requires_grad_()
    long_qkv = torch.randn(1, 3 * 32, 200, generator=g, requires_grad=True)
    bias = torch.randn(96, generator=g, requires_grad=True)
    (tfa.attention_cm(qkv, 2, bias=bias).sum() + tfa.attention_cm(qkv, 2).sum()
     + tfa.attention_cm(long_qkv, 2).sum()).backward()
    panel = torch.randn(1, 2, 3, 4 * 16, generator=g, requires_grad=True)
    tda.ms_deform_attn_sep_panels([panel], [(3, 4)], torch.rand(1, 5, 2, 1, 2, 2, generator=g),
                                  torch.rand(1, 5, 2, 1, 2, generator=g)).sum().backward()
    value_t = torch.randn(1, 32, 12, generator=g, requires_grad=True)
    tda.ms_deform_attn_cm(value_t, [(3, 4)], torch.rand(1, 5, 2, 1, 2, 2, generator=g),
                          torch.rand(1, 5, 2, 1, 2, generator=g), 2).sum().backward()
    value = torch.randn(1, 12, 2, 16, generator=g, requires_grad=True)
    tda.ms_deform_attn(value, [(3, 4)], torch.rand(1, 5, 2, 1, 2, 2, generator=g),
                       torch.rand(1, 5, 2, 1, 2, generator=g)).sum().backward()
    assert all(t.grad is not None for t in (qkv, long_qkv, bias, panel, value_t, value))
    assert [k.launches for k in kernels] == before
    assert all(k._fn is None for k in kernels)


def test_every_kernel_source_is_registered_for_the_parallel_build():
    assert set(_build.SOURCES) == {p.name for p in _build.CSRC.glob("*.cu")}
    assert {k.source for k in KERNELS} == set(_build.SOURCES)
    assert [k.name for k in KERNELS] == ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K7nb", "K8",
                                         "K9", "K10", "K10b"]
    assert len({k.symbol for k in KERNELS}) == len(KERNELS)  # an entry symbol and a count each
    assert set(_build.HEADERS) == {p.name for p in _build.CSRC.glob("*.cuh")}


def test_kernel_build_targets_hopper_from_the_checkout():
    for src in _build.SOURCES:
        assert (_build.CSRC / src).is_file()
        out = _build.library_path(src)
        assert out.parent == ROOT / "build" / "lwdetr_tpu_torch"
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags


def test_chip_smoke_names_every_kernel_and_tinys_launches():
    import chip_smoke

    names = [k.name for k in KERNELS]
    assert list(chip_smoke.KERNEL_NAMES) == names
    assert set(chip_smoke.SOURCES) == set(chip_smoke.REPLACES) == set(names)
    assert {f"lwdetr_tpu_torch/csrc/{k.source}" for k in KERNELS} == set(chip_smoke.SOURCES.values())
    assert all(chip_smoke.SOURCES[k.name].endswith(k.source) for k in KERNELS)
    used = lambda counts: {n: c for n, c in counts.items() if c}  # noqa: E731
    assert used(chip_smoke.EXPECTED_LAUNCHES["tiny"]) == {"K1": 3, "K2": 3, "K9": 3, "K3": 3}
    tiny = dict(K1=3, K2=3, K9=3, K6=3, K7=3, K7nb=3)
    assert used(chip_smoke.TRAIN_LAUNCHES["tiny"]) == dict(tiny, K4=3, K5=3)
    assert used(chip_smoke.TRAIN_LAUNCHES["tiny/cm"]) == dict(tiny, K3=3, K8=3)
    assert used(chip_smoke.TRAIN_LAUNCHES["tiny/gather"]) == dict(tiny, K10=3, K10b=3)
    assert used(chip_smoke.TRAIN_LAUNCHES["small"]) == dict(K1=6, K2=7, K4=3, K5=3, K6=7, K7=6)
    # every REPLACES entry names a line of the JAX package that defines that function
    for name, where in {**chip_smoke.REPLACES, **{k + "+": v for k, v in
                                                  chip_smoke.ALSO_REPLACES.items()}}.items():
        path, fn = where.split(" ")
        file, line = path.split(":")
        assert (ROOT / file).read_text().splitlines()[int(line) - 1].startswith(f"def {fn}("), name


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
