"""The startup self-benchmark (`lwdetr_tpu_torch/utils/benchmark.py`) against
the JAX package's (`lwdetr_tpu/utils/benchmark.py`, `utils/hlo_report.py`).

* The parameter count of every preset and of the PResNet encoder equals the
  JAX package's (the leaves of its `params`, from `jax.eval_shape`), and
  small's is `chip_smoke.SMALL_PARAMETERS`, which the card's run asserts.
* Small's GEMM and convolution FLOPs of one eval forward equal the JAX
  report's dot and convolution FLOPs outside attention and sampling. The JAX
  side: its HLO is lowered (not compiled) and read by
  `hlo_report.parse_hlo_flops`; on the CPU its attention (SDPA: QK^T, PV) and
  its samplers (the bilinear corners' 'bhqp,bhqpd->bhqd' einsums) are the
  HLO's only batched dots, and those are dropped (the test checks each one's
  module path). Its convolutions are counted by PyTorch's rule, every kernel
  tap at every output position (`hlo_report` counts only the taps that land
  inside the input). The port's side: attention and sampling are operators
  of their own (`torch.ops.lwdetr.*`), in classes of their own, so its GEMM
  and convolution classes hold neither.
* The operators' FLOPs equal the analytic count of their launches.
"""
import dataclasses
import re
from unittest import mock

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from lwdetr_tpu.config import get_config as jax_get_config
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu.utils import hlo_report
from lwdetr_tpu_torch.config import ModelConfig, get_config
from lwdetr_tpu_torch.models.lwdetr import LWDETR, build_model
from lwdetr_tpu_torch.utils import benchmark as bm

PRESETS = ("tiny", "small", "medium", "large", "xlarge")
SIZE = 320  # small's eval forward at a reduced input: 20 x 20 tokens, 400 proposals

NANO = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
    out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64, dim_feedforward=128,
    sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2, group_detr=3, num_queries=16,
    num_classes=7, two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two PyTorch threads for this file's forwards: the suite's workers share
    the machine's cores, and the bench's many small operations contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_variables(jm, size=SIZE):
    """The JAX model and its variables' shapes, initialised in train mode as
    the JAX CLI does (every query group's two-stage heads)."""
    model = jax_build_model(jm)
    return model, jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, size, size, 3), jnp.float32), train=True))


@pytest.mark.parametrize("name", PRESETS + ("res50vd",))
def test_the_parameter_count_equals_the_jax_packages(name):
    overrides = {"encoder": "res50vd"} if name == "res50vd" else {}
    preset = "small" if name == "res50vd" else name
    cfg = get_config(preset, **overrides)
    jm = dataclasses.replace(jax_get_config(preset).model, **overrides)
    _, variables = _jax_variables(jm)
    ref = sum(leaf.size for leaf in jax.tree.leaves(variables["params"]))
    with torch.device("meta"):
        assert bm.count_parameters(LWDETR(cfg)) == ref
    if name == "small":
        assert ref == chip_smoke.SMALL_PARAMETERS


def _dense_taps(O, S, I, stride, pad_lo, lhs_dilate, rhs_dilate):
    """PyTorch's convolution count: every tap at every output position."""
    return O * S


def test_small_gemm_and_convolution_flops_equal_the_jax_report():
    jmodel, variables = _jax_variables(jax_get_config("small").model)
    images = jax.ShapeDtypeStruct((1, SIZE, SIZE, 3), jnp.float32)
    lowered = jax.jit(lambda v, x: jmodel.apply(v, x, train=False)).lower(variables, images)
    text = lowered.compiler_ir("hlo").as_hlo_module().to_string(
        jax._src.lib.xla_client._xla.HloPrintOptions())
    batched = [ln for ln in text.splitlines() if " dot(" in ln and "lhs_batch_dims" in ln]
    paths = [re.search(r'op_name="[^"]*?LWDETR/([^"]*)"', ln).group(1) for ln in batched]
    cfg = get_config("small")
    attention = [p for p in paths if re.search(r"/(attn|self_attn)/(bnhd,bmhd->bhnm|"
                                              r"bhnm,bmhd->bnhd)/", p)]
    sampling = [p for p in paths if "/cross_attn/bhqp,bhqpd->bhqd/" in p]
    assert len(attention) == 2 * (cfg.vit_encoder_num_layers + cfg.dec_layers)
    assert len(sampling) == 4 * cfg.dec_layers and len(paths) == len(attention) + len(sampling)
    kept = "\n".join(ln for ln in text.splitlines() if ln not in set(batched))
    with mock.patch.object(hlo_report, "_conv_taps", _dense_taps):
        ref = hlo_report.parse_hlo_flops(kept)["flops_by_op"]

    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        report = bm.detailed_flops(lambda: model(torch.zeros(1, SIZE, SIZE, 3)), "LWDETR")
    got = report["flops_by_class"]
    assert got["gemm"] == pytest.approx(ref["dot"], rel=0.01)
    assert got["convolution"] == pytest.approx(ref["convolution"], rel=0.01)
    assert set(got) == {"gemm", "convolution", "attention", "deformable_sampling"}
    stages = report["flops_by_stage"]
    assert sum(sum(v.values()) for v in stages.values()) == report["total"]
    assert stages["backbone/projector"] == {"convolution": got["convolution"]}


def test_the_operators_flops_are_their_launches_analytic_count():
    """NANO at 128, a train-mode model (the bench freezes it and puts it back):
    the window block's attention with a bias (K1, 16 windows of 4 tokens), the
    global block's (K1: 64 tokens), the decoder's self-attention without a
    bias (K9, 16 queries) and its sampler (K3), each counted as 4 B N^2 C or
    8 x out x levels x points."""
    model = build_model(NANO, device="cpu", train=True)
    stats = bm.benchmark_model(model, image_size=128, batch=1, logger=lambda s: None)
    ops = stats["detailed_flops"]["flops_by_op"]
    C, Q = 192, NANO.num_queries
    assert ops["window_attention_bias"] == 4 * 16 * 4 ** 2 * C + 4 * 1 * 64 ** 2 * C
    assert ops["window_attention"] == NANO.dec_layers * 4 * 1 * Q ** 2 * NANO.hidden_dim
    assert ops["ms_deform_attn_cm"] == NANO.dec_layers * 8 * Q * NANO.hidden_dim * 1 * 2
    assert stats["n_parameters"] == bm.count_parameters(model)
    assert stats["fps"] == pytest.approx(1000 / stats["median_ms"])
    assert stats["median_ms"] <= stats["p95_ms"]
    assert stats["gflops"] == pytest.approx(sum(stats["gflops_by_class"].values()))
    assert model.training and all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("dont_bench", [False, True])
def test_the_cli_benches_on_rank_0_unless_dont_bench(dont_bench, monkeypatch):
    from lwdetr_tpu_torch import main as cli

    calls = []
    monkeypatch.setattr(bm, "benchmark_model", lambda model, **kw: calls.append(kw))
    args = cli.parser().parse_args(["--device", "cpu", *chip_smoke.MICRO_FLAGS]
                                   + (["--dont_bench"] if dont_bench else []))
    cli._startup_bench(args, object())
    assert calls == ([] if dont_bench else [{"image_size": 640, "batch": 1}])
