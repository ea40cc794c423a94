"""The port's measurement tools: how `breakdown.py` files device kernels
into groups, on kernel names the H100 profiler reports for the small@640
and large@640 steps, and which presets the tools take."""
import pytest

from lwdetr_tpu_torch import (bench, bench_attention, bench_deform, bench_train, bench_variants,
                              breakdown)
from lwdetr_tpu_torch.breakdown import _group


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::flash_attention_cm_kernel<__nv_bfloat16, 16>"
     "(__nv_bfloat16 const*, __nv_bfloat16*, int, int,", "K2 flash_attention_cm"),
    ("void (anonymous namespace)::window_attention_bias_kernel<float, 16>"
     "(float const*, float const*, float*, int, int, float)", "K1 window_attention_bias"),
    ("void (anonymous namespace)::deform_attn_cm_kernel<__nv_bfloat16>"
     "(__nv_bfloat16 const*, float const*, float const*, __nv_", "K3 deform_attn_cm"),
    ("void (anonymous namespace)::deform_attn_sep_kernel<__nv_bfloat16>"
     "(float const*, float const*, __nv_bfloat16*, int, int, int, int, (anonymous",
     "K4 deform_attn_sep"),
    ("void (anonymous namespace)::deform_attn_sep_kernel<float>"
     "(float const*, float const*, float*, int, int, int, int, (anonymous", "K4 deform_attn_sep"),
    ("void (anonymous namespace)::flash_attention_cm_kernel<__nv_bfloat16, 64>"
     "(__nv_bfloat16 const*, __nv_bfloat16*, int, int,", "K2 flash_attention_cm"),
    ("void (anonymous namespace)::window_attention_bias_kernel<__nv_bfloat16, 32>"
     "(__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, float)",
     "K1 window_attention_bias"),
    ("void (anonymous namespace)::deform_attn_sep_bwd_kernel<float>(float const*, float const*, "
     "float const*, float*, float*, int, int, int, int, (anonymous", "K5 deform_attn_sep_bwd"),
    ("void (anonymous namespace)::attention_bwd_dq_kernel<float, 16>(float const*, float const*, "
     "float const*, float const*, float*, float*, int, int, float)", "K6 flash_attention_cm_bwd"),
    ("void (anonymous namespace)::attention_bwd_dkdv_kernel<float, 32>(float const*, "
     "float const*, float const*, float const*, float*, int, int, float)",
     "K6 flash_attention_cm_bwd"),
    ("void (anonymous namespace)::window_attention_bias_bwd_kernel<float, 16>(float const*, "
     "float const*, float const*, float*, int, int, float)", "K7 window_attention_bias_bwd"),
    ("void (anonymous namespace)::window_attention_bias_kernel<float, 16, true>(float const*, "
     "float const*, float*, int, int, float)", "K1 window_attention_bias"),
    ("void (anonymous namespace)::window_attention_bias_kernel<__nv_bfloat16, 32, false>"
     "(__nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, float)",
     "K9 window_attention (no bias)"),
    ("void (anonymous namespace)::window_attention_bias_bwd_kernel<float, 16, true>(float const*, "
     "float const*, float const*, float*, int, int, float)", "K7 window_attention_bias_bwd"),
    ("void (anonymous namespace)::window_attention_bias_bwd_kernel<float, 32, false>(float const*, "
     "float const*, float const*, float*, int, int, float)", "K7 window_attention_bwd (no bias)"),
    ("void (anonymous namespace)::deform_attn_cm_bwd_kernel<float>(float const*, float const*, "
     "float const*, float const*, float*, float*, float*, int, int, int, int, int, (anonymous",
     "K8 deform_attn_cm_bwd"),
    ("void (anonymous namespace)::deform_attn_sep_kernel<float, lw::PanelLayout>(float const*, "
     "float const*, float*, int, int, int, int, (anonymous namespace)::Levels, unsigned long)",
     "K4 deform_attn_sep"),
    ("void (anonymous namespace)::deform_attn_sep_kernel<float, lw::RowMajorLayout>(float const*, "
     "float const*, float*, int, int, int, int, (anonymous namespace)::Levels, unsigned long)",
     "K10 deform_attn_rowmajor"),
    ("void (anonymous namespace)::deform_attn_sep_bwd_kernel<float, lw::PanelLayout>(float "
     "const*, float const*, float const*, float*, float*, int, int, int, int, (anonymous",
     "K5 deform_attn_sep_bwd"),
    ("void (anonymous namespace)::deform_attn_sep_bwd_kernel<float, lw::RowMajorLayout>(float "
     "const*, float const*, float const*, float*, float*, int, int, int, int, (anonymous",
     "K10 deform_attn_rowmajor_bwd"),
    # K5 / K10b with one launch a level: the level and the queries a CTA as arguments
    ("void (anonymous namespace)::deform_attn_sep_bwd_kernel<float, lw::PanelLayout>(float "
     "const*, float const*, float const*, float*, float*, int, int, int, int, int, (anonymous "
     "namespace)::Level, int)", "K5 deform_attn_sep_bwd"),
    ("void (anonymous namespace)::deform_attn_sep_bwd_kernel<__nv_bfloat16, lw::PanelLayout>("
     "float const*, float const*, __nv_bfloat16 const*, float*, float*, int, int, int, int, int",
     "K5 deform_attn_sep_bwd"),
    ("void (anonymous namespace)::deform_attn_sep_bwd_kernel<float, lw::RowMajorLayout>(float "
     "const*, float const*, float const*, float*, float*, int, int, int, int, int, (anonymous "
     "namespace)::Level, int)", "K10 deform_attn_rowmajor_bwd"),
    ("void (anonymous namespace)::deform_attn_sep_bwd_kernel<__nv_bfloat16, lw::RowMajorLayout>("
     "float const*, float const*, __nv_bfloat16 const*, float*, float*, int, int, int, int, int",
     "K10 deform_attn_rowmajor_bwd"),
    # K3 and K8 staged in shared memory or not, and K8's transposing pass
    ("void (anonymous namespace)::deform_attn_cm_kernel<__nv_bfloat16, true>(__nv_bfloat16 "
     "const*, float const*, float const*, __nv_bfloat16*, int, int, int, int, int, lw::CmLevels",
     "K3 deform_attn_cm"),
    ("void (anonymous namespace)::deform_attn_cm_bwd_kernel<float, false>(float const*, float "
     "const*, float const*, float const*, float*, float*, float*, int, int, int, int, int, int",
     "K8 deform_attn_cm_bwd"),
    ("void (anonymous namespace)::position_to_channel_major<__nv_bfloat16>(float const*, "
     "__nv_bfloat16*, int, int)", "K8 deform_attn_cm_bwd"),
    # the bf16 samplers that round as the TPU kernels, kernels of their own
    ("void (anonymous namespace)::deform_attn_sep_bf16_kernel<lw::PanelLayout, true>(float "
     "const*, float const*, __nv_bfloat16*, int, int, int, int, (anonymous namespace)::Levels",
     "K4 deform_attn_sep"),
    ("void (anonymous namespace)::deform_attn_sep_bf16_kernel<lw::RowMajorLayout, false>(float "
     "const*, float const*, __nv_bfloat16*, int, int, int, int, (anonymous namespace)::Levels",
     "K10 deform_attn_rowmajor"),
    ("void (anonymous namespace)::deform_attn_cm_kernel_bf16<true>(__nv_bfloat16 const*, float "
     "const*, float const*, __nv_bfloat16*, int, int, int, int, int, lw::CmLevels",
     "K3 deform_attn_cm"),
    ("void (anonymous namespace)::deform_attn_cm_bwd_kernel_bf16<false>(__nv_bfloat16 const*, "
     "float const*, float const*, __nv_bfloat16 const*, float*, float*, float*, int, int",
     "K8 deform_attn_cm_bwd"),
    # the bf16 tensor-core cases: <head_dim, copy width> and, for K1 / K9, the bias flag
    ("void (anonymous namespace)::flash_attention_cm_mma_kernel<16, 8>(__nv_bfloat16 const*, "
     "__nv_bfloat16*, float*, int, int, float)", "K2 flash_attention_cm"),
    ("void (anonymous namespace)::window_attention_mma_kernel<16, 4, true>(__nv_bfloat16 "
     "const*, float const*, __nv_bfloat16*, int, int, float)", "K1 window_attention_bias"),
    ("void (anonymous namespace)::window_attention_mma_kernel<32, 4, false>(__nv_bfloat16 "
     "const*, float const*, __nv_bfloat16*, int, int, float)", "K9 window_attention (no bias)"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
     "(anonymous namespace)::TensorListMetadata<4>, at::native::(anonymous namespace)::"
     "FusedAdamMathFunctor", "optimizer/EMA (foreach)"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128_64x3_tn_align2>",
     "gemm"),
    ("nvjet_tst_128x160_64x5_2x1_v_bz_coopA_bias_TNT", "gemm"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x128x8_stage3_warpsize1x4x1_ffma",
     "gemm"),
    ("void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, false, false, true>",
     "conv"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<c10::BFloat16, float, false>(int, float, c10::BFloa", "norm"),
    ("void cudnn::bn_fw_inf_1C11_kernel_NHWC<float, float, true, true>(float, float, "
     "cudnnTensorStruct, fl", "norm"),
    ("void at::native::batch_norm_transform_input_channels_last_kernel<c10::BFloat16, float, "
     "c10::BFloat16", "norm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32_"
     "warpgroupsize1x1", "conv"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize64x192x32_"
     "warpgroupsize1x1x1_", "conv"),
    ("void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>", "topk/sort"),
    ("(anonymous namespace)::assignment_kernel(float const*, bool const*, long*, int, int, int, "
     "int)", "M1 assignment"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::GeluCUDAKernelImpl"
     "(at::TensorIteratorBase&, at::native::Ge", "other elementwise/copy"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast"
     "<at::native::direct_copy_kernel_cuda(at::T", "other elementwise/copy"),
])
def test_breakdown_groups_kernel_names(name, group):
    assert _group(name) == group


TOOLS = [bench, breakdown, bench_train, bench_attention, bench_deform]
TOOL_IDS = ["bench", "breakdown", "bench_train", "bench_attention", "bench_deform"]


@pytest.mark.parametrize("tool", TOOLS, ids=TOOL_IDS)
@pytest.mark.parametrize("preset", ["tiny", "small", "medium", "large", "xlarge"])
def test_tools_take_every_vit_preset(tool, preset):
    assert tool.parser().parse_args(["--preset", preset]).preset == preset


@pytest.mark.parametrize("tool", TOOLS, ids=TOOL_IDS)
def test_tools_refuse_an_unknown_preset(tool):
    with pytest.raises(SystemExit):
        tool.parser().parse_args(["--preset", "huge"])


@pytest.mark.parametrize("tool", [bench, breakdown, bench_train],
                         ids=["bench", "breakdown", "bench_train"])
def test_tools_take_a_force_branch(tool):
    args = tool.parser().parse_args(["--preset", "tiny"])
    assert args.force_branch is None
    for branch in ("sep", "cm", "gather"):
        assert tool.parser().parse_args(["--force_branch", branch]).force_branch == branch
    with pytest.raises(SystemExit):
        tool.parser().parse_args(["--force_branch", "dense"])


def test_bench_train_makes_the_synthetic_batch_from_a_seed():
    import torch

    a = bench_train.synthetic_batch(91, 2, 64, 10, 7, "cpu", seed=0)
    b = bench_train.synthetic_batch(91, 2, 64, 10, 7, "cpu", seed=0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["images"].shape == (2, 64, 64, 3) and a["boxes"].shape == (2, 10, 4)
    assert a["valid"].sum(1).tolist() == [7, 7] and a["valid"][:, :7].all()
    assert a["labels"].max() < 91 and a["boxes"].min() >= 0.2 and a["boxes"].max() <= 0.6
    args = bench_train.parser().parse_args([])
    assert (args.preset, args.batch, args.gt_per_img, args.max_gt) == ("small", None, 7, 100)


def test_breakdown_train_mode_defaults():
    import torch

    args = breakdown.parser().parse_args(["--train"])
    assert args.train and args.batch is None and args.dtype is None
    assert not args.grad_checkpointing
    # bf16 training is ported: --dtype takes both spellings, the release batch stays the default
    for name in ("bfloat16", "bf16"):
        args = breakdown.parser().parse_args(["--train", "--dtype", name, "--grad_checkpointing"])
        assert breakdown.DTYPES[args.dtype] == torch.bfloat16 and args.grad_checkpointing
    with pytest.raises(SystemExit):
        breakdown.parser().parse_args(["--train", "--dtype", "float16"])


def test_bench_deform_defaults_and_its_tolerance():
    """`bench_deform` times the train step at batch 4 (what `compare_trees`
    passes) beside a bf16 eval step at 32, and holds every output to the
    tolerance of chip_smoke.py: 2e-5 on an output, x max(1, max |plain|) on a
    gradient and x 4 more on d(value), + 2^-8 |plain| in bf16."""
    import torch

    from lwdetr_tpu_torch import compare_trees

    args = bench_deform.parser().parse_args([])
    assert (args.preset, args.batch, args.eval_batch) == ("small", 4, 32)
    assert compare_trees.BATCH["bench_deform"] == 4
    ref = torch.full((3,), 10.0)
    ok = ref + 7.9e-4  # 4 x 2e-5 x 10 = 8e-4
    assert bench_deform.max_error(([ok], ref, ref), ([ref], ref, ref), torch.float32) > 0
    with pytest.raises(AssertionError, match="dvalue"):
        bench_deform.max_error(([ref + 9e-4], ref, ref), ([ref], ref, ref), torch.float32)
    with pytest.raises(AssertionError, match="dloc"):
        bench_deform.max_error(([ref], ref + 3e-4, ref), ([ref], ref, ref), torch.float32)
    # a forward output in bf16: half a bf16 ulp of the value
    assert bench_deform.max_error(ref + 0.039, ref, torch.bfloat16) > 0
    with pytest.raises(AssertionError, match="out"):
        bench_deform.max_error(ref + 0.041, ref, torch.bfloat16)
    B, H, D, P, Q, shapes = bench_deform.LARGE_TRAIN
    assert (B, H, D, P, Q) == (8, 24, 16, 4, 3900) and shapes == [(80, 80), (20, 20)]


@pytest.mark.parametrize("step", bench_deform.STEPS)
def test_bench_deform_value_reads_the_step_it_is_given(step):
    """`--value_step` picks the step whose sampler launches `value` sums (a
    stubbed run: one recorded call a step, each step with its own launch
    count), and `compare_trees.py` passes it to every run of both trees."""
    from unittest import mock

    import torch

    from lwdetr_tpu_torch import compare_trees

    assert bench_deform.parser().parse_args([]).value_step == "train/default"
    assert bench_deform.parser().parse_args(["--value_step", step]).value_step == step
    with pytest.raises(SystemExit):
        bench_deform.parser().parse_args(["--value_step", "train/other"])
    x = torch.zeros(2)
    calls = {(s, "K3", "[]"): [i + 1, "ms_deform_attn_cm_fwd", [x]]
             for i, s in enumerate(bench_deform.STEPS)}
    with mock.patch.object(bench_deform, "recorded_calls", return_value=calls), \
            mock.patch.object(bench_deform, "large_train_call", return_value=[x]), \
            mock.patch.object(bench_deform, "timed",
                              return_value={"device_ms": 0.5, "ms": 1.0, "max_abs_err": 0.0}), \
            mock.patch.object(bench_deform.da, "ms_deform_attn_cm_plain", return_value=x), \
            mock.patch.object(bench_deform.da, "ms_deform_attn_sep_panels_bwd_plain",
                              return_value=x), \
            mock.patch.object(bench_deform, "card_line", return_value="card, 700 W"), \
            mock.patch.object(bench_deform.torch.cuda, "get_device_name", return_value="card"):
        out = bench_deform.run("tiny", 4, 32, step)
    assert out["value_step"] == step
    assert out["value"] == 0.5 * (bench_deform.STEPS.index(step) + 1)
    assert out["device_ms_by_step"]["check/large_train"] == 0.5 * 3 * 2  # f32 and bf16
    runs = []
    with mock.patch.object(compare_trees, "run_json",
                           side_effect=lambda tree, args: runs.append(args) or
                           {"value": 1.0, "unit": "ms"}), \
            mock.patch.object(compare_trees.subprocess, "run"), \
            mock.patch.object(compare_trees, "card_line", return_value="card, 700 W"), \
            mock.patch("sys.argv", ["compare_trees", "--other", ".", "--presets", "tiny",
                                    "--tool", "bench_deform", "--value_step", step]):
        compare_trees.main()
    assert len(runs) == 4
    assert all(args[-2:] == ["--value_step", step] for args in runs)


@pytest.mark.parametrize("batch,steps", [
    (4, ["eval", "train/cm", "train/default", "train/gather"]),
    (0, ["eval"]),
], ids=["train_and_eval", "eval_only"])
def test_bench_deform_batch_0_runs_the_eval_step_alone(batch, steps):
    """`--batch 0` skips the train steps (large's and xlarge's are not ported),
    so that `--preset large --batch 0 --value_step eval` times K4 on the bf16
    eval step's own inputs (stubbed steps: each calls one sampler wrapper);
    a train step's `value` then refuses, and `compare_trees.py` passes
    `--batch` to every run of both trees."""
    from types import SimpleNamespace
    from unittest import mock

    import torch

    from lwdetr_tpu_torch import compare_trees

    assert bench_deform.parser().parse_args(["--batch", "0"]).batch == 0
    x = torch.zeros(2)
    made = []

    def make_train_step(preset, b, seed):
        made.append(("train", preset, b))
        return SimpleNamespace(model=None), lambda: bench_deform.da.ms_deform_attn_sep_panels_fwd(x)

    def make_step(preset, b, dtype):
        made.append(("eval", preset, b))
        return lambda: bench_deform.da.ms_deform_attn_sep_panels_fwd(x)

    with mock.patch.object(bench_deform.da, "ms_deform_attn_sep_panels_fwd", return_value=x), \
            mock.patch.object(bench_deform.bench_train, "make_train_step", make_train_step), \
            mock.patch.object(bench_deform.bench, "make_step", make_step), \
            mock.patch.object(bench_deform, "set_force_branch"), \
            mock.patch.object(bench_deform.torch.cuda, "synchronize"):
        calls = bench_deform.recorded_calls("large", batch, 32)
        assert sorted(step for step, *_ in calls) == steps
        assert all(name == "K4" and n == 1 for (_, name, _), (n, *_) in calls.items())
        assert made == [("train", "large", batch)] * (batch > 0) + [("eval", "large", 32)]
        with mock.patch.object(bench_deform, "large_train_call", return_value=[x]), \
                mock.patch.object(bench_deform, "timed",
                                  return_value={"device_ms": 0.5, "ms": 1.0, "max_abs_err": 0.0}), \
                mock.patch.object(bench_deform.da, "ms_deform_attn_sep_panels_plain",
                                  return_value=x), \
                mock.patch.object(bench_deform.da, "ms_deform_attn_sep_panels_bwd_plain",
                                  return_value=x), \
                mock.patch.object(bench_deform, "card_line", return_value="card, 700 W"), \
                mock.patch.object(bench_deform.torch.cuda, "get_device_name",
                                  return_value="card"):
            out = bench_deform.run("large", batch, 32, "eval")
            assert out["value"] == 0.5 and out["batch"] == batch
            assert sorted(out["device_ms_by_step"]) == sorted(steps + ["check/large_train"])
            if not batch:
                with pytest.raises(ValueError, match="value_step"):
                    bench_deform.run("large", batch, 32, "train/default")
    runs = []
    with mock.patch.object(compare_trees, "run_json",
                           side_effect=lambda tree, args: runs.append(args) or
                           {"value": 1.0, "unit": "ms"}), \
            mock.patch.object(compare_trees.subprocess, "run"), \
            mock.patch.object(compare_trees, "card_line", return_value="card, 700 W"), \
            mock.patch("sys.argv", ["compare_trees", "--other", ".", "--presets", "large",
                                    "--tool", "bench_deform", "--batch", str(batch),
                                    "--value_step", "eval"]):
        compare_trees.main()
    assert len(runs) == 4
    assert all(args[args.index("--batch") + 1] == str(batch) for args in runs)


@pytest.mark.parametrize("name", list(bench_variants.VARIANTS))
def test_bench_variants_edits_match_the_sampler_source(name):
    """Each variant of `bench_variants` is the K4 / K10 source with text edits
    that must each match it once, so that a later change of the source that
    breaks a variant shows here, not on the card; a stale edit raises."""
    from lwdetr_tpu_torch.ops import _build

    text = (_build.CSRC / bench_variants.SOURCE).read_text()
    edited = bench_variants.variant_source(text, bench_variants.VARIANTS[name])
    assert (edited == text) == (name == "tree")
    with pytest.raises(ValueError, match="once"):
        bench_variants.variant_source(text, [["no such text in the source", ""]])
    args = bench_variants.parser().parse_args(["--variants", name, "--no-steps"])
    assert args.variants == [name] and not args.steps and args.other is None


def test_compare_trees_passes_the_dtype_and_takes_breakdowns_in_turns():
    """`--dtype` reaches bench_train and breakdown in both trees, and the
    breakdowns run in the tool's turns: other, this, this, other."""
    from unittest import mock

    from lwdetr_tpu_torch import compare_trees

    runs = []
    with mock.patch.object(compare_trees, "run_json",
                           side_effect=lambda tree, args: runs.append((tree, args)) or
                           {"value": 1.0, "unit": "img/s"}), \
            mock.patch.object(compare_trees.subprocess, "run"), \
            mock.patch.object(compare_trees, "card_line", return_value="card, 700 W"), \
            mock.patch("sys.argv", ["compare_trees", "--other", "/elsewhere", "--presets", "large",
                                    "--tool", "bench_train", "--batch", "2", "--dtype", "bfloat16",
                                    "--breakdown"]):
        compare_trees.main()
    assert len(runs) == 8
    assert all(args[-2:] == ["--dtype", "bfloat16"] or args[-3:-1] == ["--dtype", "bfloat16"]
               for _, args in runs)
    tools = [args[1] for _, args in runs]
    assert tools == ["lwdetr_tpu_torch.bench_train"] * 4 + ["lwdetr_tpu_torch.breakdown"] * 4
    assert all(args[-1] == "--train" for _, args in runs[4:])
    order = ["other" if str(tree) == "/elsewhere" else "this" for tree, _ in runs]
    assert order == ["other", "this", "this", "other"] * 2
    with mock.patch("sys.argv", ["compare_trees", "--other", ".", "--tool", "bench",
                                 "--dtype", "bfloat16"]), pytest.raises(SystemExit):
        compare_trees.main()


def test_bench_attention_takes_the_wide_shapes():
    """`--preset wide` times the wide attention case at the decoder's head dims
    above 64: each a head dim the wide case takes unpadded, the ones summed
    into `value` among them."""
    from lwdetr_tpu_torch.ops import flash_attention as fa

    assert bench_attention.parser().parse_args(["--preset", "wide"]).preset == "wide"
    assert set(bench_attention.WIDE_COMMON_DIMS) <= set(bench_attention.WIDE_HEAD_DIMS)
    assert all(fa.is_wide_head_dim(D) for D in bench_attention.WIDE_HEAD_DIMS)
    assert fa.padded_head_dim(2112) == 2112 and 2112 in bench_attention.WIDE_HEAD_DIMS
    assert bench_attention.wide_case_takes(2112) and not bench_attention.wide_case_takes(2100)


# -- the one-program tools: bench_all, bench's f32-host value, breakdown's stages and trace --


def _fake_timing(ms_by_call):
    """A `measure_ms` stand-in returning the next ms of `ms_by_call` (the CPU has no events)."""
    calls = iter(ms_by_call)

    def measure(fn, *args, **kwargs):
        ms = next(calls)
        return {"ms": ms, "ms_mean": ms, "ms_min": ms - 1, "ms_max": ms + 1, "samples": [ms]}

    return measure


def test_bench_all_prints_the_jax_tools_fields():
    from unittest import mock

    import torch

    from lwdetr_tpu_torch import bench_all

    args = bench_all.parser().parse_args([])
    assert args.sizes == ["tiny", "small", "medium", "large", "xlarge"] and args.batch == 32
    assert bench_all.parser().parse_args(["--sizes", "small", "tiny"]).sizes == ["small", "tiny"]
    with pytest.raises(SystemExit):
        bench_all.parser().parse_args(["--sizes", "huge"])
    model = torch.nn.Linear(1, 1)
    with mock.patch.object(bench_all, "make_forward", return_value=(model, lambda x: None)), \
            mock.patch.object(bench_all, "synthetic_images", return_value=torch.zeros(1)), \
            mock.patch.object(bench_all, "measure_ms", _fake_timing([40.0, 20.0])), \
            mock.patch.object(bench_all, "batch1_graph"), \
            mock.patch.object(bench_all, "graph_ms", return_value=[2.5, 2.0, 3.0, 2.2, 2.4]), \
            mock.patch.object(bench_all, "card_line", return_value="card, 700.00 W"), \
            mock.patch.object(bench_all.torch.cuda, "get_device_name", return_value="card"):
        line = bench_all.bench_size("small", 32)
    assert line["metric"] == "lwdetr_small_640_bf16_infer_throughput"
    assert line["value"] == 32 / 0.04 and line["batch_ms"] == 40.0
    assert line["batch_ms_spread"] == [39.0, 41.0] and line["bs1_ms_spread"] == [19.0, 21.0]
    assert line["bs1_ms"] == 20.0 and line["bs1_device_ms"] == 2.4
    assert line["bs1_device_ms_spread"] == [2.0, 3.0]
    assert line["bs1_dispatch_overhead_ms"] == pytest.approx(20.0 - 2.4)
    assert line["ref_trt_fp16_ms_bs1"] == 2.9 and line["card"] == "card, 700.00 W"
    assert bench_all.BASELINE_TRT_MS == {"tiny": 2.0, "small": 2.9, "medium": 5.6, "large": 8.8,
                                         "xlarge": 19.1}


def test_the_batch1_graph_refuses_a_replay_after_a_weight_changed():
    """`GuardedGraph`'s guard, without a capture: a write in place moves the
    parameter's `_version`, and the replay refuses before it launches."""
    from unittest import mock

    import torch

    from lwdetr_tpu_torch.utils.graphs import GuardedGraph

    p = torch.nn.Parameter(torch.ones(3))
    graph = GuardedGraph.__new__(GuardedGraph)
    graph.guarded, graph.graph, graph.out = [p], mock.Mock(), "outputs"
    graph.stamp = graph._stamp()
    assert graph.replay() == "outputs" and graph.graph.replay.call_count == 1
    with torch.no_grad():
        p.mul_(1.0)
    with pytest.raises(RuntimeError, match="capture it again"):
        graph.replay()
    assert graph.graph.replay.call_count == 1


def test_bench_prints_value_f32_host():
    from unittest import mock

    import torch

    model = torch.nn.Linear(1, 1)
    made = []
    with mock.patch.object(bench, "make_forward", return_value=(model, lambda x: None)), \
            mock.patch.object(bench, "synthetic_images",
                              side_effect=lambda b, dtype, device: made.append(dtype)), \
            mock.patch.object(bench, "measure_ms", _fake_timing([10.0, 16.0])), \
            mock.patch.object(bench, "card_line", return_value="card, 700.00 W"), \
            mock.patch.object(bench.torch.cuda, "get_device_name", return_value="card"):
        line = bench.run("small", 32)
    assert made == [torch.bfloat16, torch.float32]
    assert line["value"] == 3200.0 and line["value_spread"] == [32 / 0.011, 32 / 0.009]
    assert line["value_f32_host"] == 2000.0
    assert line["value_f32_host_spread"] == [32 / 0.017, 32 / 0.015]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_breakdown_writes_a_trace_with_its_stage_ranges(train, tmp_path):
    """`breakdown --trace` on a reduced model on the CPU (its timing and
    memory calls stubbed: they read the card): the Chrome trace parses and
    holds the program's span of every stage the step runs (and, training,
    of each phase of the step and the matcher);
    the stages of the CPU's (kernel-free) steps sum to the busy time, 0; the
    tool hangs no hook on the model and leaves recording off."""
    import json
    from types import SimpleNamespace
    from unittest import mock

    import torch

    from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
    from lwdetr_tpu_torch.models.criterion import SetCriterion
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.train import engine
    from lwdetr_tpu_torch.utils import trace as spans
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = ModelConfig(encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
                      out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64,
                      dim_feedforward=128, sa_nheads=4, ca_nheads=8, dec_n_points=2,
                      dec_layers=2, group_detr=2, num_queries=12, num_classes=7,
                      two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
    tcfg = TrainConfig(ia_bce_loss=True, use_ema=True, max_gt=4)
    images = torch.randn(1, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    model = build_model(cfg, device="cpu", state_dict=init_state_dict(cfg, 0))

    def forward(x):
        out = model(x)
        return bench.post_process(out["pred_logits"], out["pred_boxes"],
                                  torch.full((1, 2), 128.0), 10)

    state = engine.create_train_state(cfg, tcfg, niter_per_ep=10, device="cpu",
                                      state_dict=init_state_dict(cfg, 0))
    setup = SimpleNamespace(
        state=state, criterion=SetCriterion(cfg, tcfg), tcfg=tcfg, seed=0, scheds=[[0.0], [0.0]],
        static=dict(static_zero_drop_path=True, static_zero_dropout=True),
        data={"images": images, "labels": torch.zeros(1, 4, dtype=torch.long),
              "boxes": torch.full((1, 4, 4), 0.3),
              "valid": torch.tensor([[True] * 2 + [False] * 2])})
    path = tmp_path / "trace.json"
    with mock.patch.object(bench, "make_forward", return_value=(model, forward)), \
            mock.patch.object(bench, "synthetic_images", return_value=images), \
            mock.patch.object(bench_train, "make_train_setup", return_value=setup), \
            mock.patch.object(breakdown, "measure_ms", _fake_timing([5.0])), \
            mock.patch.object(breakdown, "card_line", return_value="card, 700.00 W"), \
            mock.patch.object(torch.cuda, "synchronize"), \
            mock.patch.object(torch.cuda, "reset_peak_memory_stats"), \
            mock.patch.object(torch.cuda, "max_memory_allocated", return_value=0), \
            mock.patch.object(torch.cuda, "get_device_name", return_value="card"):
        line = breakdown.run("small", 1, torch.float32, steps=1, train=train, trace=str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    expect = {spans.PREFIX + n for n in spans.STAGES + (spans.PHASES + ("matcher",) if train
                                                          else ("post_process",))}
    assert expect <= names, expect - names
    assert not spans.enabled()
    assert line["trace"] == str(path)
    assert line["stages_sum_ms_per_step"] == pytest.approx(line["device_busy_ms_per_step"])
    assert not any(hasattr(m, "_forward_hooks") and m._forward_hooks for m in model.modules())
    args = breakdown.parser().parse_args(["--trace", "out.json"])
    assert args.trace == "out.json" and breakdown.parser().parse_args([]).trace is None


def test_train_flop_report_prints_classes_stages_and_tflops(capsys):
    from unittest import mock

    from lwdetr_tpu_torch import train_flop_report

    args = train_flop_report.parser().parse_args([])
    assert (args.preset, args.batch, args.step_ms, args.device) == ("small", None, None, None)
    fake = {"total": 4e12, "flops_by_class": {"gemm": 3e12, "attention": 1e12},
            "flops_by_stage": {"forward/backbone/encoder": {"gemm": 1e12},
                               "backward": {"gemm": 2e12, "attention": 1e12}},
            "forward_total": 1e12}
    with mock.patch.object(train_flop_report, "report",
                           side_effect=lambda p, b, g, ms, d: dict(fake, batch=4,
                                                                   tflops_per_s=4e12 / ms / 1e9)), \
            mock.patch("sys.argv", ["train_flop_report", "--step_ms", "40"]):
        train_flop_report.main()
    out = capsys.readouterr().out
    assert "4000.000 GFLOP" in out and "backward" in out and "100.00 TFLOP/s" in out
