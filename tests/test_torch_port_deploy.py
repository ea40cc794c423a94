"""The port's deploy path against the JAX package's, on the CPU.

* (a) Each forward kernel is a `torch.library` operator of the `lwdetr`
  namespace: `torch.library.opcheck` holds its schema, its fake version and
  its autograd formula against its CPU implementation (the plain version),
  in f32 and bf16.
* (b) `torch.export` of small, tiny and large at 640 keeps one operator node
  a kernel launch, in `chip_smoke.EXPECTED_LAUNCHES`' counts, with every plain
  version made to raise while it traces: none is inlined.
* (c) On the JAX deploy test's NANO config (`tests/test_deploy.py`) with the
  weights carried across by `state_dict_from_jax`, the saved and loaded
  artifact equals the eager port bit for bit, in f32 and bf16, and in f32 it
  equals the JAX `make_export_fn` within `test_torch_port_model.py::
  test_post_process_matches_jax`'s bounds.
* (d) `evaluate_coco` through an artifact of the micro fixture's weights gives
  `golden_stats_deploy.json` within 1e-7, which is not `golden_stats.json`:
  the deploy path resizes with PIL, the eval loader natively.
* (e) The CLI's `export_model` (and its `--dry-run`), the deploy benchmark's
  CLI, and (f) the refusal of an artifact of the card without a card.
"""
import collections
import dataclasses
import json
import os
import shutil
import zipfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.deploy.export import make_export_fn as jax_make_export_fn
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu_torch import main as cli
from lwdetr_tpu_torch.config import ModelConfig, get_config
from lwdetr_tpu_torch.data import native
from lwdetr_tpu_torch.data import transforms as T
from lwdetr_tpu_torch.deploy import benchmark, export
from lwdetr_tpu_torch.models.lwdetr import build_model
from lwdetr_tpu_torch.ops import deform_attn as tda
from lwdetr_tpu_torch.ops import flash_attention as tfa
from lwdetr_tpu_torch.weights import init_state_dict, read_jax_npz, state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures", "micro_map")
GOLDEN_ATOL = 1e-7  # the JAX package's bound on its goldens
# the micro model of tests/micro_map_common.py:30-40, as CLI flags
MICRO_FLAGS = ("--encoder vit_tiny --vit_encoder_num_layers 2 --window_block_indexes 0 "
               "--out_feature_indexes 0 1 --projector_scale P4 --hidden_dim 64 "
               "--dim_feedforward 128 --sa_nheads 4 --ca_nheads 8 --dec_n_points 2 "
               "--dec_layers 2 --group_detr 2 --num_queries 12 --num_select 10 --two_stage "
               "--lite_refpoint_refine --bbox_reparam --square_resize_div_64 --max_gt 10").split()
# tests/test_deploy.py's NANO, at its 128 x 128
NANO = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
    out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64, dim_feedforward=128,
    sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2, group_detr=3, num_queries=12,
    num_select=10, num_classes=7, two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
NANO_HW = (128, 128)
# operator -> the kernel whose launch it is (chip_smoke.KERNEL_NAMES)
OPERATORS = {"window_attention_bias": "K1", "flash_attention_cm": "K2",
             "ms_deform_attn_cm": "K3", "ms_deform_attn_sep_panels": "K4",
             "window_attention": "K9", "ms_deform_attn": "K10"}
# the plain versions the CPU implementations run; none may run while tracing
PLAIN = ((tfa, "attention_cm_plain"), (tfa, "attention_lse_plain"),
         (tda, "ms_deform_attn_cm_plain"), (tda, "ms_deform_attn_sep_panels_plain"),
         (tda, "ms_deform_attn_plain"))


# -- (a) the operators -----------------------------------------------------------------------


def _operator_inputs(name, dtype):
    """Small CPU inputs of operator `name`, the floating tensors requiring grad."""
    g = torch.Generator().manual_seed(3)

    def t(*shape, scale=1.0, grad=True):
        return (scale * torch.randn(*shape, generator=g)).to(dtype).requires_grad_(grad)

    loc = torch.rand(1, 5, 2, 2, 2, 2, generator=g).requires_grad_()
    weights = torch.rand(1, 5, 2, 2, 2, generator=g).requires_grad_()
    shapes = [3, 4, 2, 2]
    return {"window_attention_bias": (t(2, 96, 20, scale=0.5), t(96, scale=0.1), 2, 0.25),
            "window_attention": (t(2, 96, 20, scale=0.5), 2, 0.25),
            "flash_attention_cm": (t(1, 96, 150, scale=0.5), 2, 0.25, True),
            "ms_deform_attn_cm": (t(1, 32, 16), shapes, loc, weights, 2),
            "ms_deform_attn_sep_panels": ([t(1, 2, 3, 4 * 16), t(1, 2, 2, 2 * 16)], shapes, loc,
                                          weights),
            "ms_deform_attn": (t(1, 16, 2, 16), shapes, loc, weights)}[name]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPERATORS))
def test_each_kernel_is_an_operator_with_fake_and_autograd(name, dtype):
    op = getattr(torch.ops.lwdetr, name)
    result = torch.library.opcheck(op, _operator_inputs(name, getattr(torch, dtype)),
                                   test_utils=("test_schema", "test_autograd_registration",
                                               "test_faketensor"))
    assert set(result.values()) == {"SUCCESS"}, result


def test_k2_writes_its_log_sum_exp_only_when_asked():
    qkv = 0.5 * torch.randn(1, 96, 150, generator=torch.Generator().manual_seed(0))
    out, lse = torch.ops.lwdetr.flash_attention_cm(qkv, 2, 0.25, False)
    assert lse.shape == (0,)
    out2, lse2 = torch.ops.lwdetr.flash_attention_cm(qkv, 2, 0.25, True)
    assert torch.equal(out, out2) and lse2.shape == (1, 2, 150) and lse2.dtype == torch.float32
    s = torch.einsum("bhdn,bhdm->bhnm", qkv.reshape(1, 3, 2, 16, 150)[:, 0] * 0.25,
                     qkv.reshape(1, 3, 2, 16, 150)[:, 1])
    torch.testing.assert_close(lse2, torch.logsumexp(s, -1) / np.log(2.0))


# -- (b) the exported graphs -----------------------------------------------------------------


def _raising(name):
    def plain(*args, **kwargs):
        raise AssertionError(f"{name} ran while the model was traced")

    return plain


@pytest.mark.parametrize("preset", ["small", "tiny", "large"])
def test_the_exported_graph_holds_one_operator_a_kernel_launch(preset):
    cfg = get_config(preset)
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16,
                        state_dict=init_state_dict(cfg, seed=0))
    fn = export.make_export_fn(model, cfg.num_select, (640, 640))
    with mock.patch.multiple(tfa, attention_cm_plain=_raising("attention_cm_plain"),
                             attention_lse_plain=_raising("attention_lse_plain")), \
            mock.patch.multiple(tda, **{n: _raising(n) for m, n in PLAIN if m is tda}):
        program = torch.export.export(fn, (torch.zeros(1, 640, 640, 3),))
    nodes = collections.Counter(str(n.target) for n in program.graph.nodes
                                if n.op == "call_function")
    launches = {OPERATORS[op]: nodes[f"lwdetr.{op}.default"] for op in OPERATORS}
    expected = {k: v for k, v in chip_smoke.EXPECTED_LAUNCHES[preset].items() if k in launches}
    assert launches == expected
    assert sum(n for target, n in nodes.items() if target.startswith("lwdetr.")) == sum(
        expected.values())


# -- (c) the artifact against the eager port and the JAX export ------------------------------


@pytest.fixture(scope="module")
def nano():
    """(JAX model, its variables, the port's state_dict of them, images): the
    JAX initialisation, each parameter moved a little (zero-initialized heads
    would tie every score)."""
    jmodel = jax_build_model(JaxModelConfig(**dataclasses.asdict(NANO)))
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, *NANO_HW, 3), jnp.float32), train=True)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(x.shape)
                          .astype(np.float32), variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    images = rng.standard_normal((1, *NANO_HW, 3)).astype(np.float32)
    return jmodel, {"params": params, "batch_stats": stats}, \
        state_dict_from_jax(params, stats, NANO), images


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_artifact_equals_the_eager_port_and_the_jax_export(nano, dtype, tmp_path):
    jmodel, variables, sd, images = nano
    model = build_model(NANO, device="cpu", dtype=getattr(torch, dtype), state_dict=sd)
    path = export.export_serialized(model, str(tmp_path / "m.pt2"), NANO_HW, 1, NANO.num_select)
    call, meta = export.load_serialized(path)
    assert meta == {"input_hw": list(NANO_HW), "batch": 1, "num_select": NANO.num_select,
                    "dtype": dtype, "device": "cpu"}
    x = torch.from_numpy(images)
    got = call(x)
    with torch.no_grad():
        eager = export.make_export_fn(model, NANO.num_select, NANO_HW)(x)
    for a, b in zip(got, eager):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if dtype == "bfloat16":
        return
    js, jl, jb = jax.jit(jax_make_export_fn(jmodel, NANO.num_select, NANO_HW))(
        variables, jnp.asarray(images))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jl))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jb), atol=1e-2)  # pixels


# -- (d) the deploy stats on the micro fixture ------------------------------------------------


def _golden(name):
    with open(os.path.join(FIXDIR, name)) as f:
        return json.load(f)["stats"]


@pytest.fixture(scope="module")
def micro_artifact(tmp_path_factory):
    """The micro model (f32, the fixture's weights) exported at 640, batch 1, on the CPU."""
    cfg = cli.config_from_args(cli.parser().parse_args(["--device", "cpu", *MICRO_FLAGS])).model
    tree = read_jax_npz(os.path.join(FIXDIR, "weights.npz"))
    sd = state_dict_from_jax(tree["params"], tree.get("batch_stats"), cfg)
    model = build_model(cfg, device="cpu", state_dict=sd)
    path = tmp_path_factory.mktemp("deploy") / "micro.pt2"
    return export.export_serialized(model, str(path), (640, 640), 1, cfg.num_select), sd


def test_evaluate_coco_through_the_artifact_gives_the_deploy_golden(micro_artifact):
    call, meta = export.load_serialized(micro_artifact[0])
    stats = benchmark.evaluate_coco(call, FIXDIR, tuple(meta["input_hw"]), meta["batch"],
                                    device="cpu")
    golden = _golden("golden_stats_deploy.json")
    assert set(stats) == set(golden)
    for k, v in golden.items():
        assert abs(stats[k] - v) <= GOLDEN_ATOL, (k, stats[k], v)


def test_the_deploy_golden_is_not_the_eval_loaders():
    """The deploy path resizes with PIL (`val_transform_square`), which rounds
    the resized pixels to 8 bits; the eval loader's native resize keeps them
    in float. Pixels up to one 8-bit level apart move the micro model's random
    weights' near-tied scores, and the stats with them (AP 0.084 against
    0.174), as in the JAX package."""
    deploy, loader = _golden("golden_stats_deploy.json"), _golden("golden_stats.json")
    assert abs(deploy["AP"] - loader["AP"]) > 0.05
    path = os.path.join(FIXDIR, "val2017", "000000000002.jpg")
    from PIL import Image

    pil, _ = T.val_transform_square(Image.open(path).convert("RGB"), None, 640)
    fast, _, _ = native.load_image_fast(path, 640)
    diff = np.abs(pil - fast).max()
    assert pil.shape == fast.shape and 1e-3 < diff <= 1.0 / 255 / T.IMAGENET_STD.min() + 1e-6


# -- (e) the CLI and the benchmark, (f) an artifact of the card -------------------------------


@pytest.fixture(scope="module")
def micro_pth(micro_artifact, tmp_path_factory):
    path = tmp_path_factory.mktemp("pth") / "micro.pth"
    torch.save({"model": micro_artifact[1]}, path)
    return str(path)


def _export_args(out_dir, *extra):
    return cli.parser().parse_args(["--device", "cpu", *MICRO_FLAGS, "--output_dir", str(out_dir),
                                    "export_model", "--shape", "640", "640", *extra])


def test_the_cli_exports_and_runs_the_artifact_on_an_image(micro_pth, tmp_path, capsys):
    image = os.path.join(FIXDIR, "val2017", "000000000003.jpg")
    args = _export_args(tmp_path, "--infer_dir", image)
    args.resume = micro_pth
    path = cli.main(args)["path"]
    assert path == str(tmp_path / export.ARTIFACT)
    meta = export.read_meta(path)
    assert meta["dtype"] == "bfloat16" and meta["device"] == "cpu" and meta["num_select"] == 10
    line = [ln for ln in capsys.readouterr().out.splitlines() if "top-5" in ln]
    assert len(line) == 1 and line[0].split(":", 1)[1].count("(") == 5
    scores, labels, boxes = export.run_artifact_on_image(path, image, (640, 640))
    assert scores.shape == (1, 10) and boxes.shape == (1, 10, 4) and np.isfinite(boxes).all()


def test_the_cli_export_dry_run_writes_nothing(tmp_path, capsys):
    assert cli.main(_export_args(tmp_path, "--dry-run")) == {"path": None}
    assert "[dry-run] would export" in capsys.readouterr().out
    assert not os.listdir(tmp_path)


def test_the_benchmark_cli_times_and_evaluates_on_the_cpu(micro_artifact, capsys):
    result = benchmark.main(["--path", micro_artifact[0], "--device", "cpu", "--repeats", "2",
                             "--coco_path", FIXDIR, "--limit", "2"])
    lat = result["latency"]
    assert lat["device"] == "cpu" and len(lat["samples_ms"]) == 2 and lat["imgs_per_s"] > 0
    assert set(result["coco"]) == set(_golden("golden_stats.json"))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["artifact"]["batch"] == 1
    with pytest.raises(ValueError, match="--device cpu"):
        benchmark.main(["--path", micro_artifact[0], "--device", "meta"])


def test_an_artifact_of_the_card_is_refused_without_one(micro_artifact, tmp_path, monkeypatch):
    """The artifact's META names its device; loading one of the card without a
    card raises before anything is read (the CPU artifact is relabelled)."""
    src, dst = micro_artifact[0], str(tmp_path / "card.pt2")
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item)
            if item.filename.endswith(f"/extra/{export.META}"):
                data = json.dumps(dict(json.loads(data), device="cuda")).encode()
            zout.writestr(item, data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_serialized(dst)
    shutil.copy(src, tmp_path / "cpu.pt2")
    assert export.load_serialized(str(tmp_path / "cpu.pt2"))[1]["device"] == "cpu"
