"""The PyTorch port stands alone: no JAX, no JAX package, no silent CPU fallback."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

from lwdetr_tpu_torch.config import ModelConfig
from lwdetr_tpu_torch.models import lwdetr as port_model
from lwdetr_tpu_torch.models import matcher as tmatcher
from lwdetr_tpu_torch.ops import _build
from lwdetr_tpu_torch.ops import deform_attn as tda
from lwdetr_tpu_torch.ops import flash_attention as tfa

KERNELS = (tfa.window_attention_bias_kernel, tfa.flash_attention_cm_kernel,
           tda.deform_attn_cm_kernel, tda.deform_attn_sep_kernel,
           tda.deform_attn_sep_bwd_kernel, tfa.flash_attention_cm_bwd_kernel,
           tfa.window_attention_bias_bwd_kernel, tfa.window_attention_bwd_kernel,
           tda.deform_attn_cm_bwd_kernel, tfa.window_attention_kernel,
           tda.deform_attn_rowmajor_kernel, tda.deform_attn_rowmajor_bwd_kernel,
           tmatcher.assignment_kernel)
TINY = ModelConfig(vit_encoder_num_layers=1, out_feature_indexes=(0,), hidden_dim=32,
                   dim_feedforward=32, sa_nheads=2, ca_nheads=2, dec_layers=1,
                   num_queries=4, group_detr=1, num_classes=3, two_stage=True,
                   bbox_reparam=True, lite_refpoint_refine=True)
ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "lwdetr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "lwdetr_tpu", "orbax", "tensorstore", "zstandard")


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
            "ops/flash_attention.py", "ops/_build.py", "bench.py", "breakdown.py",
            "demo.py", "train/checkpoint.py", "main.py"} <= names
    assert "matcher.cu" in _build.SOURCES  # M1, built with the others


def test_the_eval_slice_modules_are_in_the_walk():
    names = {str(p.relative_to(ROOT / "lwdetr_tpu_torch")) for p in PORT_FILES[:-1]}
    assert {"data/coco.py", "data/transforms.py", "data/loader.py", "data/native.py",
            "data/coco_eval.py", "utils/logging.py", "utils/obj365_remap.py",
            "train/checkpoint.py", "main.py"} <= names
    assert PORT_FILES[-1].name == "chip_smoke.py"


def test_the_deploy_modules_are_in_the_walk():
    names = {str(p.relative_to(ROOT / "lwdetr_tpu_torch")) for p in PORT_FILES[:-1]}
    assert {"deploy/__init__.py", "deploy/export.py", "deploy/benchmark.py"} <= names


def test_the_orbax_reader_modules_are_in_the_walk():
    names = {str(p.relative_to(ROOT / "lwdetr_tpu_torch")) for p in PORT_FILES[:-1]}
    assert {"train/orbax_read.py", "utils/zstd.py", "train/checkpoint.py", "weights.py"} <= names


def test_every_host_source_is_registered():
    """The host C++ libraries (built with g++ by their bindings): the
    preprocessing and the zstd decoder of the orbax reader."""
    from lwdetr_tpu_torch.data import native
    from lwdetr_tpu_torch.utils import zstd

    assert set(_build.HOST_SOURCES) == {p.name for p in _build.CSRC.glob("*.cpp")}
    assert {native.SOURCE, zstd.SOURCE} == set(_build.HOST_SOURCES)
    for src, flags in ((native.SOURCE, native.CXX_FLAGS), (zstd.SOURCE, zstd.CXX_FLAGS)):
        assert "-shared" in flags and "-fPIC" in flags
        assert _build.host_library_path(src, flags).parent == ROOT / "build" / "lwdetr_tpu_torch"


def test_the_parallel_and_bench_modules_are_in_the_walk():
    names = {str(p.relative_to(ROOT / "lwdetr_tpu_torch")) for p in PORT_FILES[:-1]}
    assert {"parallel/__init__.py", "parallel/dist.py", "parallel/mesh.py",
            "utils/benchmark.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_names_nothing_under_native(path):
    """No string of the port names the JAX package's `native/` directory or
    its library: the port builds its own copy of the preprocessing."""
    strings = [n.value for n in ast.walk(ast.parse(path.read_text(), filename=str(path)))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    bad = [s for s in strings if "libpreproc" in s or s.strip("/") == "native"
           or s.startswith("native/") or "/native/" in s]
    assert not bad, f"{path.name} names {bad}"


def test_the_eval_path_loads_neither_jax_nor_the_native_directory():
    """In a fresh process: the CLI's modules, the loader's fused path on a
    fixture image, and the modules and shared libraries that are then loaded."""
    code = (
        "import json, sys\n"
        "import lwdetr_tpu_torch.main, lwdetr_tpu_torch.data.loader\n"
        "import lwdetr_tpu_torch.data.coco_eval, lwdetr_tpu_torch.train.checkpoint\n"
        "import lwdetr_tpu_torch.utils.logging, lwdetr_tpu_torch.utils.obj365_remap\n"
        "from lwdetr_tpu_torch.data import native\n"
        "out = native.load_image_fast('tests/fixtures/micro_map/val2017/000000000001.jpg', 64)\n"
        "assert out is not None and out[0].shape == (64, 64, 3)\n"
        "maps = [l.split()[-1] for l in open('/proc/self/maps') if 'preproc' in l]\n"
        "mods = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'maps': sorted(set(maps)), 'modules': mods}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not set(seen["modules"]) & set(FORBIDDEN)
    assert seen["maps"] and all(Path(m).parent == _build.BUILD_DIR for m in seen["maps"])


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
                                         "K9", "K10", "K10b", "M1"]
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
    tiny = dict(K1=3, K2=3, K9=3, K6=3, K7=3, K7nb=3, M1=1)
    assert used(chip_smoke.TRAIN_LAUNCHES["tiny"]) == dict(tiny, K4=3, K5=3)
    assert used(chip_smoke.TRAIN_LAUNCHES["tiny/cm"]) == dict(tiny, K3=3, K8=3)
    assert used(chip_smoke.TRAIN_LAUNCHES["tiny/gather"]) == dict(tiny, K10=3, K10b=3)
    assert used(chip_smoke.TRAIN_LAUNCHES["small"]) == dict(K1=6, K2=7, K4=3, K5=3, K6=7, K7=6,
                                                            M1=1)
    # every train path matches once a step; no eval forward matches
    assert all(n["M1"] == 1 for n in chip_smoke.TRAIN_LAUNCHES.values())
    assert not any(n["M1"] for n in chip_smoke.EXPECTED_LAUNCHES.values())
    # every REPLACES entry names a line of the JAX package that defines that function
    for name, where in {**chip_smoke.REPLACES, **{k + "+": v for k, v in
                                                  chip_smoke.ALSO_REPLACES.items()}}.items():
        path, fn = where.split(" ")
        file, line = path.split(":")
        assert (ROOT / file).read_text().splitlines()[int(line) - 1].startswith(f"def {fn}("), name


def test_chip_smoke_checks_the_kernels_at_each_train_cli_size():
    """The kernel phase's CLI_SCALES tables are small's train step at every
    size but 640 that the train loader draws: the attention calls of small's
    ViT (N, heads, and the kernel `attention_cm` takes; its backward's
    counterpart) and the map its projector gives the decoder's sampler."""
    import chip_smoke
    from lwdetr_tpu_torch.config import get_config
    from lwdetr_tpu_torch.data import transforms as T
    from lwdetr_tpu_torch.models.lwdetr import Backbone

    assert set(chip_smoke.CLI_SCALES) | {640} == set(T.SCALES_SQUARE)
    torch.manual_seed(0)
    backbone = Backbone(get_config("small")).eval()
    calls = set()

    def record(qkv_t, num_heads, scale=None, bias=None):  # no attention computed: zeros
        B, ZC, N = qkv_t.shape
        kernel = ("K1" if bias is not None else "K9") if N <= tfa._WINDOW_MAX_N else "K2"
        calls.add((kernel, B * chip_smoke.TRAIN_BATCH, ZC // 3, N, num_heads))
        return qkv_t.new_zeros(B, ZC // 3, N)

    backward = {"K1": "K7", "K2": "K6"}
    panels = dict(chip_smoke.CLI_SEP_SHAPES)
    for size in chip_smoke.CLI_SCALES:
        calls.clear()
        with mock.patch.object(tfa, "attention_cm", record), torch.no_grad():
            maps = backbone(torch.zeros(1, size, size, 3))
        tag = f"@cli{size}_"
        fwd = {(k, B, C, N, h) for key, k, B, C, N, h, _, bias in chip_smoke.CLI_ATTENTION_SHAPES
               if tag in key and bias == (k == "K1")}
        bwd = {(k, B, C, N, h) for key, k, B, C, N, h, *_ in chip_smoke.CLI_ATTENTION_BWD_SHAPES
               if tag in key}
        assert calls == fwd, size
        assert {(backward[k], *rest) for k, *rest in calls} == bwd, size
        (B, H, D, P, Q, shapes), = [panels[f"cli{size}"]]
        assert [tuple(m.shape) for m in maps] == [(1, *hw, H * D) for hw in shapes], size


def _loader_sizes(folder, train, seed=0, batches=None, square=False, epoch=0):
    from lwdetr_tpu_torch.data.coco import CocoDetection
    from lwdetr_tpu_torch.data.loader import DetectionLoader

    ds = CocoDetection(str(ROOT / folder / "val2017"),
                       str(ROOT / folder / "annotations" / "instances_val2017.json"))
    loader = DetectionLoader(ds, batch_size=4, train=train, max_gt=100, seed=seed,
                             square_div_64=square, num_workers=0)
    loader.set_epoch(epoch)
    sizes = []
    for batch in loader:
        sizes.append(tuple(batch["images"].shape[1:3]))
        if len(sizes) == batches:
            break
    return sizes


def test_chip_smoke_checks_the_kernels_at_each_padded_size():
    """The padded phase's size tables are what the legacy recipe draws from
    the fixture at batch 4: the first train batch at PADDED_TRAIN_SEED (the
    train step), one epoch at PADDED_CLI_SEED (the train CLI), the val
    batches (the CLI's evals) and the padded fixture's first (the eval
    forward). At each size, small's ViT attention calls and the map its
    projector gives the sampler are in the drawn-shape tables, with their
    backwards at the train sizes, and every entry of the tables is drawn."""
    import chip_smoke as cs
    from lwdetr_tpu_torch.config import get_config
    from lwdetr_tpu_torch.models.lwdetr import Backbone

    fixture = "tests/fixtures/micro_map"
    train = (_loader_sizes(fixture, True, cs.PADDED_TRAIN_SEED, batches=1)
             + _loader_sizes(fixture, True, cs.PADDED_CLI_SEED))
    evals = _loader_sizes(fixture, False) + _loader_sizes(cs.PADDED_FIXTURE, False, batches=1)
    assert sorted(set(train)) == sorted(cs.PADDED_TRAIN_SIZES)
    assert sorted(set(evals)) == sorted(cs.PADDED_EVAL_SIZES)

    torch.manual_seed(0)
    backbone = Backbone(get_config("small")).eval()
    calls = set()

    def record(qkv_t, num_heads, scale=None, bias=None):  # no attention computed: zeros
        B, ZC, N = qkv_t.shape
        kernel = ("K1" if bias is not None else "K9") if N <= tfa._WINDOW_MAX_N else "K2"
        calls.add((kernel, B * cs.PADDED_BATCH, ZC // 3, N, num_heads))
        return qkv_t.new_zeros(B, ZC // 3, N)

    fwd = {tuple(e[1:6]) for e in cs.PADDED_DRAWN_ATTENTION}
    bwd = {tuple(e[1:6]) for e in cs.PADDED_DRAWN_ATTENTION_BWD}
    sep = {(key.split("@")[0], Q, tuple(map(tuple, shapes)), H * D)
           for key, (B, H, D, P, Q, shapes) in cs.PADDED_DRAWN_SEP}
    sep_bwd = {(Q, tuple(map(tuple, shapes))) for _, (B, H, D, P, Q, shapes)
               in cs.PADDED_DRAWN_SEP_BWD}
    seen = {"fwd": set(), "bwd": set(), "sep": set(), "sep_bwd": set()}
    backward = {"K1": "K7", "K2": "K6"}
    for size, is_train in [(s, True) for s in cs.PADDED_TRAIN_SIZES] + [
            (s, False) for s in cs.PADDED_EVAL_SIZES]:
        calls.clear()
        with mock.patch.object(tfa, "attention_cm", record), torch.no_grad():
            maps = backbone(torch.zeros(1, *size, 3))
        assert calls <= fwd, size
        seen["fwd"] |= calls
        (hw,) = [tuple(m.shape[1:3]) for m in maps]
        positions = hw[0] * hw[1]
        if is_train:
            back = {(backward[k], *rest) for k, *rest in calls}
            assert back <= bwd, size
            seen["bwd"] |= back
            panel = ("K4", 3900, (hw,), maps[0].shape[3])
            seen["sep_bwd"].add((3900, (hw,)))
        else:
            panel = ("K4" if positions > 4096 else "K3", 300, (hw,), maps[0].shape[3])
        assert panel in sep, size
        seen["sep"].add(panel)
    assert seen == {"fwd": fwd, "bwd": bwd, "sep": sep, "sep_bwd": sep_bwd}


def test_chip_smoke_checks_the_kernels_at_each_variant_cli_size():
    """The variant train CLI's size table is what the square recipe draws from
    the fixture in one epoch at batch 4 and VARIANT_CLI_SEED. At each size the
    micro variant model (the golden's flags) in train mode calls attention at
    shapes of the kernel phase's tables (its ViT) or of
    VARIANT_CLI_DRAWN_ATTENTION (its decoder), with their backwards in the
    backward tables, and the sampler at the size's VARIANT_CLI_DRAWN_SEP
    entry; every entry of the variant tables is drawn. Its evals at 640 call
    the micro model's eval shapes (K1 / K2 / K9@micro, SEP_MICRO)."""
    import chip_smoke as cs
    from lwdetr_tpu_torch import main as cli

    sizes = _loader_sizes("tests/fixtures/micro_map", True, cs.VARIANT_CLI_SEED, square=True)
    assert len(sizes) == cs.CLI_STEPS and all(h == w for h, w in sizes)
    assert sorted({h for h, _ in sizes}) == sorted(cs.VARIANT_CLI_SIZES)
    with open(ROOT / cs.FIXTURE / "golden_stats_variants.json") as f:
        flags = json.load(f)["flags"]
    cfg = cli.config_from_args(cli.parser().parse_args(["--coco_path", "x", *flags])).model
    model = port_model.build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    calls, samples = set(), set()

    def record(qkv_t, num_heads, scale=None, bias=None):  # no attention computed: zeros
        B, ZC, N = qkv_t.shape
        kernel = ("K1" if bias is not None else "K9") if N <= tfa._WINDOW_MAX_N else "K2"
        calls.add((kernel, B * cs.MICRO_BATCH, ZC // 3, N, num_heads))
        return qkv_t.new_zeros(B, ZC // 3, N)

    def sample(kernel, B, C, shapes, loc):
        Q, H, _, P = loc.shape[1:5]
        samples.add((kernel, (B * cs.MICRO_BATCH, H, C // H, P, Q, tuple(map(tuple, shapes)))))

    def panels(vals, shapes, loc, weights):  # vals[l] (B, H, H_l, W_l D)
        C = vals[0].shape[1] * vals[0].shape[-1] // shapes[0][1]
        sample("K4", loc.shape[0], C, shapes, loc)
        return loc.new_zeros(*loc.shape[:2], C)

    def cm(value_t, shapes, loc, weights, H):
        sample("K3", value_t.shape[0], value_t.shape[1], shapes, loc)
        return value_t.new_zeros(value_t.shape[0], value_t.shape[1], loc.shape[1])

    def shape_set(table):
        return {tuple(e[1:6]) for e in table}

    def sep_set(kernel, table):
        return {(kernel, (B, H, D, P, Q, tuple(map(tuple, shapes))))
                for _, (B, H, D, P, Q, shapes) in table}

    fwd = shape_set(cs.ATTENTION_SHAPES + cs.CLI_ATTENTION_SHAPES)
    bwd = shape_set(cs.ATTENTION_BWD_SHAPES + cs.CLI_ATTENTION_BWD_SHAPES)
    dec, dec_bwd = (shape_set(cs.VARIANT_CLI_DRAWN_ATTENTION),
                    shape_set(cs.VARIANT_CLI_DRAWN_ATTENTION_BWD))
    sep = sep_set("K4", cs.VARIANT_CLI_DRAWN_SEP)
    backward = {"K1": "K7", "K2": "K6", "K9": "K7nb"}
    seen = {"dec": set(), "dec_bwd": set(), "sep": set()}
    patches = (mock.patch.object(tfa, "attention_cm", record),
               mock.patch.object(tda, "ms_deform_attn_sep_panels", panels),
               mock.patch.object(tda, "ms_deform_attn_cm", cm))
    with patches[0], patches[1], patches[2], torch.no_grad():
        for size in cs.VARIANT_CLI_SIZES:
            calls.clear()
            samples.clear()
            model.train()(torch.zeros(1, size, size, 3))
            assert calls <= fwd | dec, size
            back = {(backward[k], *rest) for k, *rest in calls}
            assert back <= bwd | dec_bwd, size
            assert samples <= sep and len(samples) == 1, size
            seen["dec"] |= calls & dec
            seen["dec_bwd"] |= back & dec_bwd
            seen["sep"] |= samples
        calls.clear()
        samples.clear()
        model.eval()(torch.zeros(1, 640, 640, 3))
    assert seen == {"dec": dec, "dec_bwd": dec_bwd, "sep": sep}
    assert calls == shape_set([e for e in cs.ATTENTION_SHAPES if "@micro" in e[0]]), calls
    assert samples == {("K3", (*cs.SEP_MICRO[:5], tuple(cs.SEP_MICRO[5])))}


def test_chip_smoke_checks_the_kernels_at_each_orbax_cli_size():
    """The resumed train CLI's size table (`orbax_phase` (c)) is what the
    square recipe draws from the fixture at batch 4 and the CLI's default
    seed in epoch 1, where a resume from the orbax fixture's step 5 starts. At
    each size the micro model (chip_smoke.MICRO_FLAGS) in train mode calls
    attention at shapes of the kernel phase's tables (its ViT) or of
    VARIANT_CLI_DRAWN_ATTENTION (its decoder), with their backwards in the
    backward tables, and the sampler at the size's ORBAX_CLI_DRAWN_SEP entry;
    every entry of ORBAX_CLI_DRAWN_SEP is drawn."""
    import chip_smoke as cs
    from lwdetr_tpu_torch import main as cli

    seed = cli.parser().parse_args([]).seed
    sizes = _loader_sizes("tests/fixtures/micro_map", True, seed, square=True,
                          epoch=cs.ORBAX_STEP // cs.CLI_STEPS)
    assert len(sizes) == cs.CLI_STEPS and all(h == w for h, w in sizes)
    assert sorted({h for h, _ in sizes}) == sorted(cs.ORBAX_CLI_SIZES)
    cfg = cli.config_from_args(cli.parser().parse_args(["--coco_path", "x",
                                                        *cs.MICRO_FLAGS])).model
    model = port_model.build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    calls, samples = set(), set()

    def record(qkv_t, num_heads, scale=None, bias=None):  # no attention computed: zeros
        B, ZC, N = qkv_t.shape
        kernel = ("K1" if bias is not None else "K9") if N <= tfa._WINDOW_MAX_N else "K2"
        calls.add((kernel, B * cs.MICRO_BATCH, ZC // 3, N, num_heads))
        return qkv_t.new_zeros(B, ZC // 3, N)

    def panels(vals, shapes, loc, weights):
        B, Q, H, _, P = loc.shape[:5]
        C = vals[0].shape[1] * vals[0].shape[-1] // shapes[0][1]
        samples.add((B * cs.MICRO_BATCH, H, C // H, P, Q, tuple(map(tuple, shapes))))
        return loc.new_zeros(*loc.shape[:2], C)

    def shape_set(table):
        return {tuple(e[1:6]) for e in table}

    fwd = shape_set(cs.ATTENTION_SHAPES + cs.CLI_ATTENTION_SHAPES + cs.VARIANT_CLI_DRAWN_ATTENTION)
    bwd = shape_set(cs.ATTENTION_BWD_SHAPES + cs.CLI_ATTENTION_BWD_SHAPES
                    + cs.VARIANT_CLI_DRAWN_ATTENTION_BWD)
    sep = {(B, H, D, P, Q, tuple(map(tuple, shapes)))
           for _, (B, H, D, P, Q, shapes) in cs.ORBAX_CLI_DRAWN_SEP}
    backward = {"K1": "K7", "K2": "K6", "K9": "K7nb"}
    seen = set()
    with mock.patch.object(tfa, "attention_cm", record), \
            mock.patch.object(tda, "ms_deform_attn_sep_panels", panels), torch.no_grad():
        for size in cs.ORBAX_CLI_SIZES:
            calls.clear()
            samples.clear()
            model.train()(torch.zeros(1, size, size, 3))
            assert calls <= fwd, (size, calls - fwd)
            assert {(backward[k], *rest) for k, *rest in calls} <= bwd, size
            assert samples <= sep and len(samples) == 1, (size, samples)
            seen |= samples
    assert seen == sep


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
