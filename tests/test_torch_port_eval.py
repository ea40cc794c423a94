"""The port's eval entry point against the JAX package's, on the CPU.

* The port's `CocoEvaluator` (`lwdetr_tpu_torch/data/coco_eval.py`) gives the
  JAX evaluator's 12 stats exactly (`==`, tolerance none) on the same
  detections: every case of `tests/test_coco_eval.py`,
  `tests/test_coco_eval_golden.py` and `tests/test_coco_eval_oracle.py` (through
  `tests/cocoeval_oracle.py`), run with the evaluator of those modules
  replaced by a twin that feeds both and compares them, and the fixture's
  detections.
* The port's whole eval pipeline in f32 (fixture dir -> loader -> eval step
  -> `evaluate` -> evaluator) on the fixture's weights, read with
  `weights.read_jax_npz`, gives `golden_stats.json` within 1e-7 (the JAX
  package's own bound, `tests/test_micro_map_golden.py`), as does the CLI
  `python -m lwdetr_tpu_torch.main --eval --device cpu --resume X.pth`, with
  and without `--use_ema`.
* `.pth` loading and `evaluate`'s rules.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_coco_eval
import test_coco_eval_golden
import test_coco_eval_oracle
from lwdetr_tpu.data import coco_eval as jeval
from lwdetr_tpu_torch import main as cli
from lwdetr_tpu_torch.data import coco_eval as peval
from lwdetr_tpu_torch.data.coco import CocoDetection
from lwdetr_tpu_torch.data.loader import DetectionLoader, to_device
from lwdetr_tpu_torch.models.lwdetr import build_model
from lwdetr_tpu_torch.train import checkpoint as ckpt
from lwdetr_tpu_torch.train import engine
from lwdetr_tpu_torch.weights import read_jax_npz, state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures", "micro_map")
GOLDEN_ATOL = 1e-7  # the JAX package's bound on the same golden
# the micro model of tests/micro_map_common.py:30-40, as CLI flags
MICRO_FLAGS = ("--encoder vit_tiny --vit_encoder_num_layers 2 --window_block_indexes 0 "
               "--out_feature_indexes 0 1 --projector_scale P4 --hidden_dim 64 "
               "--dim_feedforward 128 --sa_nheads 4 --ca_nheads 8 --dec_n_points 2 "
               "--dec_layers 2 --group_detr 2 --num_queries 12 --num_select 10 --two_stage "
               "--lite_refpoint_refine --bbox_reparam --square_resize_div_64 --max_gt 10").split()

with open(os.path.join(FIXDIR, "golden_stats.json")) as _f:
    GOLDEN = json.load(_f)["stats"]


def _micro_args(*extra):
    return cli.parser().parse_args(["--eval", "--device", "cpu", "--coco_path", FIXDIR,
                                    *MICRO_FLAGS, "--batch_size", "4", "--dont_bench", *extra])


@pytest.fixture(scope="module")
def micro():
    """(model config, state_dict) of the fixture's weights."""
    cfg = cli.config_from_args(_micro_args()).model
    tree = read_jax_npz(os.path.join(FIXDIR, "weights.npz"))
    return cfg, state_dict_from_jax(tree["params"], tree.get("batch_stats"), cfg)


@pytest.fixture(scope="module")
def pipeline(micro):
    """Loader -> eval step -> `evaluate`, f32 on the CPU, batch 4 (the
    golden's); returns (stats, the detections of each image)."""
    cfg, sd = micro
    model = build_model(cfg, device="cpu", state_dict=sd)
    ds = CocoDetection(os.path.join(FIXDIR, "val2017"),
                       os.path.join(FIXDIR, "annotations", "instances_val2017.json"))
    loader = DetectionLoader(ds, batch_size=4, train=False, max_gt=10, square_div_64=True,
                             num_workers=2)
    ev = peval.CocoEvaluator(ds.coco)
    dets = {}
    update = ev.update

    def keep(results):
        dets.update(results)
        update(results)

    ev.update = keep
    stats = engine.evaluate(engine.build_eval_step(model, cfg.num_select), loader, ev,
                            put_fn=lambda b: to_device(b, "cpu"), logger=lambda s: None)
    return stats, dets


def assert_golden(stats):
    assert set(GOLDEN) <= set(stats)
    for k in sorted(GOLDEN):
        np.testing.assert_allclose(stats[k], GOLDEN[k], atol=GOLDEN_ATOL, rtol=0,
                                   err_msg=f"stat {k}: {stats[k]} vs golden {GOLDEN[k]}")


# -- (b) the evaluator, exactly the JAX package's ------------------------------------------------


class TwinEvaluator:
    """Feeds the JAX and the port's evaluators alike; `summarize` asserts
    that their 12 stats and precision / recall tables are equal (`==`)."""

    summaries = 0

    def __init__(self, coco_gt, cat_ids=None):
        self.jax = jeval.CocoEvaluator(coco_gt, cat_ids)
        self.port = peval.CocoEvaluator(coco_gt, cat_ids)

    def update(self, results):
        self.jax.update(results)
        self.port.update(results)

    def export(self):
        return self.jax.export(), self.port.export()

    def merge(self, exported):
        self.jax.merge(exported[0])
        self.port.merge(exported[1])

    def summarize(self, verbose=True):
        theirs = self.jax.summarize(verbose=False)
        ours = self.port.summarize(verbose=False)
        assert ours == theirs
        for k in ("precision", "recall"):
            np.testing.assert_array_equal(self.port.eval[k], self.jax.eval[k])
        TwinEvaluator.summaries += 1
        return theirs


def _twin_iou(dt, gt, iscrowd):
    theirs = jeval.iou_xywh(dt, gt, iscrowd)
    np.testing.assert_array_equal(peval.iou_xywh(dt, gt, iscrowd), theirs)
    TwinEvaluator.summaries += 1
    return theirs


EVAL_MODULES = (test_coco_eval, test_coco_eval_golden, test_coco_eval_oracle)
EVAL_CASES = [(m.__name__, name, ()) for m in EVAL_MODULES for name in sorted(vars(m))
              if name.startswith("test_") and name != "test_fuzz_parity_with_oracle"]
EVAL_CASES += [("test_coco_eval_oracle", "test_fuzz_parity_with_oracle", (seed,))
               for seed in range(25)]


@pytest.mark.parametrize("module,name,args", EVAL_CASES,
                         ids=[f"{m}::{n}{list(a) if a else ''}" for m, n, a in EVAL_CASES])
def test_evaluator_equals_the_jax_evaluator_on_every_case(module, name, args, monkeypatch):
    mod = sys.modules[module]
    monkeypatch.setattr(mod, "CocoEvaluator", TwinEvaluator)
    if hasattr(mod, "iou_xywh"):
        monkeypatch.setattr(mod, "iou_xywh", _twin_iou)
    before = TwinEvaluator.summaries
    getattr(mod, name)(*args)
    assert TwinEvaluator.summaries > before, "the case compared nothing"


def test_evaluator_equals_the_jax_evaluator_on_the_fixtures_detections(pipeline):
    _, dets = pipeline
    ds = CocoDetection(os.path.join(FIXDIR, "val2017"),
                       os.path.join(FIXDIR, "annotations", "instances_val2017.json"))
    twin = TwinEvaluator(ds.coco)
    twin.update(dets)
    stats = twin.summarize()
    assert len(dets) == 20 and stats == {k: pipeline[0][k] for k in stats}


# -- (c) the pipeline, held to the golden ------------------------------------------------------


def test_the_fixture_pipeline_gives_the_golden_stats(pipeline):
    stats, dets = pipeline
    assert sorted(dets) == list(range(1, 21))  # the padded duplicates skipped
    assert all(d["scores"].shape == (10,) and d["boxes"].shape == (10, 4) for d in dets.values())
    assert_golden(stats)
    # the fixture stays informative: most stats strictly inside (0, 1)
    assert len([k for k, v in GOLDEN.items() if 0.02 < v < 0.98]) >= 10


def test_the_npz_reader_reads_every_key_path(micro):
    cfg, sd = micro
    tree = read_jax_npz(os.path.join(FIXDIR, "weights.npz"))
    with np.load(os.path.join(FIXDIR, "weights.npz")) as data:
        assert all(data[k].dtype == np.float16 for k in data.files)
        for key in data.files:
            node = tree
            for part in key[2:-2].split("']['"):
                node = node[part]
            assert node.dtype == np.float32
            np.testing.assert_array_equal(node, data[key].astype(np.float32))
    build_model(cfg, device="cpu", state_dict=sd)  # every key and shape, strictly


def test_the_npz_reader_refuses_a_key_that_is_no_path(tmp_path):
    np.savez(tmp_path / "w.npz", **{"['params']['a']": np.zeros(2), "params.b": np.zeros(1)})
    with pytest.raises(ValueError, match="not a key path"):
        read_jax_npz(str(tmp_path / "w.npz"))


# -- (d) the CLI ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def micro_pth(micro, tmp_path_factory):
    """The fixture's weights as a reference .pth with DDP prefixes, an EMA
    entry (the same weights) and an epoch."""
    _, sd = micro
    path = tmp_path_factory.mktemp("pth") / "micro.pth"
    torch.save({"model": {"module." + k: v for k, v in sd.items()}, "ema_model": sd,
                "epoch": 4}, path)
    return str(path)


@pytest.mark.parametrize("use_ema", [False, True], ids=["model", "use_ema"])
def test_the_cli_eval_gives_the_golden_stats(use_ema, micro_pth, tmp_path):
    """The model's run also runs the startup self-benchmark, as the CLI does by
    default (its report before the stats); the EMA's passes `--dont_bench`."""
    cmd = [sys.executable, "-m", "lwdetr_tpu_torch.main", "--eval", "--device", "cpu",
           "--coco_path", FIXDIR, *MICRO_FLAGS, "--batch_size", "4", "--resume", micro_pth,
           "--output_dir", str(tmp_path), *(["--use_ema", "--dont_bench"] if use_ema else [])]
    # two threads: the suite's workers share the machine's cores, and PyTorch's
    # default of one thread a core makes the bench's many small operations contend
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    bench = [ln for ln in proc.stdout.splitlines() if ln.startswith("benchmark: ")]
    assert len(bench) == (0 if use_ema else 1), bench
    if not use_ema:
        assert "M params" in bench[0] and "GFLOPs/img" in bench[0] and "img/s" in bench[0]
        assert "gemm" in proc.stdout and "backbone/encoder" in proc.stdout
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert_golden(stats)
    assert "loss" in stats and np.isfinite(stats["loss"])  # the eval losses, metered
    assert "(epoch 4)" in proc.stdout
    record = json.loads((tmp_path / "log.txt").read_text().splitlines()[-1])
    assert_golden({k[len("test_"):]: v for k, v in record.items() if k.startswith("test_")})
    if use_ema:
        assert proc.stdout.count("EMA eval:") == 1
        assert_golden({k[len("ema_test_"):]: v for k, v in record.items()
                       if k.startswith("ema_test_")})
    else:
        assert not any(k.startswith("ema_") for k in record)


def test_the_cli_runs_on_the_card_unless_asked(monkeypatch, micro_pth):
    args = cli.parser().parse_args(["--eval", "--coco_path", FIXDIR, *MICRO_FLAGS,
                                    "--resume", micro_pth])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)


def test_presets_take_the_release_recipe_and_the_cli_data_flags():
    args = cli.parser().parse_args(["--preset", "large", "--coco_path", "/d", "--num_workers",
                                    "5", "--dataset_file", "o365"])
    cfg = cli.config_from_args(args)
    assert cfg.model.hidden_dim == 384 and cfg.model.num_classes == 366
    assert cfg.data.square_resize_div_64 and cfg.data.num_workers == 5
    assert cfg.data.coco_path == "/d" and cfg.train.batch_size == 2


# -- checkpoints and evaluate ---------------------------------------------------------------------


def test_resume_pth_loads_strictly_and_takes_the_ema_weights(micro, tmp_path):
    cfg, sd = micro
    ema_sd = {k: v + 1 if v.is_floating_point() else v for k, v in sd.items()}
    path = tmp_path / "x.pth"
    torch.save({"model": sd, "ema_model": ema_sd, "epoch": 2}, path)
    model = build_model(cfg, device="cpu")
    ema, start = ckpt.resume_pth(model, str(path), use_ema=True)
    assert start == 3
    assert all(torch.equal(model.state_dict()[k], sd[k]) for k in sd)
    assert all(torch.equal(ema[k], ema_sd[k]) for k in sd)
    assert ckpt.resume_pth(model, str(path), use_ema=False) == (None, 3)
    torch.save({"model": {k: v for k, v in sd.items() if "class_embed" not in k}}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        ckpt.resume_pth(model, str(path), use_ema=False)


def test_pretrain_weights_exclude_and_remap(micro, tmp_path):
    cfg, sd = micro
    model = build_model(cfg, device="cpu", state_dict=sd)
    pre = {k: torch.zeros_like(v) for k, v in sd.items()}
    pre["class_embed.weight"] = torch.arange(366 * 64, dtype=torch.float32).reshape(366, 64)
    pre["class_embed.bias"] = torch.ones(5)  # another shape: not loaded
    torch.save({"model": pre}, tmp_path / "p.pth")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n = ckpt.load_pretrain_weights(model, str(tmp_path / "p.pth"),
                                   exclude_keys=["refpoint_embed.weight"],
                                   keys_modify_to_load=["class_embed.weight"])
    now = model.state_dict()
    assert n == len(sd) - 2
    assert torch.equal(now["refpoint_embed.weight"], before["refpoint_embed.weight"])
    assert torch.equal(now["class_embed.bias"], before["class_embed.bias"])
    assert torch.equal(now["class_embed.weight"][1], pre["class_embed.weight"][1])  # person
    assert torch.equal(now["class_embed.weight"][12], before["class_embed.weight"][12])  # no class
    assert torch.count_nonzero(now["backbone.0.encoder.blocks.0.mlp.fc1.weight"]) == 0


def test_pretrained_encoder_loads_only_the_encoder(micro, tmp_path):
    cfg, sd = micro
    model = build_model(cfg, device="cpu", state_dict=sd)
    enc = {"encoder." + k[len(ckpt.ENCODER_PREFIX):]: torch.zeros_like(v)
           for k, v in sd.items() if k.startswith(ckpt.ENCODER_PREFIX)}
    enc["head.weight"] = torch.zeros(3)  # a pretraining head the detector lacks
    torch.save({"model": enc}, tmp_path / "cae.pth")
    n = ckpt.load_pretrained_encoder(str(tmp_path / "cae.pth"), model)
    assert n == len(enc) - 1
    now = model.state_dict()
    assert all(torch.count_nonzero(now[k]) == 0 for k in sd if k.startswith(ckpt.ENCODER_PREFIX))
    assert torch.equal(now["class_embed.weight"], sd["class_embed.weight"])


def test_one_process_merge_leaves_the_evaluator_as_it_is(pipeline):
    """With one process `merge_evaluators` gathers nothing: the evaluator, its
    detections and its stats are those it had (the merge across processes is
    `test_torch_port_dist.py`'s two-process eval CLI)."""
    stats, dets = pipeline
    ds = CocoDetection(os.path.join(FIXDIR, "val2017"),
                       os.path.join(FIXDIR, "annotations", "instances_val2017.json"))
    evaluator = peval.CocoEvaluator(ds.coco)
    evaluator.update(dets)
    before = evaluator.export()
    assert engine.merge_evaluators(evaluator) is evaluator
    assert evaluator.export() == before
    merged = evaluator.summarize(verbose=False)
    assert {k: merged[k] for k in GOLDEN} == {k: stats[k] for k in GOLDEN}


# -- (f) per-image detections against the JAX pipeline ------------------------------------------


@pytest.mark.slow
def test_per_image_detections_equal_the_jax_pipelines(pipeline):
    """Every image's 10 detections against `micro_map_common.run_pipeline(
    collect_dets=True)` on the same weights (the JAX attention in interpret
    mode): the same labels in the same order, scores within 1e-6 and boxes
    within 1e-6 of the image's largest box coordinate (f32 sums in another
    order; measured 3.1e-7 and 1.0e-7 on the CPU)."""
    from micro_map_common import build_micro, load_weights, run_pipeline

    _, ours = pipeline
    _cfg, _model, init_vars = build_micro(seed=0)
    variables = load_weights(init_vars, os.path.join(FIXDIR, "weights.npz"))
    theirs, _ = run_pipeline(FIXDIR, variables=variables, collect_dets=True)
    assert sorted(theirs) == sorted(ours)
    worst = {"scores": 0.0, "boxes": 0.0}
    for img_id, t in theirs.items():
        o = ours[img_id]
        np.testing.assert_array_equal(o["labels"], np.asarray(t["labels"]))
        worst["scores"] = max(worst["scores"], float(np.abs(o["scores"] - t["scores"]).max()))
        size = float(np.abs(np.asarray(t["boxes"])).max())
        worst["boxes"] = max(worst["boxes"],
                             float(np.abs(o["boxes"] - t["boxes"]).max()) / size)
    print(f"per-image detections, port vs JAX: {worst}")
    assert worst["scores"] <= 1e-6 and worst["boxes"] <= 1e-6, worst
