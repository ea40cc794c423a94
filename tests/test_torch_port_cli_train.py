"""Training through the port's CLI, its checkpoints and its demo, on the CPU.

* `python -m lwdetr_tpu_torch.main` (no `--eval`) on the micro model
  (`MICRO_FLAGS`) over a COCO dir whose `train2017` and `val2017` are 8 of the
  mAP fixture's images, 2 epochs at batch 4 with EMA: a straight run and a run
  resumed from its epoch-0 save end with bit-equal model, optimizer, schedule
  and EMA state; the log records carry the JAX CLI's keys (root
  `main.py:473-493`); the checkpoint directories keep the JAX CLI's layout.
* Save / restore of a train state round-trips every tensor and the step bit
  for bit; retention keeps 3, all and 1 a directory; the JAX package's
  `load_pth` reads a port-saved `.pth` into the fixture's own parameters.
* `python -m lwdetr_tpu_torch.demo` writes the image, prints the count, and
  its detections equal `build_eval_step`'s on the same image.
"""
import json
import os
import signal
from unittest import mock

import numpy as np
import pytest
import torch

from lwdetr_tpu.train import checkpoint as jckpt
from lwdetr_tpu_torch import demo
from lwdetr_tpu_torch import main as cli
from lwdetr_tpu_torch.data import transforms as T
from lwdetr_tpu_torch.train import checkpoint as ckpt
from lwdetr_tpu_torch.train import engine
from lwdetr_tpu_torch.weights import read_jax_npz, state_dict_from_jax
from micro_map_common import micro_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures", "micro_map")
MICRO_FLAGS = ("--encoder vit_tiny --vit_encoder_num_layers 2 --window_block_indexes 0 "
               "--out_feature_indexes 0 1 --projector_scale P4 --hidden_dim 64 "
               "--dim_feedforward 128 --sa_nheads 4 --ca_nheads 8 --dec_n_points 2 "
               "--dec_layers 2 --group_detr 2 --num_queries 12 --num_select 10 --two_stage "
               "--lite_refpoint_refine --bbox_reparam --square_resize_div_64 --max_gt 10").split()
IMAGES = 8  # the fixture's first 8 images (its smallest JPEGs), as train and val
STEPS_PER_EPOCH = 2  # 8 images, batch 4
STATS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100", "ARs", "ARm", "ARl")


def _train_args(coco, out, *extra):
    return cli.parser().parse_args(
        ["--device", "cpu", "--coco_path", coco, *MICRO_FLAGS, "--batch_size", "4",
         "--epochs", "2", "--use_ema", "--checkpoint_interval", "1", "--output_dir", out,
         "--dont_bench", *extra])


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A COCO-format dir whose train and val splits are the fixture's first
    IMAGES images and their annotations."""
    root = tmp_path_factory.mktemp("coco")
    (root / "annotations").mkdir()
    with open(os.path.join(FIXDIR, "annotations", "instances_val2017.json")) as f:
        ann = json.load(f)
    keep = sorted(im["id"] for im in ann["images"])[:IMAGES]
    ann["images"] = [im for im in ann["images"] if im["id"] in keep]
    ann["annotations"] = [a for a in ann["annotations"] if a["image_id"] in keep]
    for split in ("train2017", "val2017"):
        os.symlink(os.path.join(FIXDIR, "val2017"), root / split)
        (root / "annotations" / f"instances_{split}.json").write_text(json.dumps(ann))
    return str(root)


@pytest.fixture(scope="module")
def runs(coco, tmp_path_factory):
    """The straight 2-epoch run, and a run resumed from its epoch-0 save."""
    out = str(tmp_path_factory.mktemp("straight"))
    straight = cli.main(_train_args(coco, out))
    resumed_out = str(tmp_path_factory.mktemp("resumed"))
    epoch0 = os.path.join(out, "ckpt", f"{STEPS_PER_EPOCH}.pth")
    resumed = cli.main(_train_args(coco, resumed_out, "--resume", epoch0))
    return {"out": out, "straight": straight, "resumed_out": resumed_out, "resumed": resumed}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _optimizer_equal(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return (sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
            and all(_equal(sa["state"][i], sb["state"][i]) for i in sa["state"]))


def _states_equal(s1, s2) -> bool:
    return (s1.step == s2.step and _equal(s1.model.state_dict(), s2.model.state_dict())
            and _optimizer_equal(s1.optimizer, s2.optimizer)
            and s1.scheduler.state_dict() == s2.scheduler.state_dict()
            and (s1.ema is None) == (s2.ema is None)
            and (s1.ema is None or _equal(s1.ema, s2.ema)))


# -- the train CLI ------------------------------------------------------------------------------------


def test_a_resumed_run_ends_bit_equal_to_the_straight_run(runs):
    straight, resumed = runs["straight"], runs["resumed"]
    assert straight["epochs"] == [0, 1] and resumed["epochs"] == [1]
    s1, s2 = straight["state"], resumed["state"]
    assert s1.step == s2.step == 2 * STEPS_PER_EPOCH
    assert _equal(s1.model.state_dict(), s2.model.state_dict())
    assert _optimizer_equal(s1.optimizer, s2.optimizer)
    assert s1.scheduler.state_dict() == s2.scheduler.state_dict()
    assert _equal(s1.ema, s2.ema)
    # and the training moved the weights, and the EMA off them
    first = torch.load(os.path.join(runs["out"], "ckpt", f"{STEPS_PER_EPOCH}.pth"),
                       weights_only=False)
    assert not _equal(first["model"], {k: v for k, v in s1.model.state_dict().items()})
    assert not _equal(s1.ema, s1.model.state_dict())
    assert straight["stats"] == resumed["stats"] and straight["ema_stats"] == resumed["ema_stats"]


def test_the_log_records_carry_the_jax_cli_keys(runs):
    with open(os.path.join(runs["out"], "log.txt")) as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [0, 1]
    for r in records:
        assert {"epoch", "best_regular", "best_ema", "train_loss", "train_grad_norm",
                "train_epoch_time", "test_loss"} <= set(r)
        assert {f"test_{k}" for k in STATS} | {f"ema_test_{k}" for k in STATS} <= set(r)
        others = set(r) - {"epoch", "best_regular", "best_ema"}
        assert all(k.startswith(("train_", "test_", "ema_test_")) for k in others)
        assert all(np.isfinite(v) for v in r.values())
        assert r["best_regular"] >= r["test_AP"] and r["best_ema"] >= r["ema_test_AP"]
    with open(os.path.join(runs["resumed_out"], "log.txt")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [1]


def test_the_checkpoint_dirs_follow_the_jax_clis_layout(runs):
    out = runs["out"]
    assert ckpt.checkpoint_keys(os.path.join(out, "ckpt")) == [STEPS_PER_EPOCH,
                                                                2 * STEPS_PER_EPOCH]
    assert ckpt.checkpoint_keys(os.path.join(out, "ckpt_epochs")) == [0, 1]
    assert len(ckpt.checkpoint_keys(os.path.join(out, "ckpt_best_regular"))) == 1
    assert len(ckpt.checkpoint_keys(os.path.join(out, "ckpt_best_ema"))) == 1
    assert not [n for d in os.listdir(out) if os.path.isdir(os.path.join(out, d))
                for n in os.listdir(os.path.join(out, d)) if n.endswith(".tmp")]
    with np.load(os.path.join(out, "eval", "latest.npz")) as ev:
        assert int(ev["epoch"]) == 1 and {"precision", "recall"} <= set(ev.files)
    last = torch.load(os.path.join(out, "ckpt", f"{2 * STEPS_PER_EPOCH}.pth"), weights_only=False)
    assert {"model", "optimizer", "lr_scheduler", "ema_model", "epoch", "step", "args"} <= set(last)
    assert last["epoch"] == 1 and last["step"] == 2 * STEPS_PER_EPOCH
    assert last["args"]["epochs"] == 2


def test_eval_resumes_from_the_ports_checkpoint_directory(runs, coco):
    """`--eval --resume out/ckpt` reads the latest file and its EMA: the
    stats of the training run's last eval, exactly."""
    args = cli.parser().parse_args(["--eval", "--device", "cpu", "--coco_path", coco,
                                    *MICRO_FLAGS, "--batch_size", "4", "--use_ema",
                                    "--resume", os.path.join(runs["out"], "ckpt"),
                                    "--output_dir", "", "--dont_bench"])
    out = cli.main(args)
    assert out["stats"] == runs["straight"]["stats"]
    assert out["ema_stats"] == runs["straight"]["ema_stats"]


def test_sigterm_finishes_the_step_saves_and_exits(coco, tmp_path):
    """The signal arrives during step 1: that step completes, the state is
    saved at step 2 after the loop drains, and no epoch is logged."""
    build = engine.build_train_step

    def build_signalling(state, *a, **kw):
        step = build(state, *a, **kw)

        def signalling(*sa, **skw):
            metrics = step(*sa, **skw)
            if state.step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return metrics

        return signalling

    with mock.patch.object(engine, "build_train_step", build_signalling):
        out = cli.main(_train_args(coco, str(tmp_path)))
    assert out["epochs"] == [] and out["state"].step == 1
    assert ckpt.checkpoint_keys(str(tmp_path / "ckpt")) == [1]
    assert not (tmp_path / "log.txt").exists()
    assert signal.getsignal(signal.SIGTERM) is not None  # the handler was put back


def test_train_flags_override_a_presets_recipe():
    args = cli.parser().parse_args(["--preset", "small", "--coco_path", "/d", "--epochs", "2",
                                    "--batch_size", "8", "--output_dir", "o"])
    cfg = cli.config_from_args(args)
    assert cfg.train.epochs == 2 and cfg.train.batch_size == 8 and cfg.output_dir == "o"
    assert cfg.train.use_ema and cfg.train.ia_bce_loss and cfg.train.lr_drop == 60
    cfg = cli.config_from_args(cli.parser().parse_args(["--preset", "small"]))
    assert cfg.train.epochs == 60 and cfg.train.batch_size == 4
    # a flag given at its parser default (epochs 12, batch 2) overrides the recipe too
    for flags, want in ((["--epochs", "12"], (12, 4)), (["--batch_size", "2"], (60, 2))):
        cfg = cli.config_from_args(cli.parser().parse_args(["--preset", "small", *flags]))
        assert (cfg.train.epochs, cfg.train.batch_size) == want, flags


def test_the_train_cli_runs_on_the_card_unless_asked(monkeypatch, coco, tmp_path):
    args = cli.parser().parse_args(["--coco_path", coco, *MICRO_FLAGS,
                                    "--output_dir", str(tmp_path)])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)


# -- save and restore -----------------------------------------------------------------------------


def _micro_state(seed=0, use_ema=True):
    args = cli.parser().parse_args(["--device", "cpu", *MICRO_FLAGS])
    cfg = cli.config_from_args(args)
    tcfg = cfg.train.__class__(**{**cfg.train.__dict__, "use_ema": use_ema})
    torch.manual_seed(seed)
    return engine.create_train_state(cfg.model, tcfg, niter_per_ep=3, device="cpu"), cfg, tcfg


def _stepped_state(steps=2):
    from lwdetr_tpu_torch.bench_train import synthetic_batch
    from lwdetr_tpu_torch.models.criterion import SetCriterion

    state, cfg, tcfg = _micro_state()
    step = engine.build_train_step(state, SetCriterion(cfg.model, tcfg), tcfg,
                                   static_zero_drop_path=True, static_zero_dropout=True)
    batch = synthetic_batch(cfg.model.num_classes, 2, 128, tcfg.max_gt, 3, "cpu", seed=1)
    for _ in range(steps):
        step(batch)
    return state, step, batch


def test_save_restore_round_trips_every_tensor_and_the_step(tmp_path):
    state, _, _ = _stepped_state()
    path = ckpt.save_checkpoint(str(tmp_path / "ckpt"), state.step, state, epoch=0)
    fresh, _, _ = _micro_state(seed=1)
    assert not _equal(fresh.model.state_dict(), state.model.state_dict())
    assert ckpt.restore_checkpoint(str(tmp_path / "ckpt"), fresh) == state.step == 2
    assert _states_equal(state, fresh)
    # BatchNorm statistics and AdamW's moments are among what came back
    assert any("running_var" in k for k in fresh.model.state_dict())
    assert all({"exp_avg", "exp_avg_sq", "step"} <= set(s)
               for s in fresh.optimizer.state_dict()["state"].values())
    assert ckpt.restore_checkpoint(path, fresh) == 2  # a file as well as a directory


def test_a_restored_state_steps_on_as_the_original(tmp_path):
    from lwdetr_tpu_torch.models.criterion import SetCriterion

    state, step, batch = _stepped_state()
    ckpt.save_checkpoint(str(tmp_path), state.step, state, epoch=0)
    fresh, cfg, tcfg = _micro_state(seed=1)
    ckpt.restore_checkpoint(str(tmp_path), fresh)
    step2 = engine.build_train_step(fresh, SetCriterion(cfg.model, tcfg), tcfg,
                                    static_zero_drop_path=True, static_zero_dropout=True)
    m1, m2 = step(batch), step2(batch)
    assert torch.equal(m1["loss"], m2["loss"])
    assert _states_equal(state, fresh)


@pytest.mark.parametrize("sub", sorted(ckpt.KEEP))
def test_retention_keeps_what_the_jax_cli_keeps(tmp_path, sub):
    state, _, _ = _micro_state(use_ema=False)
    for key in (3, 1, 7, 5, 9):
        ckpt.save_checkpoint(str(tmp_path / sub), key, state, epoch=key, keep=ckpt.KEEP[sub])
    kept = ckpt.checkpoint_keys(str(tmp_path / sub))
    expect = {"ckpt": [5, 7, 9], "ckpt_epochs": [1, 3, 5, 7, 9], "ckpt_best_regular": [9],
              "ckpt_best_ema": [9]}[sub]
    assert kept == expect
    assert ckpt.checkpoint_file(str(tmp_path / sub)).endswith("9.pth")
    assert sorted(os.listdir(tmp_path / sub)) == sorted(f"{k}.pth" for k in expect)


def test_the_jax_package_reads_a_port_saved_pth(tmp_path):
    """The fixture's JAX weights -> the port's train state -> a port save ->
    `lwdetr_tpu.train.checkpoint.load_pth`: the fixture's parameters and
    BatchNorm statistics, bit for bit."""
    tree = read_jax_npz(os.path.join(FIXDIR, "weights.npz"))
    state, cfg, _ = _micro_state()
    state.model.load_state_dict(state_dict_from_jax(tree["params"], tree.get("batch_stats"),
                                                    cfg.model))
    path = ckpt.save_checkpoint(str(tmp_path), 0, state, epoch=0)
    variables = jckpt.load_pth(path, micro_config())

    def leaves(t, prefix=""):
        for k, v in t.items():
            yield from (leaves(v, f"{prefix}/{k}") if isinstance(v, dict) else [(prefix + "/" + k, v)])

    for coll in ("params", "batch_stats"):
        want, got = dict(leaves(tree[coll])), dict(leaves(variables[coll]))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def test_restore_refuses_a_file_without_a_train_state(tmp_path):
    state, _, _ = _micro_state(use_ema=False)
    torch.save({"model": state.model.state_dict()}, tmp_path / "weights.pth")
    with pytest.raises(ValueError, match="no train state"):
        ckpt.restore_checkpoint(str(tmp_path / "weights.pth"), state)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ckpt.checkpoint_file(str(tmp_path / "empty"))


# -- the demo -----------------------------------------------------------------------------------


def test_the_demo_draws_counts_and_matches_the_eval_step(runs, tmp_path, capsys):
    image = os.path.join(FIXDIR, "val2017", sorted(os.listdir(os.path.join(FIXDIR, "val2017")))[1])
    out_img = str(tmp_path / "demo.jpg")
    got = demo.main(["--image", image, "--checkpoint", os.path.join(runs["out"], "ckpt"),
                     "--device", "cpu", "--output", out_img, "--threshold", "0.05", "--ema"])
    printed = capsys.readouterr().out
    assert os.path.getsize(out_img) > 0
    assert f"{got['kept']} detections >= 0.05 -> {out_img}" in printed
    assert got["kept"] == int((got["scores"] >= 0.05).sum()) and got["scores"].shape == (10,)

    # the same weights (the latest save's EMA), the same image, through build_eval_step
    from PIL import Image

    from lwdetr_tpu_torch.models.lwdetr import build_model

    raw = torch.load(ckpt.checkpoint_file(os.path.join(runs["out"], "ckpt")), weights_only=False)
    model = build_model(runs["straight"]["state"].model.cfg, device="cpu",
                        state_dict=raw["ema_model"])
    pil = Image.open(image).convert("RGB")
    arr, _ = T.val_transform_square(pil, None, 640)
    batch = {"images": torch.from_numpy(arr)[None],
             "orig_size": torch.tensor([[pil.height, pil.width]], dtype=torch.float32)}
    (scores, labels, boxes), _ = engine.build_eval_step(model, 10)(batch)
    np.testing.assert_array_equal(got["scores"], scores[0].numpy())
    np.testing.assert_array_equal(got["labels"], labels[0].numpy())
    np.testing.assert_array_equal(got["boxes"], boxes[0].numpy())


def test_the_demo_warns_without_a_checkpoint_and_needs_a_card_unless_asked(monkeypatch, tmp_path,
                                                                           capsys):
    image = os.path.join(FIXDIR, "val2017", sorted(os.listdir(os.path.join(FIXDIR, "val2017")))[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--image", image, "--output", str(tmp_path / "x.jpg")])
    got = demo.main(["--image", image, "--device", "cpu", "--size", "320",
                     "--output", str(tmp_path / "x.jpg")])
    assert "WARNING: random weights" in capsys.readouterr().out
    from lwdetr_tpu_torch.config import get_config

    assert got["scores"].shape == (get_config("tiny").num_select,)
    assert np.isfinite(got["boxes"]).all()
