"""Generate the orbax train-state fixture: `tests/fixtures/micro_orbax/`.

The JAX CLI (`main.py`) trains the micro model (`micro_map_common.micro_config`,
the micro flags, f32, `--use_ema`) for one epoch on the mAP fixture's 20
images, which serve as train and val, starting from the fixture's
`weights.npz` (written as a temporary reference `.pth` by `flax_to_torch` and
given as `--pretrain_weights`, so that the EMA starts from them too). Batch 4:
5 steps, one orbax save at step 5. Those 5 steps drop the trained model's AP
on the fixture from `weights.npz`'s ~0.17 to ~0.0002 (at a tenth and at a
hundredth of the learning rates, 0.0025 and 0.002; the trained weights with
the EMA's BatchNorm statistics, 0.0046): the fixture's AP moves with any
change of those weights. The EMA (decay 0.9997) keeps 0.157, and its block is
the golden that a wrong reader cannot pass. Kept:

* `ckpt/<step>/`: the last step the CLI saved, as orbax wrote it;
* `orbax_digests.json`: each leaf of `ocp.CheckpointManager(ckpt).restore(step)`
  (its key path, dtype, shape, sha256 of its bytes), and the step;
* `golden_stats_orbax.json`: the JAX eval CLI's 12 stats with
  `--eval --resume tests/fixtures/micro_orbax/ckpt --use_ema` on
  `tests/fixtures/micro_map` at batch 4, the regular block and the EMA one.

The port's orbax reader and its CLI are held to them
(`tests/test_torch_port_orbax.py`, `chip_smoke.py`'s `orbax_phase`).

Rerun (only when intentionally re-baselining):
    JAX_PLATFORMS=cpu JAX_NO_COMPILE_CACHE=1 python tests/gen_micro_orbax_fixture.py
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

from micro_map_common import build_micro, load_weights  # noqa: E402

FIXDIR = os.path.join(HERE, "fixtures", "micro_map")
OUTDIR = os.path.join(HERE, "fixtures", "micro_orbax")
BATCH_SIZE = 4
MICRO_FLAGS = ("--encoder vit_tiny --vit_encoder_num_layers 2 --window_block_indexes 0 "
               "--out_feature_indexes 0 1 --projector_scale P4 --hidden_dim 64 "
               "--dim_feedforward 128 --sa_nheads 4 --ca_nheads 8 --dec_n_points 2 "
               "--dec_layers 2 --group_detr 2 --num_queries 12 --num_select 10 --two_stage "
               "--lite_refpoint_refine --bbox_reparam --square_resize_div_64 --max_gt 10").split()


def coco_dir(work: str) -> str:
    """A COCO dir whose train2017 and val2017 are the fixture's 20 images."""
    coco = os.path.join(work, "coco")
    os.makedirs(os.path.join(coco, "annotations"))
    for split in ("train2017", "val2017"):
        os.symlink(os.path.join(FIXDIR, "val2017"), os.path.join(coco, split))
        shutil.copy(os.path.join(FIXDIR, "annotations", "instances_val2017.json"),
                    os.path.join(coco, "annotations", f"instances_{split}.json"))
    return coco


def weights_pth(work: str) -> str:
    import torch

    from lwdetr_tpu.train.checkpoint import flax_to_torch

    cfg, _, init = build_micro(seed=0)
    variables = load_weights(init, os.path.join(FIXDIR, "weights.npz"))
    sd = flax_to_torch({k: v for k, v in variables.items()}, cfg)
    path = os.path.join(work, "weights.pth")
    torch.save({"model": {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}},
               path)
    return path


def train(work: str) -> str:
    out = os.path.join(work, "out")
    cmd = [sys.executable, "main.py", *MICRO_FLAGS, "--coco_path", coco_dir(work),
           "--output_dir", out, "--epochs", "1", "--batch_size", str(BATCH_SIZE), "--use_ema",
           "--pretrain_weights", weights_pth(work), "--dont_bench", "--num_workers", "0"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_NO_COMPILE_CACHE="1")
    subprocess.run(cmd, cwd=ROOT, env=env, check=True)
    return os.path.join(out, "ckpt")


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, np.asarray(tree)


def digests(ckpt: str) -> dict:
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(os.path.abspath(ckpt))
    step = mgr.latest_step()
    raw = mgr.restore(step)
    return {"step": int(step),
            "leaves": [{"path": list(p), "dtype": a.dtype.str, "shape": list(a.shape),
                        "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}
                       for p, a in leaves(raw)]}


def golden_stats(ckpt: str, out_dir: str) -> dict:
    """The JAX eval CLI's stats, both blocks, recorded from `evaluate`."""
    import main as cli
    from lwdetr_tpu.train import engine

    blocks = []
    evaluate = engine.evaluate

    def recording(*a, **k):
        blocks.append(evaluate(*a, **k))
        return blocks[-1]

    parser = cli.argparse.ArgumentParser(parents=[cli.get_args_parser()])
    args = parser.parse_args([*MICRO_FLAGS, "--eval", "--coco_path", FIXDIR, "--resume", ckpt,
                              "--use_ema", "--batch_size", str(BATCH_SIZE), "--dont_bench",
                              "--num_workers", "0", "--output_dir", out_dir])
    with mock.patch.object(engine, "evaluate", recording):
        cli.main(args)
    assert len(blocks) == 2, f"{len(blocks)} eval blocks"
    keys = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100", "ARs", "ARm",
            "ARl")
    return {"stats": {k: float(blocks[0][k]) for k in keys},
            "ema_stats": {k: float(blocks[1][k]) for k in keys},
            "batch_size": BATCH_SIZE,
            "made_by": "tests/gen_micro_orbax_fixture.py: the JAX CLI with --eval --resume "
                       "tests/fixtures/micro_orbax/ckpt --use_ema on tests/fixtures/micro_map"}


def main():
    os.environ.setdefault("JAX_NO_COMPILE_CACHE", "1")
    with tempfile.TemporaryDirectory() as work:
        src = train(work)
        steps = sorted(int(n) for n in os.listdir(src) if n.isdigit())
        shutil.rmtree(OUTDIR, ignore_errors=True)
        dst = os.path.join(OUTDIR, "ckpt")
        os.makedirs(dst)
        shutil.copytree(os.path.join(src, str(steps[-1])), os.path.join(dst, str(steps[-1])))
        with open(os.path.join(OUTDIR, "orbax_digests.json"), "w") as f:
            json.dump(digests(dst), f, indent=1)
        os.chdir(ROOT)
        stats = golden_stats(os.path.relpath(dst, ROOT), os.path.join(work, "eval"))
    with open(os.path.join(OUTDIR, "golden_stats_orbax.json"), "w") as f:
        json.dump(stats, f, indent=1)
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(OUTDIR) for n in ns)
    print(json.dumps({"step": steps[-1], "fixture_bytes": size, **stats}))


if __name__ == "__main__":
    main()
