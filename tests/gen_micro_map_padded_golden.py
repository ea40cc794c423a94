"""Generate the padded micro-mAP fixture: `tests/fixtures/micro_map_padded/`
(six of the micro fixture's images, 640x480 with 480x640, 640x360 with
280x210, 640x640 with 1600x1200, through a symlink to its `val2017/`) with
its own ground truth, and `tests/fixtures/micro_map/golden_stats_padded.json`:
the 12 AP/AR stats the JAX package gives there through its eval pipeline on
the legacy recipe (`square_resize_div_64` off: shortest side 800, longest at
most 1333, each batch of 2 padded to a common multiple of 64 with its
`pad_mask`), the micro model with the fixture's weights, f32, on the CPU.
As `gen_micro_map_fixture.py` does for the square recipe, the ground truth is
derived from the JAX pipeline's own detections on this recipe (an exact, a
jittered and a grown match and a decoy an image), so that the stats lie
strictly between 0 and 1 and move with the detections. The port's eval CLI is
held to them (`tests/test_torch_port_padded.py`, `chip_smoke.py`).

Rerun (only when intentionally re-baselining):
    JAX_PLATFORMS=cpu python tests/gen_micro_map_padded_golden.py
"""
from __future__ import annotations

import json
import os
import sys

import jax
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from micro_map_common import build_micro, load_weights  # noqa: E402

FIXDIR = os.path.join(HERE, "fixtures", "micro_map")
PADDED_FIXDIR = os.path.join(HERE, "fixtures", "micro_map_padded")
BATCH_SIZE = 2
# the micro model (micro_map_common.micro_config) as the CLI's flags, on the legacy recipe
FLAGS = ("--encoder vit_tiny --vit_encoder_num_layers 2 --window_block_indexes 0 "
         "--out_feature_indexes 0 1 --projector_scale P4 --hidden_dim 64 "
         "--dim_feedforward 128 --sa_nheads 4 --ca_nheads 8 --dec_n_points 2 "
         "--dec_layers 2 --group_detr 2 --num_queries 12 --num_select 10 --two_stage "
         f"--lite_refpoint_refine --bbox_reparam --max_gt 10 --batch_size {BATCH_SIZE}").split()


IMAGE_IDS = (2, 3, 8, 16, 17, 19)  # sorted: the loader pairs (2, 3), (8, 16), (17, 19)


def run(variables, collect_dets: bool):
    """The JAX eval pipeline over the padded fixture: the detections by image
    id, or the 12 stats."""
    from lwdetr_tpu.data.coco import CocoDetection
    from lwdetr_tpu.data.coco_eval import CocoEvaluator
    from lwdetr_tpu.data.loader import DetectionLoader
    from lwdetr_tpu.train.engine import build_eval_step

    cfg, model, _ = build_micro(seed=0)
    ds = CocoDetection(os.path.join(PADDED_FIXDIR, "val2017"),
                       os.path.join(PADDED_FIXDIR, "annotations", "instances_val2017.json"))
    loader = DetectionLoader(ds, batch_size=BATCH_SIZE, train=False, max_gt=10,
                             square_div_64=False, num_workers=0)
    eval_step = build_eval_step(model, cfg.num_select)
    evaluator = CocoEvaluator(ds.coco)
    dets, seen = {}, set()
    for batch in loader:
        assert "pad_mask" in batch
        print("batch", batch["images"].shape, "padded", int(batch["pad_mask"].sum()), flush=True)
        (scores, labels, boxes), _ = jax.device_get(
            eval_step(variables["params"], variables.get("batch_stats", {}), batch))
        results = {}
        for i, img_id in enumerate(batch["image_id"].tolist()):
            if img_id in seen:
                continue
            seen.add(img_id)
            results[img_id] = {"scores": scores[i], "labels": labels[i], "boxes": boxes[i]}
        dets.update(results)
        evaluator.update(results)
    return dets if collect_dets else evaluator.summarize()


def write_annotations(images, annotations, categories):
    path = os.path.join(PADDED_FIXDIR, "annotations", "instances_val2017.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)


def derive_ground_truth(images, dets):
    """gen_micro_map_fixture.py's rule: per image an exact, a jittered and a
    grown copy of its three best detections and a decoy of a matched class."""
    rng = np.random.default_rng(7)
    annotations, cat_ids = [], set()
    for m in images:
        d = dets[m["id"]]
        order = np.argsort(-d["scores"])[:3]
        w, h = m["width"], m["height"]
        matched_cats = [int(d["labels"][j]) for j in order]
        for mode, box_idx in [("exact", order[0]), ("jitter", order[1]), ("grow", order[2]),
                              ("decoy", None)]:
            if mode == "decoy":
                bw, bh = rng.uniform(16, w / 3), rng.uniform(16, h / 3)
                x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                cat = matched_cats[int(rng.integers(0, 3))]
            else:
                x0, y0, x1, y1 = [float(v) for v in d["boxes"][box_idx]]
                if mode == "jitter":
                    bw0, bh0 = x1 - x0, y1 - y0
                    x0 += rng.uniform(-0.15, 0.15) * bw0
                    y0 += rng.uniform(-0.15, 0.15) * bh0
                    x1 += rng.uniform(-0.15, 0.15) * bw0
                    y1 += rng.uniform(-0.15, 0.15) * bh0
                elif mode == "grow":
                    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
                    hw = max((x1 - x0), 40.0) * rng.uniform(1.6, 3.0) / 2
                    hh = max((y1 - y0), 40.0) * rng.uniform(1.6, 3.0) / 2
                    x0, x1, y0, y1 = cx - hw, cx + hw, cy - hh, cy + hh
                x0, x1 = sorted((max(0.0, x0), min(float(w), x1)))
                y0, y1 = sorted((max(0.0, y0), min(float(h), y1)))
                bw, bh = max(x1 - x0, 2.0), max(y1 - y0, 2.0)
                cat = int(d["labels"][box_idx])
            annotations.append({
                "id": len(annotations) + 1, "image_id": m["id"], "category_id": cat,
                "bbox": [round(float(x0), 2), round(float(y0), 2),
                         round(float(bw), 2), round(float(bh), 2)],
                "area": round(float(bw * bh), 2), "iscrowd": 0})
            cat_ids.add(cat)
    return annotations, [{"id": c, "name": f"c{c}"} for c in sorted(cat_ids)]


def main():
    with open(os.path.join(FIXDIR, "annotations", "instances_val2017.json")) as f:
        images = [m for m in json.load(f)["images"] if m["id"] in IMAGE_IDS]
    link = os.path.join(PADDED_FIXDIR, "val2017")
    if not os.path.islink(link):
        os.makedirs(PADDED_FIXDIR, exist_ok=True)
        os.symlink(os.path.join("..", "micro_map", "val2017"), link)
    _, _, variables = build_micro(seed=0)
    variables = load_weights(variables, os.path.join(FIXDIR, "weights.npz"))
    # phase A: a placeholder ground truth, the detections at original-image coordinates
    write_annotations(images, [{"id": i, "image_id": m["id"], "category_id": 1,
                                "bbox": [1.0, 1.0, 8.0, 8.0], "area": 64.0, "iscrowd": 0}
                               for i, m in enumerate(images, start=1)],
                      [{"id": 1, "name": "c1"}])
    dets = run(variables, collect_dets=True)
    # phase B: the ground truth from the detections, then the stats
    write_annotations(images, *derive_ground_truth(images, dets))
    stats = run(variables, collect_dets=False)
    out = {"jax_version": jax.__version__,
           "note": "regenerate with tests/gen_micro_map_padded_golden.py only when "
                   "intentionally re-baselining",
           "images": os.path.relpath(PADDED_FIXDIR, os.path.dirname(HERE)),
           "flags": FLAGS,
           "stats": {k: float(v) for k, v in sorted(stats.items())}}
    with open(os.path.join(FIXDIR, "golden_stats_padded.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["stats"]))
    nontrivial = [k for k, v in out["stats"].items() if 0.02 < v < 0.98]
    assert len(nontrivial) >= 6, f"golden too degenerate: {out['stats']}"


if __name__ == "__main__":
    main()
