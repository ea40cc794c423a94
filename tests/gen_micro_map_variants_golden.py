"""Generate the variant micro-mAP fixture: `tests/fixtures/micro_map_variants/`
(the micro fixture's 20 images through a symlink to its `val2017/`) with its
own ground truth, and `tests/fixtures/micro_map/golden_stats_variants.json`:
the 12 AP/AR stats the JAX package gives there through its eval pipeline
(square recipe, batch 4, f32, on the CPU) with the micro model
(`micro_map_common.micro_config`) on the Deformable-DETR-style decoder:
one-stage, no box reparameterization, the iterative refinement, the learned
position embedding. It takes the fixture's `weights.npz` where the names
match (the decoder, heads, queries and encoder; the two-stage heads it lacks
are left out); `row_embed` / `col_embed`, which no forward reads, are drawn
by `embedding_tables`. As `gen_micro_map_padded_golden.py` does, the ground
truth is derived from the JAX pipeline's own detections of this model, so
that the stats lie strictly between 0 and 1 and move with the detections.
The port's eval CLI is held to them (`tests/test_torch_port_variants.py`,
`chip_smoke.py`).

Rerun (only when intentionally re-baselining):
    JAX_PLATFORMS=cpu python tests/gen_micro_map_variants_golden.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from gen_micro_map_padded_golden import derive_ground_truth  # noqa: E402
from micro_map_common import micro_config  # noqa: E402

FIXDIR = os.path.join(HERE, "fixtures", "micro_map")
VARIANTS_FIXDIR = os.path.join(HERE, "fixtures", "micro_map_variants")
BATCH_SIZE = 4
# the micro model as the CLI's flags, with the variant decoder, on the square recipe
FLAGS = ("--encoder vit_tiny --vit_encoder_num_layers 2 --window_block_indexes 0 "
         "--out_feature_indexes 0 1 --projector_scale P4 --hidden_dim 64 "
         "--dim_feedforward 128 --sa_nheads 4 --ca_nheads 8 --dec_n_points 2 "
         "--dec_layers 2 --group_detr 2 --num_queries 12 --num_select 10 "
         "--position_embedding learned --square_resize_div_64 --max_gt 10 "
         f"--batch_size {BATCH_SIZE}").split()
EMBED_SEED = 15


def variant_config():
    return dataclasses.replace(micro_config(), two_stage=False, bbox_reparam=False,
                               lite_refpoint_refine=False, position_embedding="learned")


def embedding_tables(num_pos_feats: int = 32):
    """row_embed, col_embed (50, num_pos_feats) f32 in U[0, 1): numpy's
    default_rng(EMBED_SEED), row first."""
    rng = np.random.default_rng(EMBED_SEED)
    return (rng.uniform(0.0, 1.0, (50, num_pos_feats)).astype(np.float32),
            rng.uniform(0.0, 1.0, (50, num_pos_feats)).astype(np.float32))


def variant_variables():
    """The variant model and its variables: the init tree, each leaf taken
    from weights.npz where its key path is there, the embedding tables drawn."""
    from lwdetr_tpu.models.lwdetr import build_model

    cfg = variant_config()
    model = build_model(cfg)
    init = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      jnp.zeros((1, 256, 256, 3), jnp.float32), train=True)
    data = np.load(os.path.join(FIXDIR, "weights.npz"))
    row, col = embedding_tables(cfg.hidden_dim // 2)
    flat, treedef = jax.tree_util.tree_flatten_with_path(init)
    leaves, taken = [], 0
    for path, leaf in flat:
        key = jax.tree_util.keystr(path)
        if key in data.files:
            arr = np.asarray(data[key], np.float32)
            taken += 1
        elif key.endswith("['row_embed']"):
            arr = row
        elif key.endswith("['col_embed']"):
            arr = col
        else:
            raise KeyError(f"{key}: neither in weights.npz nor an embedding table")
        assert arr.shape == leaf.shape, (key, arr.shape, leaf.shape)
        leaves.append(jnp.asarray(arr))
    print(f"{taken} of {len(flat)} leaves from weights.npz", flush=True)
    return cfg, model, jax.tree_util.tree_unflatten(treedef, leaves)


def run(cfg, model, variables, collect_dets: bool):
    """The JAX eval pipeline over the variant fixture: the detections by
    image id, or the 12 stats."""
    from lwdetr_tpu.data.coco import CocoDetection
    from lwdetr_tpu.data.coco_eval import CocoEvaluator
    from lwdetr_tpu.data.loader import DetectionLoader
    from lwdetr_tpu.train.engine import build_eval_step

    ds = CocoDetection(os.path.join(VARIANTS_FIXDIR, "val2017"),
                       os.path.join(VARIANTS_FIXDIR, "annotations", "instances_val2017.json"))
    loader = DetectionLoader(ds, batch_size=BATCH_SIZE, train=False, max_gt=10,
                             square_div_64=True, num_workers=0)
    eval_step = build_eval_step(model, cfg.num_select)
    evaluator = CocoEvaluator(ds.coco)
    dets, seen = {}, set()
    for batch in loader:
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
    path = os.path.join(VARIANTS_FIXDIR, "annotations", "instances_val2017.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)


def main():
    with open(os.path.join(FIXDIR, "annotations", "instances_val2017.json")) as f:
        images = json.load(f)["images"]
    link = os.path.join(VARIANTS_FIXDIR, "val2017")
    if not os.path.islink(link):
        os.makedirs(VARIANTS_FIXDIR, exist_ok=True)
        os.symlink(os.path.join("..", "micro_map", "val2017"), link)
    cfg, model, variables = variant_variables()
    # phase A: a placeholder ground truth, the detections at original-image coordinates
    write_annotations(images, [{"id": i, "image_id": m["id"], "category_id": 1,
                                "bbox": [1.0, 1.0, 8.0, 8.0], "area": 64.0, "iscrowd": 0}
                               for i, m in enumerate(images, start=1)],
                      [{"id": 1, "name": "c1"}])
    dets = run(cfg, model, variables, collect_dets=True)
    # phase B: the ground truth from the detections, then the stats
    write_annotations(images, *derive_ground_truth(images, dets))
    stats = run(cfg, model, variables, collect_dets=False)
    out = {"jax_version": jax.__version__,
           "note": "regenerate with tests/gen_micro_map_variants_golden.py only when "
                   "intentionally re-baselining",
           "images": os.path.relpath(VARIANTS_FIXDIR, os.path.dirname(HERE)),
           "flags": FLAGS, "embed_seed": EMBED_SEED,
           "stats": {k: float(v) for k, v in sorted(stats.items())}}
    with open(os.path.join(FIXDIR, "golden_stats_variants.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["stats"]))
    inside = [k for k, v in out["stats"].items() if 0.0 < v < 1.0]
    assert len(inside) >= 8, f"golden too degenerate: {out['stats']}"


if __name__ == "__main__":
    main()
