"""Generate `tests/fixtures/micro_map/golden_stats_deploy.json`: the 12 AP/AR
stats that the JAX package's deploy path gives on the micro fixture.

`lwdetr_tpu.deploy.benchmark.evaluate_coco` runs `jax.jit(make_export_fn(...))`
(the eval forward without a mask + `post_process`, the function that
`export_serialized` serializes) over `tests/fixtures/micro_map/` with the
fixture's `weights.npz` on the micro model (`micro_map_common.micro_config`),
f32, at 640 x 640 and batch 1, on the CPU. Its images are resized with PIL
(`val_transform_square`), not with the native decode and resize of the eval
loader, so these stats are not `golden_stats.json`'s. The port's deploy path
is held to them (`tests/test_torch_port_deploy.py`, `chip_smoke.py`).

Rerun (only when intentionally re-baselining):
    JAX_PLATFORMS=cpu python tests/gen_micro_map_deploy_golden.py
"""
from __future__ import annotations

import json
import os
import sys

import jax

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from micro_map_common import build_micro, load_weights  # noqa: E402

FIXDIR = os.path.join(HERE, "fixtures", "micro_map")
INPUT_HW = (640, 640)
BATCH = 1


def main():
    jax.config.update("jax_platforms", "cpu")
    # the f32 oracle's precision, as tests/conftest.py sets it for the suite
    jax.config.update("jax_default_matmul_precision", "highest")
    from lwdetr_tpu.deploy.benchmark import evaluate_coco
    from lwdetr_tpu.deploy.export import make_export_fn

    cfg, model, init = build_micro(seed=0)
    variables = load_weights(init, os.path.join(FIXDIR, "weights.npz"))
    fn = jax.jit(make_export_fn(model, cfg.num_select, INPUT_HW, BATCH))
    stats = evaluate_coco(fn, variables, FIXDIR, INPUT_HW, BATCH)
    out = {"jax_version": jax.__version__,
           "note": "regenerate with tests/gen_micro_map_deploy_golden.py only when "
                   "intentionally re-baselining",
           "input_hw": list(INPUT_HW), "batch": BATCH,
           "stats": {k: float(v) for k, v in sorted(stats.items())}}
    with open(os.path.join(FIXDIR, "golden_stats_deploy.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["stats"]))


if __name__ == "__main__":
    main()
