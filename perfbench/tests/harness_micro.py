"""A benchmark root at the micro size for the harness's CPU tests: its own
configuration, traffic mixes, limits and a new per-layer metric, each a file
of its own, beside copies of the benchmark's metric readers; `micro_settings`
sets the harness's own settings to the micro size."""
import contextlib
import dataclasses
import json
import shutil
from pathlib import Path
from unittest import mock

PERFBENCH = Path(__file__).resolve().parents[1]
MICRO = dict(encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=[0],
             out_feature_indexes=[0, 1], projector_scale=["P4"], hidden_dim=64,
             dim_feedforward=128, sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2,
             group_detr=2, num_queries=12, num_select=10)
NEW_METRIC = '''"""Images a batch of the window: a metric added as a file of its own."""


def read(ctx):
    return ctx.window["images"] / ctx.window["batches"] if ctx.mode == "infer" else None
'''


def make_root(tmp: Path, limits_from=None) -> Path:
    """`tmp` as a benchmark root with the cells "micro.infer" and
    "micro.train"; the limits of the output check are those of the real
    cells named in `limits_from` ({micro cell: real cell}) or loose ones."""
    from lwdetr_tpu_torch.config import PRESETS, TRAIN_PRESETS
    from perfbench.lib.flops import flops_per_image

    bench = json.loads((PERFBENCH.parent / "BENCHMARK.json").read_text())
    pb = tmp / "perfbench"
    shutil.copytree(PERFBENCH / "metrics", pb / "metrics")
    (pb / "metrics" / "images_per_batch.infer.py").write_text(NEW_METRIC)
    for d in ("configs", "traffic", "limits"):
        (pb / d).mkdir(parents=True)
    model = {f.name: getattr(PRESETS["small"], f.name)
             for f in dataclasses.fields(PRESETS["small"])}
    model = {k: list(v) if isinstance(v, tuple) else v for k, v in model.items()}
    model.update(MICRO)
    train = {f.name: getattr(TRAIN_PRESETS["small"], f.name)
             for f in dataclasses.fields(TRAIN_PRESETS["small"])}
    sizes = {"infer": [64], "train": [64, 128]}
    conf = {"name": "micro", "model": model, "train": train, "sizes": sizes,
            "flops_per_image": flops_per_image(model, sizes["infer"], sizes["train"])}
    (pb / "configs" / "micro.json").write_text(json.dumps(conf))
    infer = dict(json.loads((PERFBENCH / "traffic" / "infer_b32.json").read_text()), batch=2,
                 image_size=64, pool=2)
    train_mix = dict(json.loads((PERFBENCH / "traffic" / "train_b32.json").read_text()),
                     batch=2, sizes=[64, 128], max_gt=4)
    (pb / "traffic" / "micro_infer.json").write_text(json.dumps(infer))
    (pb / "traffic" / "micro_train.json").write_text(json.dumps(train_mix))
    limits_from = limits_from or {}
    loose = {"micro.infer": {"score_gap": 1.0, "box_gap": 1.0, "pick_gap": 1.0,
                             "replay_gap": 0.0},
             "micro.train": {"loss_gap": 1.0, "grad_gap": 1.0, "delta_gap": 1.0,
                             "ema_gap": 1.0}}
    for name, fallback in loose.items():
        real = limits_from.get(name)
        lim = (json.loads((PERFBENCH / "limits" / f"{real}.json").read_text()) if real
               else fallback)
        (pb / "limits" / f"{name}.json").write_text(json.dumps(lim))
    bench["configs"] = [{"name": "micro", "source": "test", "reduced": [],
                         "file": "perfbench/configs/micro.json", "why": "the harness's tests"}]
    bench["workloads"] = [{"name": f"micro.{k}", "config": "micro", "traffic": f"micro_{k}",
                           "chips": 1, "why": "the harness's tests"} for k in ("infer", "train")]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = ["micro.infer" if "infer" in m["name"] else "micro.train"]
    for m in bench["per_layer"]:
        m["workloads"] = ["micro." + m["name"].rsplit(".", 1)[1]]
    bench["per_layer"].append({"name": "images_per_batch.infer", "unit": "img", "better": "higher",
                               "source": "program_counter", "layer": "step entry",
                               "moves": "infer_img_per_s", "workloads": ["micro.infer"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@contextlib.contextmanager
def micro_settings():
    """The harness's own settings at the micro size: fewer warm-up passes,
    traced batches and steps, and checked images."""
    from perfbench.lib import infer, train

    with mock.patch.multiple(infer, WARMUP_PASSES=1, TRACE_BATCHES=2, CHECK_IMAGES=4,
                             CHECK_BLOCK=2), \
            mock.patch.multiple(train, TRACE_STEPS=2):
        yield
