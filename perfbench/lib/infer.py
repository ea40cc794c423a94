"""Batched detection: the eval CLI's loop over batches made from the seed.

Set-up draws the weights on the card, builds the program's eval model and
its step (`train/engine.py::build_eval_step`, no criterion: the images carry
no labels), and makes a pool of host batches in the form the eval CLI's
loader yields for the configured compute dtype (images (B, H, W, 3) in that
dtype, `orig_size`, `image_id`). The window drives `train/engine.py::evaluate`
with a loader that cycles the pool until the window's time is up and with
the benchmark's evaluator: every batch goes through `data/loader.py::to_device`,
the eval step and one fetch of its detections.

Each batch is timed from the loader handing it over to its detections
arriving on the host. After the window the batches of a sample of images
drawn from the seed run once more through the program's step, which must
give the window's detections again bit for bit, with the proposals it picks
and the (query, class) index of each detection noted; the plain reference
in float32 decodes the same proposals, and the program's detections are
held against the reference's query by query (`readings`).
"""
from __future__ import annotations

import math
import sys
import time
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from perfbench.lib import trace as tr
from perfbench.lib.common import Checks
from perfbench.lib.weights import make_state_dict
from perfbench.reference import model as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the harness's own settings, the same in every cell (the traffic file holds
# only what describes the traffic)
WARMUP_PASSES = 2  # passes over the pool in set-up
TRACE_BATCHES = 12  # batches under the profiler in a traced run
CHECK_IMAGES = 16  # images drawn from the seed for the output check
CHECK_BLOCK = 8  # images a reference forward


def model_config(model: dict):
    from lwdetr_tpu_torch.config import ModelConfig

    fields = {k: (tuple(v) if isinstance(v, list) else v) for k, v in model.items()
              if k in ModelConfig.__dataclass_fields__}
    return ModelConfig(**fields)


class Collector:
    """The benchmark's evaluator: counts the images whose detections reached
    the host, notes when each batch's did, and keeps the detections."""

    def __init__(self, batch: int):
        self.batch = batch
        self.images = 0
        self.arrived: Dict[int, float] = {}
        self.dets: Dict[int, dict] = {}

    def update(self, results: dict) -> None:
        now = time.perf_counter()
        for img_id in results:
            self.arrived.setdefault(img_id // self.batch, now)
        self.images += len(results)
        self.dets.update(results)

    def export(self):
        return None

    def merge(self, other) -> None:
        pass

    def summarize(self) -> dict:
        return {}


def logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(p.astype(np.float64), 1e-7, 1 - 1e-7)
    return np.log(p / (1 - p))


def compare(prog: dict, refd: dict, index: np.ndarray, side: float) -> Dict[str, float]:
    """One image's program detections against the reference's; `index` is
    the (query x classes + class) the program's top-k picked for each
    detection, so that each box is held against the reference's box of its
    own query, scaled to the image by the reference.

    * `score_gap`: the mean over ranks of |logit| gaps between the two sorted
      score lists (an order statistic moves no further than the scores do,
      so ties and swaps between near-equal detections cost nothing);
    * `box_gap`: the widest distance (largest coordinate difference over the
      image's longer side) between a detection's box and its query's;
    * `size_gap`: the median over the detections of the larger relative
      difference of width and height."""
    ps, rs = np.sort(prog["scores"])[::-1], np.sort(refd["scores"])[::-1]
    if ps.shape != rs.shape or index.shape != prog["scores"].shape:
        return dict.fromkeys(("score_gap", "score_gap_max", "box_gap", "size_gap"), math.inf)
    diffs = np.abs(logit(ps) - logit(rs))
    pb = prog["boxes"]
    rb = refd["query_boxes"][index // refd["classes"]]
    box = np.abs(pb - rb).max() / side
    tiny = 1e-6 * side
    wh_p, wh_r = pb[:, 2:] - pb[:, :2], rb[:, 2:] - rb[:, :2]
    size = np.median((np.abs(wh_p - wh_r) / np.maximum(wh_r, tiny)).max(-1))
    return {"score_gap": float(diffs.mean()), "score_gap_max": float(diffs.max()),
            "box_gap": float(box) if np.isfinite(box) else math.inf,
            "size_gap": float(size) if np.isfinite(size) else math.inf}


class Driver:
    """The driver of the traffic kind "infer"."""

    mode = "infer"

    def __init__(self, cell, seed: int, device, spans: tr.Spans, log=print):
        self.cell, self.seed, self.device, self.spans, self.log = cell, seed, device, spans, log
        self.traffic = cell.traffic
        self.batch = int(self.traffic["batch"])
        self.size = int(self.traffic["image_size"])
        self.dtype = DTYPES[self.traffic["dtype"]]

    # ------------------------------------------------------------------ set-up

    def setup(self) -> None:
        from lwdetr_tpu_torch.models.lwdetr import build_model
        from lwdetr_tpu_torch.train.engine import build_eval_step

        torch.backends.cuda.matmul.allow_tf32 = False  # as the CLI runs
        torch.backends.cudnn.allow_tf32 = False
        model_cfg = self.cell.config["model"]
        self.mcfg = model_config(model_cfg)
        self.sd = make_state_dict(ref.state_shapes(model_cfg), self.seed, self.device)
        self.model = build_model(self.mcfg, device=self.device, dtype=self.dtype,
                                 state_dict=self.sd)
        self.eval_step = build_eval_step(self.model, self.mcfg.num_select)
        self.pool = self.make_pool()
        self.evaluate(self.pool_batches(len(self.pool) * WARMUP_PASSES))

    def make_pool(self) -> List[dict]:
        """Host batches made on the card from the seed, then copied to the host."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 7919 + 1) % (2 ** 63))
        rng = np.random.default_rng(self.seed)
        sizes = np.asarray(self.traffic["orig_sizes"], np.float32)
        B, S = self.batch, self.size
        pool = []
        for _ in range(int(self.traffic["pool"])):
            images = torch.randn((B, S, S, 3), generator=gen, device=self.device)
            pool.append({"images": images.to(self.dtype).cpu(),
                         "orig_size": sizes[rng.integers(0, len(sizes), B)]})
        return pool

    def pool_batches(self, count=None, stop=None):
        """The pool cycled (`count` batches, or until `stop` on the host clock);
        `handed[i]` is when batch i was handed over, `which[i]` its pool entry."""
        self.handed, self.which = {}, {}
        i = 0
        while (count is None or i < count) and (stop is None or time.perf_counter() < stop):
            p = i % len(self.pool)
            b = dict(self.pool[p])
            b["image_id"] = np.arange(i * self.batch, (i + 1) * self.batch, dtype=np.int64)
            self.which[i] = p
            self.handed[i] = time.perf_counter()
            yield b
            i += 1

    def evaluate(self, loader) -> Collector:
        from lwdetr_tpu_torch.data.loader import to_device
        from lwdetr_tpu_torch.train import engine

        collector = Collector(self.batch)
        put = self.spans.wrap("to_device", lambda b: to_device(b, self.device))
        step = self.spans.wrap("enqueue", self.eval_step)
        with mock.patch.object(engine, "_fetch", self.spans.wrap("fetch wait", engine._fetch)):
            engine.evaluate(step, loader, collector, put_fn=put, logger=self.log)
        return collector

    # ------------------------------------------------------------------ window

    def run_window(self, seconds: float) -> dict:
        tr.sync(self.device)
        self.spans.recording = True
        t0 = time.perf_counter()
        self.collector = self.evaluate(self.pool_batches(stop=t0 + seconds))
        self.spans.recording = False
        c = self.collector
        t1 = max(c.arrived.values())
        lat = [c.arrived[i] - self.handed[i] for i in sorted(c.arrived)]
        self.window = {"window_s": t1 - t0, "images": c.images, "batches": len(self.handed),
                       "done": len(c.arrived), "latency_s": lat,
                       "sizes": [self.size] * len(c.arrived)}
        self.window_which = dict(self.which)
        return self.window

    def end_to_end(self) -> Dict[str, float]:
        w = self.window
        return {"infer_img_per_s": w["images"] / w["window_s"],
                "infer_batch_p95_ms": float(np.percentile(np.asarray(w["latency_s"]) * 1e3, 95))}

    def run_traced(self):
        from lwdetr_tpu_torch.train import engine

        stages = tr.StageRanges(self.model)
        count = TRACE_BATCHES
        ranged_pp = stages.ranged(tr.POST_PROCESS, engine.post_process)
        self.spans.traced = stages.enabled = True
        try:
            with tr.SamplerPoints() as points, \
                    mock.patch.object(engine, "post_process", ranged_pp), \
                    tr.profiled(self.device) as holder:
                self.evaluate(self.pool_batches(count))
        finally:
            self.spans.traced = stages.enabled = False
            stages.remove()
        self.sampler_positions = points.positions()
        return holder["trace"], [self.size] * count

    # ------------------------------------------------------------------ check

    def sample(self) -> List[tuple]:
        """(batch index, image index) pairs drawn from the seed among the
        window's batches whose detections arrived."""
        rng = np.random.default_rng(self.seed + 17)
        done = sorted(self.collector.arrived)
        n = CHECK_IMAGES
        picks = rng.choice(len(done) * self.batch, size=min(n, len(done) * self.batch),
                           replace=False)
        return [(done[p // self.batch], int(p % self.batch)) for p in sorted(picks)]

    def replay(self) -> None:
        """The sampled batches again through the program's own step, with the
        proposals it picks noted (`transformer.select_proposals`), so that the
        reference decodes the same queries, and with the index of each
        detection noted (the top-k that `post_process` takes over query x
        class), so that each detection meets the reference at its query. Each
        replay's detections are held against the window's, bit for bit
        (`replay_gap`)."""
        from lwdetr_tpu_torch.data.loader import to_device
        from lwdetr_tpu_torch.models import transformer
        from lwdetr_tpu_torch.train import engine

        self.samples = self.sample()
        picked, indexed = [], []
        select, post_process, topk = transformer.select_proposals, engine.post_process, torch.topk

        def noting(scores, k):
            idx = select(scores, k)
            picked.append(idx.detach().clone())
            return idx

        def noting_topk(*args, **kwargs):
            out = topk(*args, **kwargs)
            indexed.append(out[1].detach().clone())
            return out

        def indexing(logits, boxes, sizes, num_select):
            with mock.patch.object(torch, "topk", noting_topk):
                dets = post_process(logits, boxes, sizes, num_select=num_select)
            if not indexed:  # a post_process that takes no torch.topk: the same top-k
                indexed.append(topk(logits.reshape(logits.shape[0], -1), num_select, dim=1)[1])
            return dets

        self.program_picks, self.program_index, gap = {}, {}, 0.0
        with mock.patch.object(transformer, "select_proposals", noting), \
                mock.patch.object(engine, "post_process", indexing):
            for b in sorted({b for b, _ in self.samples}):
                batch = dict(self.pool[self.window_which[b]])
                batch["image_id"] = np.arange(b * self.batch, (b + 1) * self.batch)
                picked.clear()
                indexed.clear()
                (scores, labels, boxes), _ = self.eval_step(to_device(batch, self.device))
                scores, labels, boxes, idx, index = engine._fetch(
                    [scores, labels, boxes, picked[0], indexed[-1]])
                if idx.shape[0] != self.batch or index.shape[0] != self.batch:
                    gap = math.inf  # picks for another number of images
                for i in range(self.batch):
                    seen = self.collector.dets[b * self.batch + i]
                    gap = max(gap, float(np.abs(seen["scores"] - scores[i]).max()),
                              float(np.abs(seen["boxes"] - boxes[i]).max()),
                              float((seen["labels"] != labels[i]).sum()))
                    self.program_picks[(b, i)] = idx[min(i, idx.shape[0] - 1)]
                    self.program_index[(b, i)] = index[min(i, index.shape[0] - 1)]
        self.replay_gap = gap

    def release(self) -> None:
        self.replay()
        del self.model, self.eval_step
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference_dets(self, samples, mode: str = "f32", picks=None) -> List[dict]:
        """The reference's detections of the sampled images in `mode`, with
        its proposal scores and picks, each query's box scaled to the image
        and the index of each detection; `picks` {sample:
        positions} makes it decode those proposals in place of its own top-k."""
        model = ref.build(self.cell.config["model"], self.sd, device=self.device)
        out = []
        with torch.no_grad(), ref.precision(mode):
            for s in range(0, len(samples), CHECK_BLOCK):
                part = samples[s:s + CHECK_BLOCK]
                pool = [self.pool[self.window_which[b]] for b, _ in part]
                x = torch.stack([p["images"][i] for p, (_, i) in zip(pool, part)])
                sizes = torch.as_tensor(np.stack([p["orig_size"][i] for p, (_, i) in
                                                  zip(pool, part)]), device=self.device)
                given = None if picks is None else torch.as_tensor(
                    np.stack([picks[p] for p in part]), device=self.device)
                o = model(x.to(self.device, torch.float32), picks=given)
                scores, labels, boxes, index = ref.post_process(
                    o["pred_logits"], o["pred_boxes"], sizes, self.mcfg.num_select, index=True)
                query_boxes = ref.query_boxes(o["pred_boxes"], sizes)
                for j in range(len(part)):
                    out.append({"scores": scores[j].cpu().numpy(),
                                "labels": labels[j].cpu().numpy(),
                                "boxes": boxes[j].cpu().numpy(),
                                "index": index[j].cpu().numpy(),
                                "classes": o["pred_logits"].shape[-1],
                                "query_boxes": query_boxes[j].cpu().numpy(),
                                "proposal_scores": o["proposal_scores"][j].cpu().numpy(),
                                "picks": o["picks"][j].cpu().numpy()})
        del model
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out

    def readings(self, samples, reference: List[dict], served: List[dict], picks: Dict,
                 index: Dict) -> Dict[str, float]:
        """The numbers compared, over the sampled images:

        * `pick_gap`: the widest shortfall of a picked proposal's reference
          score below the reference's own k-th best (0 where the picks are
          a top-k of the reference's scores);
        * `score_gap`, `size_gap`: `compare`'s, averaged over the images;
        * `score_gap_max`, `box_gap`: `compare`'s, the widest over the images."""
        per, pick_gap = [], 0.0
        for s, r, p in zip(samples, reference, served):
            b, i = s
            side = float(max(self.pool[self.window_which[b]]["orig_size"][i]))
            per.append(compare(p, r, np.asarray(index[s]), side))
            k = len(r["picks"])
            kth = np.sort(r["proposal_scores"])[::-1][k - 1]
            pick_gap = max(pick_gap, float(kth - r["proposal_scores"][picks[s]].min()))
        out = {k: float(np.mean([x[k] for x in per])) for k in per[0]}
        out.update({k: float(max(x[k] for x in per)) for k in ("score_gap_max", "box_gap")},
                   pick_gap=pick_gap)
        return out

    def served(self, samples) -> List[dict]:
        dets = self.collector.dets
        return [dets[b * self.batch + i] for b, i in samples]

    def check(self, checks: Checks) -> None:
        samples = self.samples
        self.ref32 = self.reference_dets(samples, picks=self.program_picks)
        self.reading = self.readings(samples, self.ref32, self.served(samples),
                                     self.program_picks, self.program_index)
        self.reading["replay_gap"] = self.replay_gap
        for k, limit in self.cell.limits.items():
            checks.add(k, self.reading[k], limit)
        print(f"checked {len(samples)} images of {len(self.collector.arrived)} batches; "
              f"not compared: {({k: v for k, v in self.reading.items() if k not in checks.items})}",
              file=sys.stderr)

    def control(self) -> Dict[str, Dict[str, float]]:
        """The control's readings on the checked images: the reference in
        float8 (e4m3) in the program's place, picking its own proposals,
        held against the float32 reference decoding the same proposals."""
        fp8 = self.reference_dets(self.samples, "fp8")
        picks = {s: d["picks"] for s, d in zip(self.samples, fp8)}
        index = {s: d["index"] for s, d in zip(self.samples, fp8)}
        return {"fp8": self.readings(self.samples, self.reference_dets(self.samples, picks=picks),
                                     fp8, picks, index)}

