"""Training at the release recipe: the train CLI's loop over batches made from the seed.

Set-up draws the weights on the card, builds the program's train state
(`train/engine.py::create_train_state`: the model, AdamW with the recipe's
groups, the EMA), its criterion and its step (`build_train_step`, with the
drop schedules the CLI builds), and one host batch a square size of the
recipe, in the form the CLI's loader yields (float32 images (B, S, S, 3),
labels, boxes and valid flags padded to `max_gt`, `image_id`, `orig_size`).
The boxes an image follow a geometric law with COCO's mean, the same counts
for every seed in another order. Steps run in blocks, each a permutation of
the sizes drawn from the seed, so every window holds the same mix.

Set-up runs the first block through `train_one_epoch` with `to_device`, as
the window does, on the same state that it then hands to the window: it
warms every size, and its first three steps are the ones the reference
follows after the window (their losses, the first gradient as AdamW got it,
the parameters and the EMA after the third). The window drives
`train_one_epoch` on blocks until the window's time is up and a block has
ended (`should_stop`); it counts the images of every step the device
finished.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from perfbench.lib import trace as tr
from perfbench.lib.common import Checks
from perfbench.lib.infer import model_config
from perfbench.lib.weights import make_state_dict
from perfbench.reference import model as ref
from perfbench.reference import train as rtrain

NITER_PER_EPOCH = 1000  # the schedule's epoch; no run reaches its first lr drop
# the harness's own settings, the same in every cell (the traffic file holds
# only what describes the traffic)
CHECK_STEPS = 3  # the first steps, which the reference follows
TRACE_STEPS = 8  # steps under the profiler in a traced run
REFERENCE_ATTENTION_BYTES = 512 * 2 ** 20  # the reference's attention, in chunks of this


def box_counts(n: int, mean: float, cap: int) -> np.ndarray:
    """n counts at the quantiles (i + 0.5) / n of a geometric law on 0, 1, ...
    with the given mean, capped: the same multiset for every seed."""
    p = 1.0 / (mean + 1.0)
    q = (np.arange(n) + 0.5) / n
    counts = np.floor(np.log1p(-q) / np.log1p(-p)).astype(np.int64)
    return np.minimum(counts, cap)


class Masks:
    """The stochastic-depth masks of the program's step, drawn on the card
    from the seed and the step, and those of the first steps kept for the
    reference."""

    def __init__(self, seed: int, device, keep_steps: int):
        self.seed, self.device, self.keep_steps = seed, device, keep_steps
        self.step = 0
        self.kept: List[List[torch.Tensor]] = []
        self.gen = torch.Generator(device=device)

    def begin(self, step: int) -> None:
        self.step = step
        self.gen.manual_seed((self.seed * 1_000_003 + step) % (2 ** 63))
        if step < self.keep_steps:
            self.kept.append([])

    def __call__(self, keep, shape, like):
        probs = torch.full(tuple(shape), float(keep), device=like.device, dtype=torch.float32)
        mask = torch.bernoulli(probs, generator=self.gen).to(like.dtype)
        if self.step < self.keep_steps:
            self.kept[self.step].append(mask.clone())
        return mask


class Driver:
    """The driver of the traffic kind "train"."""

    mode = "train"

    def __init__(self, cell, seed: int, device, spans: tr.Spans, log=print):
        self.cell, self.seed, self.device, self.spans, self.log = cell, seed, device, spans, log
        self.traffic = cell.traffic
        self.batch = int(self.traffic["batch"])
        self.sizes = [int(s) for s in self.traffic["sizes"]]
        self.check_steps = CHECK_STEPS
        self.rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------------ set-up

    def setup(self) -> None:
        from lwdetr_tpu_torch.config import TrainConfig
        from lwdetr_tpu_torch.models.criterion import SetCriterion
        from lwdetr_tpu_torch.train import engine, optim

        torch.backends.cuda.matmul.allow_tf32 = False  # as the CLI runs
        torch.backends.cudnn.allow_tf32 = False
        conf = self.cell.config
        self.mcfg = model_config(conf["model"])
        self.tcfg = TrainConfig(**{k: v for k, v in conf["train"].items()
                                   if k in TrainConfig.__dataclass_fields__})
        self.sd = make_state_dict(ref.state_shapes(conf["model"]), self.seed, self.device)
        self.state = engine.create_train_state(self.mcfg, self.tcfg, NITER_PER_EPOCH,
                                               device=self.device, state_dict=self.sd,
                                               dtype=torch.float32)
        self.criterion = SetCriterion(self.mcfg, self.tcfg)
        t = self.tcfg
        self.dp_sched = optim.drop_scheduler(self.mcfg.drop_path, t.epochs, NITER_PER_EPOCH,
                                             t.cutoff_epoch, t.drop_mode, t.drop_schedule)
        self.do_sched = optim.drop_scheduler(self.mcfg.dropout, t.epochs, NITER_PER_EPOCH,
                                             t.cutoff_epoch, t.drop_mode, t.drop_schedule)
        self.program_step = engine.build_train_step(
            self.state, self.criterion, t,
            static_zero_drop_path=bool(np.all(self.dp_sched == 0)),
            static_zero_dropout=bool(np.all(self.do_sched == 0)))
        self.masks = Masks(self.seed, self.device, self.check_steps)
        self.pool = self.make_pool()
        self.steps_done = 0
        self.snapshots: Dict[str, object] = {"losses": []}
        self.params0 = {n: p.detach().clone() for n, p in self.state.model.named_parameters()}
        blocks = -(-self.check_steps // len(self.sizes))  # enough for the checked steps
        self.first_block = [s for _ in range(blocks) for s in self.block()]
        self.epoch(iter([self.pool[s] for s in self.first_block]))

    def make_pool(self) -> Dict[int, dict]:
        """One host batch a size, made on the card from the seed."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 7919 + 2) % (2 ** 63))
        B, T = self.batch, int(self.traffic["max_gt"])
        counts = self.rng.permutation(box_counts(B * len(self.sizes),
                                                 float(self.traffic["boxes_mean"]), T))
        pool = {}
        for k, S in enumerate(self.sizes):
            images = torch.randn((B, S, S, 3), generator=gen, device=self.device)
            n = counts[k * B:(k + 1) * B]
            labels = np.zeros((B, T), np.int32)
            boxes = np.tile(np.array([0.5, 0.5, 1.0, 1.0], np.float32), (B, T, 1))
            valid = np.zeros((B, T), bool)
            for i in range(B):
                m = int(n[i])
                wh = self.rng.uniform(0.02, 0.6, (m, 2)).astype(np.float32)
                c = (self.rng.uniform(0, 1, (m, 2)) * (1 - wh) + wh / 2).astype(np.float32)
                labels[i, :m] = self.rng.integers(1, self.mcfg.num_classes, m)
                boxes[i, :m] = np.concatenate([c, wh], -1)
                valid[i, :m] = True
            pool[S] = {"images": images.cpu().numpy(), "labels": labels, "boxes": boxes,
                       "valid": valid, "image_id": np.arange(B, dtype=np.int64),
                       "orig_size": np.full((B, 2), S, np.float32)}
        return pool

    def block(self) -> List[int]:
        return [self.sizes[i] for i in self.rng.permutation(len(self.sizes))]

    def step(self, batch, dp_rate, do_rate):
        """The program's train step, noting what the reference compares."""
        k = self.steps_done
        self.masks.begin(k)
        src = self.masks if dp_rate or do_rate else None
        out = self.program_step(batch, dp_rate, do_rate, mask_source=src)
        self.steps_done += 1
        snap = self.snapshots
        if k < self.check_steps:
            snap["losses"].append(out["loss"].detach().clone())
        if k == 0:
            opt = self.state.optimizer
            # AdamW's first moment after one step is (1 - beta1) x the gradient it got
            snap["grads"] = {n: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach()
                             / (1 - 0.9) for n, p in self.state.model.named_parameters()}
        if k == self.check_steps - 1:
            snap["params"] = {n: p.detach().clone()
                              for n, p in self.state.model.named_parameters()}
            ema = self.state.ema or {}
            snap["ema"] = {n: ema[n].detach().clone() for n in snap["params"] if n in ema}
        return out

    def epoch(self, loader, should_stop=None):
        """`train_one_epoch` over `loader`. Between a step's return and the
        loop's `should_stop` poll the loop fetches the previous step's
        metrics: that stretch is the span "metric fetch"."""
        from lwdetr_tpu_torch.data.loader import to_device
        from lwdetr_tpu_torch.train import engine

        put = self.spans.wrap("to_device", lambda b: to_device(b, self.device))
        enqueue = self.spans.wrap("enqueue", self.step)
        fetching = []

        def step(*args):
            out = enqueue(*args)
            self.spans.open("metric fetch")
            fetching.append(True)
            return out

        def poll():
            if fetching:
                fetching.pop()
                self.spans.close()
            return should_stop is not None and should_stop()

        matcher = self.spans.wrap("matcher", engine_matcher())
        with mock.patch("lwdetr_tpu_torch.models.criterion.hungarian_match", matcher):
            engine.train_one_epoch(step, self.state, loader, 0, NITER_PER_EPOCH, put_fn=put,
                                   logger=self.log, should_stop=poll,
                                   drop_path_sched=self.dp_sched, dropout_sched=self.do_sched)
        if fetching:
            self.spans.close()

    # ------------------------------------------------------------------ window

    def blocks(self, count=None):
        """Blocks of the sizes, each in its own order (`count` steps, or on)."""
        i = 0
        while True:
            for s in self.block():
                if count is not None and i >= count:
                    return
                self.stepped.append(s)
                i += 1
                yield self.pool[s]

    def run_window(self, seconds: float) -> dict:
        tr.sync(self.device)
        self.stepped: List[int] = []
        self.spans.recording = True
        t0 = time.perf_counter()
        stop = t0 + seconds
        # the window ends with a whole block, so that it holds every size alike
        whole = len(self.sizes)
        self.epoch(self.blocks(), should_stop=lambda: (time.perf_counter() >= stop
                                                       and len(self.stepped) % whole == 0))
        tr.sync(self.device)
        t1 = time.perf_counter()
        self.spans.recording = False
        self.window = {"window_s": t1 - t0, "images": len(self.stepped) * self.batch,
                       "batches": len(self.stepped), "done": len(self.stepped),
                       "sizes": list(self.stepped)}
        return self.window

    def end_to_end(self) -> Dict[str, float]:
        return {"train_img_per_s": self.window["images"] / self.window["window_s"]}

    def run_traced(self):
        from lwdetr_tpu_torch.models.criterion import SetCriterion

        stages = tr.StageRanges(self.state.model)
        crit = SetCriterion.__call__

        def criterion(this, *args, **kwargs):
            stages.open(tr.CRITERION)
            try:
                out = crit(this, *args, **kwargs)
            finally:
                stages.close()
            stages.open(tr.BACKWARD)  # closed where the step clips the gradients
            return out

        clip = torch.nn.utils.clip_grad_norm_

        def clip_opening_optimizer(*args, **kwargs):
            stages.close()
            stages.open(tr.OPTIMIZER)  # closed when the step returns
            return clip(*args, **kwargs)

        inner = self.step

        def step(*args, **kwargs):
            try:
                return inner(*args, **kwargs)
            finally:
                stages.close()

        count = TRACE_STEPS
        self.stepped = []
        self.spans.traced = stages.enabled = True
        try:
            with tr.SamplerPoints() as points, \
                    mock.patch.object(SetCriterion, "__call__", criterion), \
                    mock.patch.object(torch.nn.utils, "clip_grad_norm_", clip_opening_optimizer), \
                    mock.patch.object(self, "step", step), tr.profiled(self.device) as holder:
                self.epoch(self.blocks(count=count))
        finally:
            self.spans.traced = stages.enabled = False
            stages.remove()
        self.sampler_positions = points.positions()
        return holder["trace"], list(self.stepped)

    # ------------------------------------------------------------------ check

    def release(self) -> None:
        snap = self.snapshots
        self.program = {
            "losses": [float(x) for x in snap["losses"]],
            "grads": {k: v.float() for k, v in snap["grads"].items()},
            "delta": {k: snap["params"][k] - self.params0[k] for k in snap["params"]},
            "ema": {k: snap["ema"].get(k, self.params0[k]) - self.params0[k]
                    for k in snap["params"]},
        }
        del self.state, self.program_step, self.criterion, self.snapshots, self.params0
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, mode: str = "f32", batch_fraction: float = 1.0) -> dict:
        """The reference's readings over the first steps of set-up."""
        conf = self.cell.config
        model = ref.build(conf["model"], self.sd, device=self.device, train=True)
        trainer = rtrain.Trainer(model, conf["model"], conf["train"])
        losses = []
        budget = REFERENCE_ATTENTION_BYTES
        depth = conf["model"]["vit_encoder_num_layers"]
        with ref.precision(mode):
            for k in range(self.check_steps):
                batch = self.pool[self.first_block[k]]
                n = max(1, int(round(self.batch * batch_fraction)))
                images = torch.as_tensor(batch["images"][:n], device=self.device)
                targets = [{"labels": torch.as_tensor(batch["labels"][i][batch["valid"][i]],
                                                      device=self.device).long(),
                            "boxes": torch.as_tensor(batch["boxes"][i][batch["valid"][i]],
                                                     device=self.device)} for i in range(n)]
                losses.append(trainer.step(images, targets, self.ref_drop(k, depth, n),
                                           budget))
        params = dict(model.named_parameters())
        out = {"losses": losses, "grads": trainer.first_grads,
               "delta": {k: params[k].detach() - self.sd[k] for k in params},
               "ema": {k: trainer.ema[k] - self.sd[k].double() for k in params},
               "ema_value": {k: trainer.ema[k] for k in params}}
        del model, trainer
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out

    def ref_drop(self, k: int, depth: int, n: int):
        """The reference's (keep rates, masks) of step k: the recipe's
        stochastic-depth ramp over the blocks (linspace(0, 1) x the rate, in
        float32) and the masks the benchmark drew for the program's step, two
        a block whose rate is above 0, in the order the step drew them."""
        rate = np.float32(self.cell.config["model"]["drop_path"])
        if not rate:
            return None
        ramp = rate * np.append(
            np.arange(depth - 1, dtype=np.float32) * (np.float32(1) / np.float32(depth - 1)),
            np.float32(1))
        kept = iter(self.masks.kept[k])
        masks = [(next(kept)[:n * 16], next(kept)[:n * 16]) if r != 0 else (None, None)
                 for r in ramp]
        return [float(np.float32(1) - r) for r in ramp], masks

    def readings(self, prog: dict, refd: dict) -> Dict[str, float]:
        gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], refd["losses"])]
        out = {"loss_gap": max(gaps)}
        out.update({f"loss{k + 1}_gap": g for k, g in enumerate(gaps)})
        resolved = rtrain.above_resolution(refd["ema"], refd["ema_value"])
        for key in ("grads", "delta", "ema"):
            keep = resolved if key == "ema" else refd[key]
            ref_key = {k: refd[key][k] for k in keep}
            worst, leaf, n, _ = rtrain.leaf_gaps(prog[key], ref_key, refd["grads"])
            median = rtrain.leaf_gaps(prog[key], ref_key, refd["grads"], worst=False)[0]
            out[f"{key}_worst_leaf_gap"], out[f"{key}_median_leaf_gap"] = worst, median
            print(f"{key}: worst leaf {leaf} of {n}: {worst!r}; median leaf {median!r}",
                  file=sys.stderr)
        # the first gradient by its worst leaf; the change after the steps, of
        # the parameters and of the EMA (over the leaves whose EMA moved by
        # many float32 ulps), by its median leaf (the worst is one small
        # leaf's Adam round-off, or an EMA change of a few ulps)
        out["grad_gap"] = out["grads_worst_leaf_gap"]
        out["delta_gap"] = out["delta_median_leaf_gap"]
        out["ema_gap"] = out["ema_median_leaf_gap"]
        return out

    def check(self, checks: Checks) -> None:
        self.ref32 = refd = self.reference()
        print(f"losses program {self.program['losses']} reference {refd['losses']}",
              file=sys.stderr)
        self.reading = self.readings(self.program, refd)
        for k, limit in self.cell.limits.items():
            checks.add(k, self.reading[k], limit)

    def control(self) -> Dict[str, Dict[str, float]]:
        """The control's readings (the reference with TF32 products in the
        program's place) and those of a planted fault (half of each batch
        left out, the mean taken over the rest), against the float32
        reference. A step that leaves the state unchanged reads 1 by
        `delta_gap`'s measure and needs no run."""
        return {"tf32": self.readings(self.reference("tf32"), self.ref32),
                "half_batch": self.readings(self.reference(batch_fraction=0.5), self.ref32)}


def engine_matcher():
    from lwdetr_tpu_torch.models import criterion

    return criterion.hungarian_match
