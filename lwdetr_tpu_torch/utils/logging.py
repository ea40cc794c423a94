"""Metric logging: windowed meters + JSON-lines epoch log.

The port's own copy of `lwdetr_tpu/utils/logging.py`: the reference's
`util/misc.py:37-256` (SmoothedValue, MetricLogger) and its per-epoch JSON
log (`main.py:361-400`). Cross-process metric synchronization (the
reference's all_reduce of [count, total]) is `sync()` over
`torch.distributed` when a process group of more than one is up, on the
device the backend reduces on (`parallel/dist.py::collective_device`).
"""
from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

from lwdetr_tpu_torch.parallel.dist import collective_device, is_main_process, world_size


class SmoothedValue:
    """Track a series with a smoothing window (reference util/misc.py:37-96)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def sync(self):
        """Aggregate count/total across processes (multi-process runs)."""
        if world_size() == 1:
            return
        import torch
        import torch.distributed as dist

        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=collective_device())
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self):
        import numpy as np

        return float(np.median(list(self.deque))) if self.deque else 0.0

    @property
    def avg(self):
        import numpy as np

        return float(np.mean(list(self.deque))) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.sync()

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = "", total=None,
                  logger=print):
        """Yield items while logging iter/data timing
        (reference util/misc.py:204-256)."""
        i = 0
        total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    logger(f"{header} [{i}/{total}] eta: {eta_str} {self} "
                           f"time: {iter_time} data: {data_time}")
                else:
                    logger(f"{header} [{i}] {self} time: {iter_time} data: {data_time}")
            i += 1
            end = time.time()
        total_time = time.time() - start
        logger(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))}")


def write_log_line(output_dir: str, record: dict):
    """JSON-lines log.txt, rank-0 only (reference main.py:398-411)."""
    if not output_dir or not is_main_process():
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(record) + "\n")


class BestMetricHolder:
    """Track best regular/EMA mAP (reference util/utils.py:35-106)."""

    def __init__(self, use_ema: bool = False):
        self.best = -1.0
        self.best_ema = -1.0
        self.use_ema = use_ema

    def update(self, value: float, epoch: int, is_ema: bool = False) -> bool:
        if is_ema:
            if value > self.best_ema:
                self.best_ema = value
                return True
            return False
        if value > self.best:
            self.best = value
            return True
        return False

    def summary(self) -> dict:
        out = {"best_regular": self.best}
        if self.use_ema:
            out["best_ema"] = self.best_ema
        return out
