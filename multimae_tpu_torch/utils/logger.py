"""Metric logging (counterpart of multimae_tpu/utils/logger.py; reference
utils/logger.py).

SmoothedValue / MetricLogger with the reference's printed format (iter
time, data time, ETA, memory) and the cross-process sum over
torch.distributed. Wandb is optional and imported only when asked for;
log.txt is rank 0's JSON lines (reference run_pretraining_multimae.py:449-451).
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from multimae_tpu_torch.parallel.dist import is_main_process, world_size


class SmoothedValue:
    """Windowed + global average meter (reference logger.py:24-83)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum count and total over the processes (reference :42-53)."""
        if world_size() == 1:
            return
        backend = torch.distributed.get_backend()
        device = "cuda" if backend == "nccl" else "cpu"
        t = torch.tensor([self.count, self.total], dtype=torch.float64, device=device)
        torch.distributed.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    """reference logger.py:86-167."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            if hasattr(v, "item"):
                v = float(v)
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "",
                  total: Optional[int] = None):
        """Yield from `iterable`, printing progress every `print_freq` items
        with the iteration and data-wait times."""
        i = 0
        if total is None:
            try:
                total = len(iterable)
            except TypeError:
                total = None
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                mem = device_memory_string()
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    print(
                        f"{header} [{i}/{total}] eta: {eta_str} {self} "
                        f"time: {iter_time} data: {data_time}{mem}",
                        flush=True,
                    )
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} "
                          f"data: {data_time}{mem}", flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start_time
        print(f"{header} Total time: {str(datetime.timedelta(seconds=int(elapsed)))}")


def device_memory_string() -> str:
    """' max mem: NNNNMB' as the reference prints torch.cuda's
    max_memory_allocated; empty without a card."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return ""
    return f" max mem: {torch.cuda.max_memory_allocated() // (1024 * 1024)}MB"


class WandbLogger:
    """Thin optional wandb wrapper (reference logger.py:170-198)."""

    def __init__(self, args):
        try:
            import wandb
        except ImportError:
            print("[logger] wandb not available; disabling wandb logging")
            self._wandb = None
            return
        self._wandb = wandb
        self._step = 0
        wandb.init(
            config=args,
            entity=getattr(args, "wandb_entity", None),
            project=getattr(args, "wandb_project", None),
            name=getattr(args, "wandb_run_name", None),
        )

    def set_step(self, step: Optional[int] = None):
        if self._wandb is None:
            return
        self._step = step if step is not None else self._step + 1

    def update(self, metrics: Dict):
        if self._wandb is None:
            return
        self._wandb.log(metrics, step=self._step)

    def flush(self):
        pass


def write_log_line(output_dir: str, stats: Dict):
    """rank-0 JSON-lines log.txt (reference run_pretraining:449-451)."""
    if not is_main_process() or not output_dir:
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(stats) + "\n")
