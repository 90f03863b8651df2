"""Host-side data loading: a torch DataLoader over the folder datasets
(counterpart of multimae_tpu/data/loader.py, which uses grain).

* Sharding: each epoch is one permutation of the records drawn from
  (seed, epoch); rank r of R takes every R-th record of it from r on, after
  the permutation is cut to a multiple of R (DistributedSampler with
  drop_last, grain's ShardOptions with drop_remainder): each record appears
  at most once per epoch across the ranks.
* Per-record randomness comes from (seed, epoch, record index), as grain's
  per-record generator does for `_LoadAndAugment.random_map` (JAX
  loader.py:49-61): the corrupt-file resample (at most 20 attempts) and
  the transform's random.Random. Batches are therefore the same for any
  number of worker processes.
* `get_state` / `set_state`: the seed, the epoch and the number of batches
  of it already handed out, saved with a checkpoint so a resumed run
  continues the same order. The position is global, so it is the same on
  every rank.
* `EvalLoader`: one unshuffled pass per iteration that hands out the last
  partial batch (the JAX CLI's `build_loader(..., shuffle=False,
  num_epochs=1, drop_remainder=False)`). Across R ranks it shards as
  grain's ShardOptions(drop_remainder=True) does there: the records are
  cut to a multiple of R and rank r reads the r-th contiguous block, so
  each record the JAX sharding keeps is read once, and the last
  len % R records by no rank. One process reads every record.
Workers are spawned processes, kept for the life of the loader. The
training batches run on from one epoch into the next, so the workers
prefetch the next epoch's first batches while the current one ends, as
grain's sampler does over its epochs. The parent builds the native image
library before the workers start, so no worker compiles it. `close` lets
the workers hand over the batches they are making before it stops them:
a worker that exits while its queue's feeder thread still sends a batch
aborts ("terminate called without an active exception": CPython stops
that daemon thread with pthread_exit inside torch's pickling of a tensor,
and the unwind through the C++ frame calls std::terminate). `close`
raises if a worker did not exit cleanly.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from multimae_tpu_torch import native

MAX_ATTEMPTS = 20


def steps_per_epoch(dataset_len: int, global_batch_size: int) -> int:
    return dataset_len // global_batch_size


def epoch_shard(num_records: int, epoch: int, *, seed: int, shard_index: int,
                shard_count: int, shuffle: bool = True) -> np.ndarray:
    """The record indices rank `shard_index` of `shard_count` reads in `epoch`."""
    order = (np.random.default_rng([seed, epoch]).permutation(num_records) if shuffle
             else np.arange(num_records))
    per_shard = num_records // shard_count
    return order[:per_shard * shard_count][shard_index::shard_count]


class ShardBatches(torch.utils.data.Sampler):
    """Yields this rank's batches of (epoch, record index) keys, epoch after
    epoch without end, from batch `start` of `epoch` on; each epoch's shard
    is cut to whole batches."""

    def __init__(self, num_records: int, batch: int, *, seed: int, shard_index: int,
                 shard_count: int, shuffle: bool = True):
        self.num_records = num_records
        self.batch = batch
        self.kw = dict(seed=seed, shard_index=shard_index, shard_count=shard_count,
                       shuffle=shuffle)
        self.epoch = 0
        self.start = 0

    def __iter__(self):
        epoch, start = self.epoch, self.start
        while True:
            shard = epoch_shard(self.num_records, epoch, **self.kw)
            for b in range(start, len(shard) // self.batch):
                yield [(epoch, int(i)) for i in shard[b * self.batch:(b + 1) * self.batch]]
            epoch, start = epoch + 1, 0


class LoadAndAugment(torch.utils.data.Dataset):
    """Loads and augments one record, drawing from (seed, epoch, index)."""

    def __init__(self, dataset, transform: Optional[Callable], seed: int):
        self.dataset = dataset
        self.transform = transform
        self.seed = seed

    def _load(self, index: int, rng: np.random.Generator):
        """The corrupt-file retry (reference utils/dataset_folder.py:166-173):
        a record that fails to load is replaced by one drawn from the
        record's own generator."""
        for _ in range(MAX_ATTEMPTS):
            try:
                return self.dataset.load_raw(index)
            except (OSError, ValueError) as e:
                print(f"[loader] sample {index} failed ({e}); resampling", flush=True)
                index = int(rng.integers(0, len(self.dataset)))
        raise RuntimeError(f"{MAX_ATTEMPTS} consecutive corrupt samples: the dataset "
                           "looks damaged")

    def __getitem__(self, key) -> Dict[str, np.ndarray]:
        epoch, index = key
        rng = np.random.default_rng([self.seed, epoch, index])
        sample, target = self._load(index, rng)
        if self.transform is not None:
            sample = self.transform(sample, rng=random.Random(int(rng.integers(0, 2**63 - 1))))
        sample = dict(sample)
        sample["label"] = np.asarray(target, np.int64)
        return sample

    def __len__(self) -> int:
        return len(self.dataset)


def data_loader(dataset, transform: Optional[Callable], seed: int, num_workers: int,
                pin_memory: bool, **batching) -> torch.utils.data.DataLoader:
    """A DataLoader of LoadAndAugment, batched by `batching` (DataLoader's
    batch_sampler, or sampler, batch_size and drop_last), its workers
    spawned and kept for the loader's life. Builds the native image library
    first, so that no worker compiles it."""
    native.lib()
    workers = dict(multiprocessing_context="spawn", persistent_workers=True,
                   prefetch_factor=4) if num_workers else {}
    return torch.utils.data.DataLoader(
        LoadAndAugment(dataset, transform, seed), num_workers=num_workers, collate_fn=collate,
        pin_memory=pin_memory, **batching, **workers)


def stop_workers(loader: torch.utils.data.DataLoader) -> None:
    """Stop `loader`'s persistent workers once they have handed over the
    batches they were making (see the module docstring); raise if one did
    not exit cleanly."""
    it, loader._iterator = loader._iterator, None
    workers = getattr(it, "_workers", None)
    if not workers:
        return
    for _ in range(it._tasks_outstanding):
        it._get_data()
    it._tasks_outstanding = 0
    it._shutdown_workers()
    failed = [(w.pid, w.exitcode) for w in workers if w.exitcode != 0]
    if failed:
        raise RuntimeError(f"loader workers did not exit cleanly: (pid, exit code) {failed}")


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """Stack each key; integer arrays become int64."""
    out = {}
    for k in samples[0]:
        arr = np.stack([s[k] for s in samples])
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int64)
        out[k] = torch.from_numpy(arr)
    return out


class Loader:
    """Endless iterator of this rank's batches ({task: tensor}, "label"),
    epoch after epoch, each epoch `steps_per_epoch` batches."""

    def __init__(self, dataset, transform: Optional[Callable], *, global_batch_size: int,
                 seed: int = 0, shuffle: bool = True, num_workers: int = 0,
                 shard_index: int = 0, shard_count: int = 1, pin_memory: bool = False):
        if global_batch_size % shard_count:
            raise ValueError(f"global batch {global_batch_size} does not split over "
                             f"{shard_count} ranks")
        self.seed = seed
        self.local_batch = global_batch_size // shard_count
        self.steps_per_epoch = steps_per_epoch(len(dataset), global_batch_size)
        if self.steps_per_epoch == 0:
            raise ValueError(f"{len(dataset)} records make no global batch of "
                             f"{global_batch_size}")
        self.batches = ShardBatches(len(dataset), self.local_batch, seed=seed,
                                    shard_index=shard_index, shard_count=shard_count,
                                    shuffle=shuffle)
        self.loader = data_loader(dataset, transform, seed, num_workers, pin_memory,
                                  batch_sampler=self.batches)
        self.epoch = 0
        self.batch = 0
        self._it = None

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self.batch == self.steps_per_epoch:
            self.epoch, self.batch = self.epoch + 1, 0
        if self._it is None:
            self.batches.epoch, self.batches.start = self.epoch, self.batch
            self._it = iter(self.loader)
        out = next(self._it)
        self.batch += 1
        return out

    def close(self) -> None:
        """Stop the worker processes."""
        self._it = None
        stop_workers(self.loader)

    def get_state(self) -> Dict[str, int]:
        return {"seed": self.seed, "epoch": self.epoch, "batch": self.batch}

    def set_state(self, state: Dict[str, Any]) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(f"the saved data order was drawn with seed {state['seed']}, "
                             f"this loader's with {self.seed}")
        if not 0 <= int(state["batch"]) <= self.steps_per_epoch:
            raise ValueError(f"saved position {state} lies outside an epoch of "
                             f"{self.steps_per_epoch} batches")
        self.epoch, self.batch, self._it = int(state["epoch"]), int(state["batch"]), None


def eval_shard(num_records: int, *, shard_index: int, shard_count: int) -> np.ndarray:
    """The record indices rank `shard_index` of `shard_count` evaluates:
    its contiguous block of the records cut to a multiple of shard_count."""
    per_shard = num_records // shard_count
    return np.arange(shard_index * per_shard, (shard_index + 1) * per_shard)


class EvalLoader:
    """Each iteration is one pass over this rank's shard in record order, in
    batches of global_batch_size / shard_count, the last one partial."""

    def __init__(self, dataset, transform: Optional[Callable], *, global_batch_size: int,
                 seed: int = 0, num_workers: int = 0, shard_index: int = 0,
                 shard_count: int = 1, pin_memory: bool = False):
        if global_batch_size % shard_count:
            raise ValueError(f"global batch {global_batch_size} does not split over "
                             f"{shard_count} ranks")
        self.indices = eval_shard(len(dataset), shard_index=shard_index,
                                  shard_count=shard_count)
        self.loader = data_loader(dataset, transform, seed, num_workers, pin_memory,
                                  batch_size=global_batch_size // shard_count,
                                  sampler=[(0, int(i)) for i in self.indices], drop_last=False)

    def __iter__(self):
        return iter(self.loader)

    def __len__(self) -> int:
        return len(self.loader)

    def close(self) -> None:
        """Stop the worker processes."""
        stop_workers(self.loader)
