"""Batch loader: torch's DataLoader with worker processes, fed the JAX
package's batches.

``EpochBatchSampler`` yields exactly the JAX loader's batches for a
(seed, epoch): the sampler's indices, or a permutation from
``default_rng((seed, epoch))`` when shuffling, cut into batches (the
short tail dropped with ``drop_last``). Examples are built in worker
processes (augmentation and target creation hold the interpreter lock
in numpy code, which threads would serialize), collated into tensors
and, for a CUDA consumer, pinned. Each epoch, worker i augments from
the i-th of ``num_workers`` streams spawned from the transforms'
``SeedSequence``: with one worker that is the JAX loader's draw
sequence, example for example.

Data-parallel training cuts each global batch into rows by rank
(``num_replicas``, ``rank``): rank r takes rows [r*b, (r+1)*b) of every
global batch, b = batch_size / num_replicas, so the ranks together load
exactly one process's batches, index for index.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["DataLoader", "EpochBatchSampler", "collate"]


def collate(examples):
    """Stack a list of example dicts: arrays into one tensor per key,
    numbers into a tensor, anything else (fname) into a list."""
    out = {}
    for key in examples[0]:
        vals = [ex[key] for ex in examples]
        if isinstance(vals[0], np.ndarray):
            out[key] = torch.from_numpy(np.stack(vals))
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = torch.as_tensor(np.asarray(vals))
        else:
            out[key] = vals
    return out


class EpochBatchSampler:
    """The JAX loader's batches of one epoch (``set_epoch``); with
    ``num_replicas`` > 1, this rank's rows of each of them."""

    def __init__(self, dataset_len, batch_size, sampler=None, shuffle=False,
                 drop_last=False, seed=0, num_replicas=1, rank=0):
        if batch_size % num_replicas:
            raise ValueError(f"batch of {batch_size} does not divide over "
                             f"{num_replicas} ranks")
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.sampler = sampler
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = np.arange(self.dataset_len)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx.tolist()

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None \
            else self.dataset_len
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        indices = self._indices()
        per = self.batch_size // self.num_replicas
        for i in range(0, len(indices), self.batch_size):
            batch = indices[i:i + self.batch_size]
            if len(batch) == self.batch_size or not self.drop_last:
                yield batch[self.rank * per:(self.rank + 1) * per]


def _init_worker(streams, worker_id):
    dataset = torch.utils.data.get_worker_info().dataset
    transforms = getattr(dataset, "transforms", None)
    if hasattr(transforms, "set_stream"):
        transforms.set_stream(streams[worker_id])


class DataLoader:
    """Epoch-seeded batches built by ``num_workers`` worker processes
    (at least one), ``prefetch`` batches ahead per worker; this rank's
    rows of them with ``num_replicas`` > 1 (``EpochBatchSampler``)."""

    def __init__(self, dataset, batch_size=1, sampler=None, shuffle=False,
                 drop_last=False, num_workers=4, prefetch=2, seed=0,
                 pin_memory=False, num_replicas=1, rank=0):
        self.dataset = dataset
        self.batch_sampler = EpochBatchSampler(
            len(dataset), batch_size, sampler, shuffle, drop_last, seed,
            num_replicas, rank)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.pin_memory = pin_memory

    def set_epoch(self, epoch):
        self.batch_sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        transforms = getattr(self.dataset, "transforms", None)
        streams = transforms.seed_seq.spawn(self.num_workers) \
            if hasattr(transforms, "seed_seq") else [None] * self.num_workers
        loader = torch.utils.data.DataLoader(
            self.dataset, batch_sampler=self.batch_sampler,
            num_workers=self.num_workers, collate_fn=collate,
            pin_memory=self.pin_memory, prefetch_factor=self.prefetch,
            worker_init_fn=functools.partial(_init_worker, streams))
        yield from loader
