"""Epoch samplers: weighted draws with replacement, seeded per
(seed, epoch), and their distributed forms. ``num_replicas`` and
``rank`` default to ``torch.distributed``'s world size and rank (1 and
0 when no process group is up)."""

from __future__ import annotations

import math

import numpy as np

__all__ = ["WeightedRandomSampler", "DistributedWeightedSampler",
           "SequentialDistributedSampler"]


def _replicas(num_replicas, rank):
    if num_replicas is None or rank is None:
        from empanada_torch.parallel.mesh import world

        size, me = world()
        num_replicas = num_replicas or size
        rank = rank if rank is not None else me
    return num_replicas, rank


class WeightedRandomSampler:
    """Draws ``num_samples`` indices with replacement, with probability
    proportional to ``weights``, from ``default_rng((seed, epoch))``."""

    def __init__(self, weights, num_samples=None, seed=0):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples or len(self.weights)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        p = self.weights / self.weights.sum()
        return iter(rng.choice(len(p), size=self.num_samples,
                               replace=True, p=p).tolist())


class DistributedWeightedSampler:
    """Rank-strided subsample + per-rank weighted multinomial draw with
    epoch-seeded determinism (reference sampler.py:10-85)."""

    def __init__(self, dataset_len, weights, num_replicas=None, rank=None,
                 shuffle=True, drop_last=True, seed=0):
        num_replicas, rank = _replicas(num_replicas, rank)
        self.dataset_len = dataset_len
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

        if drop_last and dataset_len % num_replicas != 0:
            self.num_samples = math.ceil(
                (dataset_len - num_replicas) / num_replicas)
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        if self.shuffle:
            indices = rng.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)

        if not self.drop_last:
            pad = self.total_size - len(indices)
            if pad > 0:
                reps = math.ceil(pad / len(indices))
                indices = np.concatenate(
                    [indices] + [indices] * reps)[:self.total_size]
        else:
            indices = indices[:self.total_size]

        # rank-strided subsample, then weighted draw among those indices
        local = indices[self.rank:self.total_size:self.num_replicas]
        w = self.weights[local]
        p = w / w.sum()
        draw = rng.choice(local, size=self.num_samples, replace=True, p=p)
        return iter(draw.tolist())


class SequentialDistributedSampler:
    """Shard [0, n) round-robin across replicas, padding the tail (the
    reference's DistributedEvalSampler, inference3d_multigpu.py)."""

    def __init__(self, dataset_len, num_replicas=None, rank=None):
        num_replicas, rank = _replicas(num_replicas, rank)
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_samples = math.ceil(dataset_len / num_replicas)

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        indices = list(range(self.rank, self.dataset_len, self.num_replicas))
        while len(indices) < self.num_samples:
            indices.append(self.dataset_len - 1)
        return iter(indices)
