"""Epoch sampler: weighted draws with replacement, seeded per
(seed, epoch). The distributed samplers wait for the multi-device
(``parallel/``) slice."""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedRandomSampler", "DistributedWeightedSampler",
           "SequentialDistributedSampler"]


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


def _not_ported(name):
    class _Sampler:
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} is not ported yet: it comes with multi-device "
                "training (parallel/)")

    _Sampler.__name__ = name
    return _Sampler


DistributedWeightedSampler = _not_ported("DistributedWeightedSampler")
SequentialDistributedSampler = _not_ported("SequentialDistributedSampler")
