"""Atrous spatial pyramid pooling (NCHW).

A 1x1 conv branch, one dilated 3x3 branch per atrous rate, and an
image-pooling branch (global average, 1x1 conv, ReLU, no batch norm,
broadcast back), concatenated and projected by a 1x1 conv with batch
norm and ReLU, then dropout (train mode only). Children carry the flax
names of the JAX package's module: ``Conv_0`` / ``BatchNorm_0`` the 1x1
branch, ``Conv_i`` / ``BatchNorm_i`` the i-th atrous branch, then the
pooling conv and the projection conv with the last batch norm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from empanada_torch.models.blocks import Conv2d, bn, cast

__all__ = ["ASPP"]


class ASPP(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, in_features, out_channels, atrous_rates=(2, 4, 6),
                 dropout_p=0.5):
        super().__init__()
        oc = out_channels
        self.n_rates = len(atrous_rates)
        self.Conv_0 = Conv2d(in_features, oc, 1, bias=False)
        self.BatchNorm_0 = bn(oc)
        for i, rate in enumerate(atrous_rates, 1):
            self.add_module(f"Conv_{i}", Conv2d(
                in_features, oc, 3, padding=rate, dilation=rate, bias=False))
            self.add_module(f"BatchNorm_{i}", bn(oc))
        n = self.n_rates
        self.add_module(f"Conv_{n + 1}", Conv2d(in_features, oc, 1,
                                                bias=False))
        self.add_module(f"Conv_{n + 2}", Conv2d((n + 2) * oc, oc, 1,
                                                bias=False))
        self.add_module(f"BatchNorm_{n + 1}", bn(oc))
        self.dropout = nn.Dropout(dropout_p)

    def forward(self, x):
        n, dt = self.n_rates, self.compute_dtype
        branches = [cast(F.relu(getattr(self, f"BatchNorm_{i}")(
            getattr(self, f"Conv_{i}")(x))), dt) for i in range(n + 1)]
        pooled = F.relu(getattr(self, f"Conv_{n + 1}")(
            x.mean(dim=(2, 3), keepdim=True)))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        out = getattr(self, f"Conv_{n + 2}")(torch.cat(branches, dim=1))
        out = cast(F.relu(getattr(self, f"BatchNorm_{n + 1}")(out)), dt)
        return self.dropout(out)
