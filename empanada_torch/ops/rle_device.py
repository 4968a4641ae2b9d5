"""On-device run-boundary extraction, batched over slices.

Row-split constant-value runs of (B, H, W) int32 maps into static-size
buffers, so only O(#runs) int32 cross to the host. Contract (same as
the JAX package): runs in row-major order; ``starts``/``ends`` raveled
(end exclusive) and padded with -1, ``values`` padded with 0; ``n_runs``
is the true count even when it exceeds ``max_runs`` (the buffers then
hold the first ``max_runs`` runs). Compaction is a cumsum rank +
scatter, with no host synchronization.
"""

from __future__ import annotations

import torch

__all__ = ["extract_runs", "extract_fg_runs"]


def _runs(pan: torch.Tensor, max_runs: int, fg_only: bool):
    b, h, w = pan.shape
    dev = pan.device
    is_start = torch.ones_like(pan, dtype=torch.bool)
    is_start[:, :, 1:] = pan[:, :, 1:] != pan[:, :, :-1]
    # end of the run starting at col c = the next start col after c (or
    # w): a reversed running min of the start columns
    cols = torch.arange(w, dtype=torch.int32, device=dev)
    start_col = torch.where(is_start, cols, torch.full_like(cols, w))
    sufmin = torch.flip(torch.cummin(torch.flip(start_col, [2]), dim=2)
                        .values, [2])
    nxt = torch.cat([sufmin[:, :, 1:],
                     torch.full((b, h, 1), w, dtype=torch.int32,
                                device=dev)], dim=2)
    keep = is_start & (pan != 0) if fg_only else is_start
    keep = keep.reshape(b, -1)
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    n_runs = keep.sum(dim=1, dtype=torch.int32)
    slot = torch.where(keep & (rank < max_runs), rank.long(),
                       torch.full_like(rank, max_runs, dtype=torch.long))
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None] * w
    flat_start = (rows + cols[None, :]).expand(b, h, w).reshape(b, -1)
    flat_end = (rows + nxt).reshape(b, -1)
    starts = torch.full((b, max_runs + 1), -1, dtype=torch.int32, device=dev)
    ends = torch.full((b, max_runs + 1), -1, dtype=torch.int32, device=dev)
    values = torch.zeros((b, max_runs + 1), dtype=torch.int32, device=dev)
    starts.scatter_(1, slot, flat_start)
    ends.scatter_(1, slot, flat_end)
    values.scatter_(1, slot, pan.reshape(b, -1).to(torch.int32))
    return (starts[:, :max_runs], ends[:, :max_runs], values[:, :max_runs],
            n_runs)


def extract_runs(pan: torch.Tensor, max_runs: int):
    """All row-split runs of (B, H, W) maps -> (starts, ends, values)
    each (B, max_runs) int32 and n_runs (B,) int32. On overflow the last
    kept run's end reads H*W, as in the JAX package."""
    starts, ends, values, n_runs = _runs(pan, max_runs, fg_only=False)
    n = pan.shape[1] * pan.shape[2]
    ends[:, -1] = torch.where(n_runs > max_runs, n, ends[:, -1])
    return starts, ends, values, n_runs


def extract_fg_runs(pan: torch.Tensor, max_runs: int):
    """Row-split runs of NONZERO values only (background extents are
    implicit); same outputs as ``extract_runs``."""
    return _runs(pan, max_runs, fg_only=True)
