"""Nearest-center pixel grouping: the CUDA kernel and its plain version.

Replaces the TPU kernel ``empanada_tpu/ops/pallas_group.py``
(``_kernel`` / ``group_pixels_pallas``). For each pixel (i, j) of slice
b, loc = (i*step + dy, j*step + dx); the id is 1 + the index of the
center k minimizing d_k = |loc - step*c_k|^2, where an invalid center
counts as d_k = 1e10, ties go to the lowest k and a NaN distance wins
(argmin's first minimum, as ``torch.argmin`` and ``jnp.argmin`` give
it); a slice with no valid center is 0 everywhere.

``group_pixels_batched`` launches ``csrc/group_pixels.cu`` for CUDA
tensors (one launch per block of B slices, any K >= 1) and uses the
plain version only for CPU tensors; on CUDA it launches or raises. The
kernel prunes, per tile of pixels, the centers that cannot win there and
scans the rest exactly; see the source for the design and why its ids
equal the plain version's.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["group_pixels_batched", "group_pixels_plain", "check_inputs",
           "tile_stats", "LAUNCHES", "LAUNCHES_BY_CARD", "reset_launches",
           "count_launches", "SLAB_ELEMENTS"]

# launches of the CUDA kernel since the last reset_launches(), in all and
# by card index
LAUNCHES = {"group_pixels": 0}
LAUNCHES_BY_CARD = {}

# elements of one (B, H*W, chunk) distance slab of the plain version: the
# JAX package's guard (ops/postprocess.py group_pixels), so a full-
# resolution slice with many centers is chunked over K, not materialized
SLAB_ELEMENTS = 1 << 25

_fn = None


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    LAUNCHES_BY_CARD.clear()


def count_launches(card, n=1):
    """Add ``n`` launches on card index ``card``: a replayed CUDA graph
    adds the launches its capture recorded."""
    LAUNCHES["group_pixels"] += n
    LAUNCHES_BY_CARD[card] = LAUNCHES_BY_CARD.get(card, 0) + n


def group_pixels_plain(centers, valid, offsets, step: float = 1.0,
                       slab_elements: int = SLAB_ELEMENTS):
    """Broadcast distance + first-minimum argmin, chunked over K so that
    no distance slab holds more than ``slab_elements`` elements.

    centers (B, K, 2) int (y, x) in grid units; valid (B, K) bool;
    offsets (B, H, W, 2) float32 (dy, dx) in full-resolution units.
    Returns (B, H, W) int32. Chunks carry a running (best_d, best_k):
    a later chunk takes a pixel on a strictly smaller distance, or on a
    NaN where the best so far is not NaN, so the ids equal one argmin
    over all K."""
    b, h, w, _ = offsets.shape
    k = centers.shape[1]
    dev = offsets.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) * step
    xs = torch.arange(w, dtype=torch.float32, device=dev) * step
    off = offsets.float()
    loc_y = (ys[None, :, None] + off[..., 0]).reshape(b, h * w, 1)
    loc_x = (xs[None, None, :] + off[..., 1]).reshape(b, h * w, 1)
    ctr = centers.float() * step
    valid = valid.bool()
    big = torch.tensor(1e10, dtype=torch.float32, device=dev)
    chunk = max(1, slab_elements // max(1, b * h * w))
    best_d = best_k = None
    for k0 in range(0, k, chunk):
        c = ctr[:, None, k0:k0 + chunk]
        dy = loc_y - c[..., 0]
        dx = loc_x - c[..., 1]
        d = torch.where(valid[:, None, k0:k0 + chunk], dy * dy + dx * dx, big)
        idx = torch.argmin(d, dim=2, keepdim=True)
        val = torch.gather(d, 2, idx)[..., 0]
        idx = idx[..., 0] + k0
        if best_d is None:
            best_d, best_k = val, idx
            continue
        take = (val < best_d) | (val.isnan() & ~best_d.isnan())
        best_d = torch.where(take, val, best_d)
        best_k = torch.where(take, idx, best_k)
    ids = 1 + best_k.to(torch.int32)
    any_valid = valid.any(dim=1)[:, None]
    ids = torch.where(any_valid, ids, torch.zeros_like(ids))
    return ids.reshape(b, h, w)


def check_inputs(centers, valid, offsets):
    """Raise unless the arguments are what the kernel takes: (B, K, 2)
    int32 centers with K >= 1, (B, K) bool or uint8 valid, (B, H, W, 2)
    float32 offsets, all contiguous and on one device."""
    b, h, w, two = offsets.shape
    k = centers.shape[1]
    if two != 2 or centers.shape != (b, k, 2) or valid.shape != (b, k):
        raise ValueError(f"shapes: centers {tuple(centers.shape)}, valid "
                         f"{tuple(valid.shape)}, offsets "
                         f"{tuple(offsets.shape)}")
    if k < 1:
        raise ValueError("group_pixels needs at least one center slot")
    if centers.dtype != torch.int32 or offsets.dtype != torch.float32:
        raise TypeError(f"dtypes: centers {centers.dtype} (int32), "
                        f"offsets {offsets.dtype} (float32)")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    dev = offsets.device
    if centers.device != dev or valid.device != dev:
        raise ValueError("centers, valid and offsets must share a device")
    for name, t in (("centers", centers), ("valid", valid),
                    ("offsets", offsets)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel():
    global _fn
    if _fn is None:
        from empanada_torch.cuda_build import load

        fn = load("group_pixels").etorch_group_pixels
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        _fn = fn
    return _fn


def _launch(centers, valid, offsets, step, stats=None):
    b, h, w, _ = offsets.shape
    k = centers.shape[1]
    if offsets.data_ptr() % 8:
        raise ValueError("offsets must be 8-byte aligned (float2 loads)")
    dev = offsets.device
    out = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(centers.data_ptr(), valid.data_ptr(),
                       offsets.data_ptr(), out.data_ptr(), b, k, h, w,
                       float(step),
                       None if stats is None else stats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"group_pixels kernel launch failed: CUDA error "
                           f"{rc}")
    count_launches(dev.index)
    return out


def group_pixels_batched(centers, valid, offsets, step: float = 1.0):
    """(B, K, 2), (B, K), (B, H, W, 2) -> (B, H, W) int32 ids.

    CUDA tensors go to the hand-written kernel, CPU tensors to the
    plain version."""
    if offsets.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {offsets.device}")
    check_inputs(centers, valid, offsets)
    if offsets.is_cuda:
        return _launch(centers, valid, offsets, step)
    return group_pixels_plain(centers, valid, offsets, step)


def tile_stats(centers, valid, offsets, step: float = 1.0):
    """Launch the kernel once with its counters on and return what its
    tiles did: counts of "pruned", "exhaustive" and "empty" tiles (a
    slice without a valid center), and the pixel-center pairs that the
    pruned and the exhaustive tiles scanned ("pruned_pairs",
    "exhaustive_pairs"). CUDA tensors only; the launch counts like any
    other."""
    check_inputs(centers, valid, offsets)
    if not offsets.is_cuda:
        raise ValueError("tile_stats runs the CUDA kernel: CUDA tensors only")
    stats = torch.zeros(5, dtype=torch.int64, device=offsets.device)
    _launch(centers, valid, offsets, step, stats)
    names = ("pruned", "exhaustive", "empty", "pruned_pairs",
             "exhaustive_pairs")
    return dict(zip(names, (int(x) for x in stats.cpu())))
