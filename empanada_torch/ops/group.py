"""Nearest-center pixel grouping: the CUDA kernel and its plain version.

Replaces the TPU kernel ``empanada_tpu/ops/pallas_group.py``
(``_kernel`` / ``group_pixels_pallas``). For each pixel (i, j) of slice
b, loc = (i*step + dy, j*step + dx); the id is 1 + the index of the
valid center k minimizing |loc - step*c_k|^2 (ties to the lowest k),
0 everywhere when the slice has no valid center.

``group_pixels_batched`` launches ``csrc/group_pixels.cu`` for CUDA
tensors (one launch per block of B slices) and uses the plain version
only for CPU tensors; on CUDA it launches or raises. The kernel is
bound by operations (~7 f32 ops per pixel-center pair, no tensor
cores); see the source for the numbers at the main path's shapes.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["group_pixels_batched", "group_pixels_plain", "LAUNCHES",
           "reset_launches"]

# launches of the CUDA kernel since the last reset_launches()
LAUNCHES = {"group_pixels": 0}

_fn = None


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def group_pixels_plain(centers, valid, offsets, step: float = 1.0):
    """Broadcast distance + first-minimum argmin.

    centers (B, K, 2) int (y, x) in grid units; valid (B, K) bool;
    offsets (B, H, W, 2) float32 (dy, dx) in full-resolution units.
    Returns (B, H, W) int32."""
    b, h, w, _ = offsets.shape
    dev = offsets.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) * step
    xs = torch.arange(w, dtype=torch.float32, device=dev) * step
    off = offsets.float()
    loc_y = (ys[None, :, None] + off[..., 0]).reshape(b, h * w, 1)
    loc_x = (xs[None, None, :] + off[..., 1]).reshape(b, h * w, 1)
    ctr = centers.float() * step
    dy = loc_y - ctr[:, None, :, 0]
    dx = loc_x - ctr[:, None, :, 1]
    d = dy * dy + dx * dx
    d = torch.where(valid.bool()[:, None, :], d,
                    torch.tensor(1e10, dtype=torch.float32, device=dev))
    ids = 1 + torch.argmin(d, dim=2).to(torch.int32)
    any_valid = valid.bool().any(dim=1)[:, None]
    ids = torch.where(any_valid, ids, torch.zeros_like(ids))
    return ids.reshape(b, h, w)


def _kernel():
    global _fn
    if _fn is None:
        from empanada_torch.cuda_build import load

        fn = load("group_pixels").etorch_group_pixels
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        _fn = fn
    return _fn


def _launch(centers, valid, offsets, step):
    b, h, w, two = offsets.shape
    k = centers.shape[1]
    if two != 2 or centers.shape != (b, k, 2) or valid.shape != (b, k):
        raise ValueError(f"shapes: centers {tuple(centers.shape)}, valid "
                         f"{tuple(valid.shape)}, offsets "
                         f"{tuple(offsets.shape)}")
    if not 1 <= k <= 1024:
        raise ValueError(f"the kernel takes 1..1024 centers, got {k}")
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
    out = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(centers.data_ptr(), valid.data_ptr(),
                       offsets.data_ptr(), out.data_ptr(), b, k, h, w,
                       float(step), stream)
    if rc != 0:
        raise RuntimeError(f"group_pixels kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["group_pixels"] += 1
    return out


def group_pixels_batched(centers, valid, offsets, step: float = 1.0):
    """(B, K, 2), (B, K), (B, H, W, 2) -> (B, H, W) int32 ids.

    CUDA tensors go to the hand-written kernel, CPU tensors to the
    plain version."""
    if offsets.is_cuda:
        return _launch(centers, valid, offsets, step)
    if offsets.device.type != "cpu":
        raise ValueError(f"unsupported device {offsets.device}")
    return group_pixels_plain(centers, valid, offsets, step)
