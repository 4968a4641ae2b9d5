"""Dense volume filling from RLE instances.

Parity with reference array_utils.numpy_fill_instances (array_utils.py:725)
and zarr_utils.zarr_fill_instances (zarr_utils.py:88), generalized to any
chunked store exposing __setitem__/__getitem__ over slices (the package's
ZarrArray, zarr arrays if installed, or numpy memmaps).
"""

from __future__ import annotations

import os

import numpy as np

from empanada_torch.core import native
from empanada_torch.core.ccl import _within_run_offsets

__all__ = ["numpy_fill_instances", "split_ranges_on_chunks",
           "chunked_fill_instances"]


def numpy_fill_instances(volume: np.ndarray, instances: dict) -> np.ndarray:
    """Fill a dense ndarray with instance ids from {'id': {'starts','runs'}}.

    In place for contiguous arrays; a non-contiguous view would silently
    receive nothing (reshape copies), so write back explicitly."""
    shape = volume.shape
    contiguous = volume.flags.c_contiguous
    flat = volume.reshape(-1) if contiguous else \
        np.ascontiguousarray(volume).reshape(-1)

    for instance_id, attrs in instances.items():
        starts = np.asarray(attrs["starts"], dtype=np.int64)
        runs = np.asarray(attrs["runs"], dtype=np.int64)
        if len(starts) == 0:
            continue
        if flat.dtype in (np.int32, np.int64) and flat.flags.c_contiguous:
            if native.fill_runs(flat, starts, runs, int(instance_id)) is not None:
                continue
        idx = np.repeat(starts, runs) + _within_run_offsets(runs)
        flat[idx] = instance_id

    filled = flat.reshape(shape)
    if not contiguous:
        volume[...] = filled  # keep the documented in-place contract
    return filled


def split_ranges_on_chunks(starts, runs, shape, chunks):
    """Split flat RLE ranges on chunk boundaries of a chunked 3D store.

    Returns a dict: chunk_index_tuple -> (starts, runs) arrays in *global*
    raveled coordinates. Equivalent role to the reference's numba
    chunk_ranges + per-chunk grouping (zarr_utils.py:11-47,108-162) but
    computed with vectorized splitting along each axis.
    """
    starts = np.asarray(starts, dtype=np.int64)
    runs = np.asarray(runs, dtype=np.int64)
    d, h, w = shape
    cd, ch, cw = chunks

    # 1) split ranges so none crosses a row (x-extent) boundary
    ends = starts + runs
    # rows are of length w; a range [s, e) may span multiple rows
    n_splits = (ends - 1) // w - starts // w
    # vectorized: expand each range into per-row subranges
    reps = n_splits + 1
    base = np.repeat(starts, reps)
    offs = _within_run_offsets(reps)
    row0 = np.repeat(starts // w, reps)
    rows = row0 + offs
    sub_starts = np.maximum(base, rows * w)
    sub_ends = np.minimum(np.repeat(ends, reps), (rows + 1) * w)
    out_starts, out_ends = sub_starts, sub_ends

    # 2) split each row-confined range on x-chunk boundaries
    xs = out_starts % w
    xe = (out_ends - 1) % w + 1
    n_xsplits = (xe - 1) // cw - xs // cw
    reps = n_xsplits + 1
    base_s = np.repeat(out_starts, reps)
    base_e = np.repeat(out_ends, reps)
    offs = _within_run_offsets(reps)
    cx0 = np.repeat(xs // cw, reps)
    cxs = cx0 + offs
    row_base = np.repeat(out_starts - xs, reps)  # raveled index of column 0
    seg_starts = np.maximum(base_s, row_base + cxs * cw)
    seg_ends = np.minimum(base_e, row_base + (cxs + 1) * cw)

    # 3) group by chunk tuple (multipliers from the actual chunk grid —
    # fixed-base packing overflows on very large chunk grids)
    z = seg_starts // (h * w)
    y = (seg_starts // w) % h
    x = seg_starts % w
    ny = -(-h // ch)
    nx = -(-w // cw)
    key = ((z // cd) * ny + (y // ch)) * nx + (x // cw)
    order = np.argsort(key, kind="stable")
    seg_starts = seg_starts[order]
    seg_ends = seg_ends[order]
    key = key[order]

    out = {}
    bounds = np.nonzero(np.concatenate([[True], key[1:] != key[:-1]]))[0]
    bounds = np.concatenate([bounds, [len(key)]])
    for bi in range(len(bounds) - 1):
        i0, i1 = bounds[bi], bounds[bi + 1]
        k = int(key[i0])
        chunk_idx = (k // (ny * nx), (k // nx) % ny, k % nx)
        out[chunk_idx] = (seg_starts[i0:i1], seg_ends[i0:i1] - seg_starts[i0:i1])
    return out


def chunked_fill_instances(store, instances: dict, chunks=None, processes=1):
    """Fill a chunked 3D store with RLE instances, one chunk at a time.

    ``store`` needs .shape, .dtype, and slice get/setitem (zarr array,
    the package's ZarrArray, numpy array or memmap all qualify).
    Ranges are partitioned per chunk first so each chunk is read/written
    exactly once (the write-race-free design of the reference's
    zarr_fill_instances, zarr_utils.py:88-175); with ``processes > 1``
    disjoint chunks are filled by a thread pool (the C++ fill, numpy's
    indexing and the store's compressor release the GIL; threads avoid
    the reference mp.Pool's pickling overhead).
    """
    shape = store.shape
    if chunks is None:
        chunks = getattr(store, "chunks", None) or shape

    d, h, w = shape
    cd, ch, cw = chunks

    # gather per-chunk fill lists across all instances
    per_chunk = {}
    for instance_id, attrs in instances.items():
        split = split_ranges_on_chunks(attrs["starts"], attrs["runs"], shape, chunks)
        for chunk_idx, (s, r) in split.items():
            per_chunk.setdefault(chunk_idx, []).append((int(instance_id), s, r))

    def fill_chunk(item):
        (ci, cj, ck), fills = item
        z0, y0, x0 = ci * cd, cj * ch, ck * cw
        z1, y1, x1 = min(z0 + cd, d), min(y0 + ch, h), min(x0 + cw, w)
        block = np.asarray(store[z0:z1, y0:y1, x0:x1])

        bh, bw = y1 - y0, x1 - x0
        flat = np.ascontiguousarray(block).reshape(-1)
        # the native run fill writes 4/8-byte lanes; an unsigned view of
        # the same width is bit-identical for non-negative ids (stores
        # default to uint32, which would otherwise take the numpy repeat
        # path and its per-run index allocations)
        if flat.dtype == np.uint32:
            fill_view = flat.view(np.int32)
        elif flat.dtype == np.uint64:
            fill_view = flat.view(np.int64)
        else:
            fill_view = flat
        for instance_id, s, r in fills:
            # convert global raveled coords to block-local raveled coords
            z = s // (h * w) - z0
            y = (s // w) % h - y0
            x = s % w - x0
            local = (z * bh + y) * bw + x
            if fill_view.dtype in (np.int32, np.int64) \
                    and 0 <= instance_id < 2 ** 31:
                if native.fill_runs(fill_view, local, r,
                                    instance_id) is not None:
                    continue
            idx = np.repeat(local, r) + _within_run_offsets(r)
            flat[idx] = instance_id

        store[z0:z1, y0:y1, x0:x1] = flat.reshape(z1 - z0, bh, bw)

    # threads only help with real parallel cores: on a 1-core host the
    # pool oversubscribes the GIL and the compressor and is slower than
    # serial, so clamp to the cores this process may actually use
    try:
        n_cores = len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        n_cores = os.cpu_count() or 1
    processes = min(processes, n_cores)
    if processes > 1 and len(per_chunk) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=processes) as pool:
            list(pool.map(fill_chunk, per_chunk.items()))
    else:
        for item in per_chunk.items():
            fill_chunk(item)

    return store
