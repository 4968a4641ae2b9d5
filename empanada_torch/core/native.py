"""ctypes loader for the C++ host core (``core/_native/core.cpp``).

Counterpart of the JAX package's ``empanada_tpu/core/native.py``: the
same wrappers with the same signatures and outputs, over the port's own
copy of the source. The library is built at first use by
``empanada_torch.native_build`` (g++, hash-named, so never stale) and
loaded once per process. ctypes releases the interpreter lock for the
length of every call, and the library keeps no state, so host threads
may call any wrapper at once.

One deliberate difference from the JAX package: a library that cannot
be built or loaded RAISES (with the compiler's output); no caller slides
to numpy because of it. The numpy paths of the calling modules are the
plain versions of these entry points and run only when asked for by
name:

- ``EMPANADA_TORCH_NO_NATIVE=1`` in the environment, read at first use
  (counterpart of ``EMPANADA_TPU_NO_NATIVE``), for a whole process;
- ``with native.numpy_host_half():`` inside a process (tests and
  ``chip_smoke.py`` run both paths in one process with it). The switch
  is process-wide, not per thread: threads started inside the block
  take the numpy paths too.

While the numpy host half is asked for, ``get_lib()`` and every wrapper
return ``None`` and the caller takes its numpy path, exactly the
contract the JAX package's callers are written against. A wrapper also
returns ``None`` where it declines by contract (float boxes, a buffer
dtype ``fill_runs`` does not cover).

``CALLS`` counts the native calls by entry point (one is added where a
wrapper calls into the library, and nowhere else); ``reset_calls()``
sets the counts to 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import numpy as np

from empanada_torch import native_build

__all__ = ["ENTRY_POINTS", "CALLS", "reset_calls", "get_lib",
           "numpy_host_half", "coverage_ranges", "ranges_intersection",
           "pair_intersections", "kway_merge_ranges", "kway_vote",
           "kway_union_sr", "kway_union_batch", "rle_union",
           "box_overlap_pairs", "runs_ccl", "runs_ccl3d", "fill_runs",
           "encode_runs"]

# the extern "C" entry points of core.cpp, without their etpu_ prefix
ENTRY_POINTS = ("coverage_ranges", "ranges_intersection",
                "pair_intersections", "kway_merge_ranges", "rle_union",
                "kway_vote", "kway_union_sr", "kway_union_batch",
                "box_overlap_pairs", "runs_ccl", "runs_ccl3d",
                "fill_runs_i32", "fill_runs_i64", "encode_runs_i32")

# native calls by entry point since the last reset_calls()
CALLS = dict.fromkeys(ENTRY_POINTS, 0)

_lib = None
_numpy_only = None  # None until first use reads EMPANADA_TORCH_NO_NATIVE
_lock = threading.Lock()
_calls_lock = threading.Lock()


def reset_calls():
    with _calls_lock:
        for key in CALLS:
            CALLS[key] = 0


def _count(entry_point):
    # the host threads of three axes count at once
    with _calls_lock:
        CALLS[entry_point] += 1


def _numpy_asked_for() -> bool:
    global _numpy_only
    if _numpy_only is None:
        _numpy_only = bool(os.environ.get("EMPANADA_TORCH_NO_NATIVE"))
    return _numpy_only


@contextlib.contextmanager
def numpy_host_half():
    """Inside the block every wrapper returns None, so the calling
    modules take their numpy paths (process-wide, see the module
    docstring)."""
    global _numpy_only
    before = _numpy_asked_for()
    _numpy_only = True
    try:
        yield
    finally:
        _numpy_only = before


def _load():
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    signatures = {
        "coverage_ranges": (i64, [p64, i64, i64, p64, i64]),
        "ranges_intersection": (i64, [p64, i64, p64, i64]),
        "pair_intersections": (None, [p64, p64, p64, p64, p64, i64, p64]),
        "kway_merge_ranges": (i64, [p64, p64, i64, p64]),
        "rle_union": (i64, [p64, i64, p64, i64, p64]),
        "kway_vote": (i64, [p64, p64, i64, i64, p64]),
        "kway_union_sr": (i64, [p64, p64, p64, i64, p64, p64]),
        "kway_union_batch": (i64, [p64, p64, p64, p64, i64, p64, p64,
                                   p64]),
        "box_overlap_pairs": (i64, [p64, i64, p64, i64, i64, p64, p64,
                                    i64]),
        "runs_ccl": (i64, [p64, p64, p64, i64, i64, i32, p32]),
        "runs_ccl3d": (i64, [p64, p64, p64, i64, i64, i64, i64, i32,
                             p32]),
        "fill_runs_i32": (None, [p32, i64, p64, p64, i64, i32]),
        "fill_runs_i64": (None, [p64, i64, p64, p64, i64, i64]),
        "encode_runs_i32": (i64, [p32, i64, i64, p64, p64, p64]),
    }
    lib = ctypes.CDLL(str(native_build.build()))
    for name in ENTRY_POINTS:
        fn = getattr(lib, f"etpu_{name}")
        fn.restype, fn.argtypes = signatures[name]
    return lib


def get_lib():
    """The loaded library, built at first use; None only while the numpy
    host half is asked for by name. Raises when the library cannot be
    built or loaded."""
    global _lib
    if _numpy_asked_for():
        return None
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _load()
    return _lib


def _c64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def coverage_ranges(ranges: np.ndarray, thr: int):
    lib = get_lib()
    if lib is None:
        return None
    ranges = _c64(ranges)
    n = len(ranges)
    cap = 2 * n + 2
    out = np.empty((cap, 2), dtype=np.int64)
    _count("coverage_ranges")
    count = lib.etpu_coverage_ranges(ranges, n, thr, out, cap)
    if count > cap:  # shouldn't happen (output ranges <= input ranges)
        out = np.empty((count, 2), dtype=np.int64)
        _count("coverage_ranges")
        count = lib.etpu_coverage_ranges(ranges, n, thr, out, count)
    out = out[:count]
    # canonicalize: the sweep emits touching ranges separately when an
    # end event shares a coordinate with a start event; the numpy
    # path merges them — keep both paths byte-identical
    if count > 1:
        touch = out[1:, 0] == out[:-1, 1]
        if touch.any():
            keep = np.concatenate([[True], ~touch])
            group = np.cumsum(keep) - 1
            merged = out[keep].copy()
            np.maximum.at(merged[:, 1], group, out[:, 1])
            return merged
    return out.copy()


def ranges_intersection(ranges_a: np.ndarray, ranges_b: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    a = _c64(ranges_a)
    b = _c64(ranges_b)
    _count("ranges_intersection")
    return int(lib.etpu_ranges_intersection(a, len(a), b, len(b)))


def pair_intersections(ranges_a_cat, offs_a, ranges_b_cat, offs_b, pairs):
    """Batched intersection sizes for (ia, ib) pairs of instances whose
    per-instance disjoint sorted ranges are concatenated in
    ``ranges_x_cat`` ((total, 2) int64) with ``offs_x`` ((n+1,) range
    offsets). Returns (n_pairs,) int64."""
    lib = get_lib()
    if lib is None:
        return None
    ranges_a_cat = _c64(ranges_a_cat)
    ranges_b_cat = _c64(ranges_b_cat)
    offs_a = _c64(offs_a)
    offs_b = _c64(offs_b)
    pairs = _c64(pairs)
    out = np.empty(len(pairs), dtype=np.int64)
    _count("pair_intersections")
    lib.etpu_pair_intersections(ranges_a_cat, offs_a, ranges_b_cat, offs_b,
                                pairs, len(pairs), out)
    return out


def kway_merge_ranges(cat, offs):
    """Merge k individually start-sorted range lists (concatenated in
    ``cat`` (n, 2) with ``offs`` (k+1,)) into one start-sorted (n, 2)
    list — identical output to a stable argsort of the concatenation."""
    lib = get_lib()
    if lib is None:
        return None
    cat = _c64(cat)
    offs = _c64(offs)
    out = np.empty_like(cat)
    _count("kway_merge_ranges")
    n = lib.etpu_kway_merge_ranges(cat, offs, len(offs) - 1, out)
    if n != len(cat):
        raise RuntimeError(f"kway_merge_ranges wrote {n} of {len(cat)} "
                           f"ranges: offs does not span cat")
    return out


def kway_vote(cat, offs, thr):
    """Maximal ranges covered by >= thr of the k individually canonical
    (start-sorted, disjoint) range lists concatenated in ``cat`` (n, 2)
    with ``offs`` (k+1,) — identical output to the concat-sort +
    coverage sweep, in one O(n log k) heap pass with no sort.
    Returns (m, 2) int64."""
    lib = get_lib()
    if lib is None:
        return None
    cat = _c64(cat)
    offs = _c64(offs)
    out = np.empty_like(cat)
    _count("kway_vote")
    n = lib.etpu_kway_vote(cat, offs, len(offs) - 1, thr, out)
    return out[:n].copy()


def kway_union_sr(starts_cat, runs_cat, offs):
    """Union of k individually canonical (start-sorted, disjoint) RLEs
    given DIRECTLY as concatenated starts/runs with ``offs`` (k+1 list
    offsets) — identical output to join_ranges over the packed ranges,
    without the (n, 2) packing, generic sort, or coverage sweep.
    Returns (starts, runs) int64."""
    lib = get_lib()
    if lib is None:
        return None
    starts_cat = np.ascontiguousarray(starts_cat, dtype=np.int64)
    runs_cat = np.ascontiguousarray(runs_cat, dtype=np.int64)
    offs = _c64(offs)
    out_s = np.empty(len(starts_cat), dtype=np.int64)
    out_r = np.empty(len(runs_cat), dtype=np.int64)
    _count("kway_union_sr")
    n = lib.etpu_kway_union_sr(starts_cat, runs_cat, offs, len(offs) - 1,
                               out_s, out_r)
    return out_s[:n].copy(), out_r[:n].copy()


def kway_union_batch(starts_cat, runs_cat, offs, group_offs):
    """Independent k-way unions of g groups of canonical RLE lists in
    ONE native crossing. ``offs`` (m+1) delimits the m input lists in
    the concatenated starts/runs; ``group_offs`` (g+1) partitions the
    lists into groups. Returns (out_starts, out_runs, out_offs) with
    out_offs (g+1) delimiting each group's union."""
    lib = get_lib()
    if lib is None:
        return None
    starts_cat = np.ascontiguousarray(starts_cat, dtype=np.int64)
    runs_cat = np.ascontiguousarray(runs_cat, dtype=np.int64)
    offs = _c64(offs)
    group_offs = _c64(group_offs)
    g = len(group_offs) - 1
    out_s = np.empty(len(starts_cat), dtype=np.int64)
    out_r = np.empty(len(runs_cat), dtype=np.int64)
    out_offs = np.empty(g + 1, dtype=np.int64)
    _count("kway_union_batch")
    n = lib.etpu_kway_union_batch(starts_cat, runs_cat, offs, group_offs,
                                  g, out_s, out_r, out_offs)
    return out_s[:n].copy(), out_r[:n].copy(), out_offs


def rle_union(ranges_a, ranges_b):
    """Union of two CANONICAL (sorted, disjoint) (n, 2) range lists,
    coalescing overlap and touch — identical output to
    join_ranges([ranges_a, ranges_b]). Returns (m, 2) int64."""
    lib = get_lib()
    if lib is None:
        return None
    a = _c64(ranges_a)
    b = _c64(ranges_b)
    out = np.empty((len(a) + len(b), 2), dtype=np.int64)
    _count("rle_union")
    n = lib.etpu_rle_union(a, len(a), b, len(b), out)
    return out[:n].copy()


def box_overlap_pairs(boxes_a, boxes_b=None):
    """All (ia, ib) index pairs of half-open N-d boxes with positive
    intersection, plus the intersection volumes. boxes: (n, 2*ndim)
    int64. Self mode (boxes_b=None) includes (i, i) and both orders,
    like the dense screen. Returns (pairs (k, 2), inter (k,)), or None
    for float boxes (the caller's numpy path is exact on those)."""
    lib = get_lib()
    if lib is None:
        return None
    # int64-only: _c64 would TRUNCATE float box coordinates, silently
    # dropping thin overlaps — float boxes take the exact numpy path
    if not (np.issubdtype(np.asarray(boxes_a).dtype, np.integer)
            and (boxes_b is None
                 or np.issubdtype(np.asarray(boxes_b).dtype, np.integer))):
        return None
    a = _c64(boxes_a)
    b = a if boxes_b is None else _c64(boxes_b)
    ndim = a.shape[1] // 2
    cap = max(64, 16 * max(len(a), len(b)))
    while True:
        pairs = np.empty((cap, 2), dtype=np.int64)
        inter = np.empty(cap, dtype=np.int64)
        _count("box_overlap_pairs")
        n = lib.etpu_box_overlap_pairs(a, len(a), b, len(b), ndim,
                                       pairs, inter, cap)
        if n <= cap:
            return pairs[:n].copy(), inter[:n].copy()
        cap = n


def runs_ccl(starts, ends, values, width: int, connectivity: int = 8):
    """Label row-split runs; returns (labels int32 per-run, n_components)."""
    lib = get_lib()
    if lib is None:
        return None
    starts = _c64(starts)
    ends = _c64(ends)
    values = _c64(values)
    labels = np.zeros(len(starts), dtype=np.int32)
    _count("runs_ccl")
    n = lib.etpu_runs_ccl(starts, ends, values, len(starts), width,
                          connectivity, labels)
    return labels, int(n)


def runs_ccl3d(starts, ends, values, d, h, w, connectivity=26):
    """3D run CCL over raster-sorted row-split runs of a (d, h, w)
    volume; returns (labels int32 per-run, n_components)."""
    lib = get_lib()
    if lib is None:
        return None
    starts = _c64(starts)
    ends = _c64(ends)
    values = _c64(values)
    if len(starts) and not 0 <= starts[0] <= starts[-1] < d * h * w:
        raise ValueError(f"runs_ccl3d: runs start outside a volume of "
                         f"{(d, h, w)}")
    labels = np.zeros(len(starts), dtype=np.int32)
    _count("runs_ccl3d")
    n = lib.etpu_runs_ccl3d(starts, ends, values, len(starts), d, h, w,
                            connectivity, labels)
    return labels, int(n)


def fill_runs(buf: np.ndarray, starts, runs, value: int):
    """In-place fill of a raveled contiguous int32/int64 buffer; None
    (nothing written) for any other dtype."""
    lib = get_lib()
    if lib is None:
        return None
    starts = _c64(starts)
    runs = _c64(runs)
    if buf.dtype == np.int32:
        _count("fill_runs_i32")
        lib.etpu_fill_runs_i32(buf, buf.size, starts, runs, len(starts),
                               int(value))
    elif buf.dtype == np.int64:
        _count("fill_runs_i64")
        lib.etpu_fill_runs_i64(buf, buf.size, starts, runs, len(starts),
                               int(value))
    else:
        return None
    return True


def encode_runs(img: np.ndarray, width: int):
    """Row-split constant-value runs of a raveled int32 image."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.int32).ravel()
    cap = img.size
    starts = np.empty(cap, dtype=np.int64)
    ends = np.empty(cap, dtype=np.int64)
    values = np.empty(cap, dtype=np.int64)
    _count("encode_runs_i32")
    n = lib.etpu_encode_runs_i32(img, img.size, width, starts, ends, values)
    return starts[:n].copy(), ends[:n].copy(), values[:n].copy()
