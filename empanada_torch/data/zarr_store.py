"""Chunked volume IO: a self-contained zarr-v2-format store.

The reference relies on the zarr package for chunked volume IO
(reference zarr_utils.py, scripts/pdl_inference3d.py:78-88). zarr isn't a
baked-in dependency here, so this module implements the zarr v2 on-disk
format directly (``.zarray`` JSON metadata + C-order chunk files named
``i.j.k``, zlib or raw compression) — volumes written here open with the
real zarr package and vice versa.

Thread-safe for concurrent writes to distinct chunks (the access pattern
of core/fill.chunked_fill_instances).
"""

from __future__ import annotations

import json
import math
import os
import zlib

import numpy as np

__all__ = ["ZarrArray", "open_zarr", "create_zarr", "read_volume"]


class ZarrArray:
    """Minimal zarr v2 array: orthogonal slice get/setitem, any ndim."""

    def __init__(self, path):
        self.path = path
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        assert meta["zarr_format"] == 2, "only zarr v2 supported"
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value", 0) or 0
        self.order = meta.get("order", "C")
        assert self.order == "C", "only C order supported"
        assert not meta.get("filters"), "filters not supported"
        comp = meta.get("compressor")
        if comp is None:
            self._compress = lambda b: b
            self._decompress = lambda b: b
        elif comp["id"] in ("zlib", "gzip"):
            level = comp.get("level", 1)
            self._compress = lambda b, l=level: zlib.compress(b, l)
            self._decompress = zlib.decompress
        else:
            raise ValueError(f"unsupported compressor {comp['id']!r} "
                             "(use zlib or null)")
        self._sep = meta.get("dimension_separator", ".")

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape))

    def _chunk_path(self, idx):
        return os.path.join(self.path, self._sep.join(str(i) for i in idx))

    def _read_chunk(self, idx):
        p = self._chunk_path(idx)
        if not os.path.exists(p):
            return np.full(self.chunks, self.fill_value, self.dtype)
        with open(p, "rb") as f:
            raw = self._decompress(f.read())
        return np.frombuffer(raw, self.dtype).reshape(self.chunks).copy()

    def _write_chunk(self, idx, data):
        p = self._chunk_path(idx)
        tmp = p + f".tmp{os.getpid()}.{id(data)}"
        with open(tmp, "wb") as f:
            f.write(self._compress(np.ascontiguousarray(data).tobytes()))
        os.replace(tmp, p)

    def _norm_key(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        key = list(key) + [slice(None)] * (self.ndim - len(key))
        out = []
        int_axes = []
        for ax, k in enumerate(key):
            if isinstance(k, (int, np.integer)):
                k = int(k)
                if k < 0:
                    k += self.shape[ax]
                out.append(slice(k, k + 1))
                int_axes.append(ax)
            else:
                start, stop, step = k.indices(self.shape[ax])
                assert step == 1, "only contiguous slices supported"
                out.append(slice(start, stop))
        return out, int_axes

    def __getitem__(self, key):
        sel, int_axes = self._norm_key(key)
        out_shape = tuple(s.stop - s.start for s in sel)
        out = np.empty(out_shape, self.dtype)

        for cidx, (csel, osel) in self._iter_chunks(sel):
            chunk = self._read_chunk(cidx)
            out[osel] = chunk[csel]
        if int_axes:
            out = out.reshape(tuple(
                n for ax, n in enumerate(out_shape) if ax not in int_axes))
        return out

    def __setitem__(self, key, value):
        sel, int_axes = self._norm_key(key)
        out_shape = tuple(s.stop - s.start for s in sel)
        value = np.broadcast_to(np.asarray(value, self.dtype), out_shape)

        for cidx, (csel, osel) in self._iter_chunks(sel):
            full = all(
                c.stop - c.start == self.chunks[ax]
                for ax, c in enumerate(csel))
            chunk = (np.empty(self.chunks, self.dtype) if full
                     else self._read_chunk(cidx))
            chunk[csel] = value[osel]
            self._write_chunk(cidx, chunk)

    def _iter_chunks(self, sel):
        """Yield (chunk_index, (chunk-local slices, output slices))."""
        ranges = []
        for ax, s in enumerate(sel):
            c = self.chunks[ax]
            first = s.start // c
            last = (s.stop - 1) // c if s.stop > s.start else first - 1
            ranges.append(range(first, last + 1))

        def rec(ax, cidx):
            if ax == len(ranges):
                csel, osel = [], []
                for a, ci in enumerate(cidx):
                    c = self.chunks[a]
                    s = sel[a]
                    lo = max(s.start, ci * c)
                    hi = min(s.stop, (ci + 1) * c)
                    csel.append(slice(lo - ci * c, hi - ci * c))
                    osel.append(slice(lo - s.start, hi - s.start))
                yield tuple(cidx), (tuple(csel), tuple(osel))
                return
            for ci in ranges[ax]:
                yield from rec(ax + 1, cidx + [ci])

        yield from rec(0, [])

    def __array__(self, dtype=None):
        full = self[tuple(slice(0, s) for s in self.shape)]
        return full.astype(dtype) if dtype is not None else full


def create_zarr(path, shape, chunks=None, dtype=np.uint32,
                compressor="zlib", level=1, fill_value=0,
                overwrite=False):
    """Create a zarr v2 array directory and return a ZarrArray."""
    dtype = np.dtype(dtype)
    if chunks is None:
        chunks = tuple(min(s, 256) for s in shape)
    if os.path.exists(os.path.join(path, ".zarray")):
        if not overwrite:
            raise FileExistsError(path)
        # stale chunk files from a previous layout (different chunks/
        # dtype/compressor) would corrupt reads of the new array —
        # overwrite means a fresh store, so clear them all
        for name in os.listdir(path):
            fp = os.path.join(path, name)
            if os.path.isfile(fp):
                os.remove(fp)
    os.makedirs(path, exist_ok=True)
    if compressor is None:
        comp = None
    elif compressor == "zlib":
        comp = {"id": "zlib", "level": level}
    else:
        raise ValueError("compressor must be 'zlib' or None")
    meta = {
        "zarr_format": 2,
        "shape": list(shape),
        "chunks": list(chunks),
        "dtype": dtype.str,
        "compressor": comp,
        "fill_value": int(fill_value),
        "order": "C",
        "filters": None,
        "dimension_separator": ".",
    }
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    return ZarrArray(path)


def open_zarr(path):
    """Open .zarray dir; group dirs (.zgroup) resolve their sole array or
    require a subpath."""
    if os.path.exists(os.path.join(path, ".zarray")):
        return ZarrArray(path)
    if os.path.exists(os.path.join(path, ".zgroup")):
        arrays = [
            sd for sd in sorted(os.listdir(path))
            if os.path.exists(os.path.join(path, sd, ".zarray"))
        ]
        if len(arrays) == 1:
            return ZarrArray(os.path.join(path, arrays[0]))
        raise ValueError(
            f"zarr group {path} has {len(arrays)} arrays; pass the full "
            f"path to one of {arrays}")
    raise FileNotFoundError(f"no zarr array at {path}")


def read_volume(path):
    """Open a 3D volume: .zarr dir, .npy/.npz, or (multi-page) tiff.
    zarr returns the lazy ZarrArray; others load to numpy
    (replaces the reference's zarr/dask/io.imread switch,
    pdl_inference3d.py:78-88)."""
    if os.path.isdir(path):
        return open_zarr(path)
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    if path.endswith(".npz"):
        data = np.load(path)
        return data[list(data.keys())[0]]
    import imageio.v3 as iio

    vol = np.asarray(iio.imread(path))
    if vol.ndim == 2:
        vol = vol[None]
    return vol
