"""Overlap-aware tiling of very large 2D images.

The JAX package's ``inference/tile.py`` (numpy only, on the port's
``core.ranges`` and ``core.rle``): cztile's
AlmostEqualBorderFixedTotalAreaStrategy2D written out. Every tile has
the same fixed size (one set of cuDNN plans serves all tiles), tiles
overlap by at least ``overlap_width``, and starts are distributed as
evenly as possible.
"""

from __future__ import annotations

import math

import numpy as np

from empanada_torch.core.ranges import ranges_to_rle, vote_by_ranges
from empanada_torch.core.rle import merge_rles

__all__ = ["Tiler", "calculate_overlap_rle", "fixed_size_tiles"]


def fixed_size_tiles(length, tile, min_border):
    """1D fixed-total-area tiling: [(start, end)], all of size ``tile``,
    consecutive overlap >= min_border, ends flush with the axis."""
    if tile >= length:
        return [(0, length)]
    if min_border >= tile:
        raise ValueError(
            f"overlap_width ({min_border}) must be smaller than the "
            f"tile size ({tile})")
    # smallest n with overlap (n*tile - length)/(n-1) >= min_border
    n = max(2, math.ceil((length - min_border) / (tile - min_border)))
    span = length - tile
    starts = [round(i * span / (n - 1)) for i in range(n)]
    return [(s, s + tile) for s in starts]


def calculate_overlap_rle(yranges, xranges, image_shape):
    """RLE of the region covered by >= 2 tiles (reference tile.py:8-52)."""
    h, w = image_shape

    def vote(ranges):
        uniq = np.unique(np.stack(ranges, axis=0), axis=0)
        return vote_by_ranges([r[None] for r in uniq], vote_thr=2)

    y = vote(yranges)
    x = vote(xranges)

    if len(y) > 0:
        row_starts = y[:, 0] * w
        row_runs = (y[:, 1] - y[:, 0]) * w
    else:
        row_starts = np.array([], np.int64)
        row_runs = np.array([], np.int64)

    if len(x) > 0:
        # replicate the x overlap bands across every row
        offs = (np.arange(h, dtype=np.int64) * w)[:, None, None]
        col = (x[None, :, :] + offs).reshape(-1, 2)
        col_rle = ranges_to_rle(col)
        col_starts, col_runs = col_rle[:, 0], col_rle[:, 1]
    else:
        col_starts = np.array([], np.int64)
        col_runs = np.array([], np.int64)

    if len(row_starts) or len(col_starts):
        return merge_rles(row_starts, row_runs, col_starts, col_runs)
    return np.array([], np.int64), np.array([], np.int64)


class Tiler:
    """Fixed-size overlapping tiles of a 2D image
    (reference tile.py:54-195)."""

    def __init__(self, image_shape, tile_size=2048, overlap_width=128):
        if isinstance(tile_size, int):
            tile_size = (tile_size, tile_size)
        assert isinstance(overlap_width, int)
        assert len(image_shape) == 2, "Tiler only works with 2D images"

        self.image_shape = tuple(image_shape)
        th = min(tile_size[0], image_shape[0])
        tw = min(tile_size[1], image_shape[1])
        self.tile_size = (th, tw)
        self.overlap_width = overlap_width

        ytiles = fixed_size_tiles(image_shape[0], th, overlap_width)
        xtiles = fixed_size_tiles(image_shape[1], tw, overlap_width)
        self.yranges = []
        self.xranges = []
        for yr in ytiles:
            for xr in xtiles:
                self.yranges.append(yr)
                self.xranges.append(xr)

        self.overlap_rle = calculate_overlap_rle(
            self.yranges, self.xranges, self.image_shape)

    def __len__(self):
        return len(self.yranges)

    def overlap_mask(self):
        overlap = np.zeros(int(np.prod(self.image_shape)))
        for s, r in zip(*self.overlap_rle):
            overlap[s:s + r] = 1
        return overlap.reshape(self.image_shape)

    def translate_rle_seg(self, rle_seg, tile_index):
        """Shift boxes + re-ravel RLE starts from tile frame to global
        frame, in place (reference tile.py:122-168)."""
        ys, _ = self.yranges[tile_index]
        xs, xe = self.xranges[tile_index]
        w = xe - xs

        for labels in rle_seg.values():
            for label_attrs in labels.values():
                b = label_attrs["box"]
                label_attrs["box"] = (b[0] + ys, b[1] + xs,
                                      b[2] + ys, b[3] + xs)
                starts = np.asarray(label_attrs["starts"])
                label_attrs["starts"] = np.ravel_multi_index(
                    (starts // w + ys, starts % w + xs),
                    dims=self.image_shape)
                # the canonical-form memo was computed in the tile
                # frame; rebinding starts invalidates it (get_canon
                # checks identity), drop it so nothing ever reads the
                # tile-frame coordinates
                label_attrs.pop("_canon", None)
        return rle_seg

    def __call__(self, image, tile_index):
        if tile_index >= len(self):
            raise IndexError("Tile index out of range")
        assert image.shape[:2] == self.image_shape
        yslice = slice(*self.yranges[tile_index])
        xslice = slice(*self.xranges[tile_index])
        return image[yslice, xslice]
