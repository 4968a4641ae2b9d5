"""Reading and writing the training set's image and mask files.

Reads with the first of OpenCV, imageio and Pillow that imports; where
none does, 8/16-bit PNG files are read with the package's own codec
(zlib + numpy), which also writes them. ``reader()`` names the library
in use. The choice concerns only the host's file decoding.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["reader", "read_image", "read_mask", "read_png", "write_png"]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_reader = None


def reader():
    """The image library the readers use: "cv2", "imageio", "PIL" or
    "png-codec" (the package's own PNG codec)."""
    global _reader
    if _reader is None:
        for name in ("cv2", "imageio", "PIL"):
            try:
                __import__(name)
            except ImportError:
                continue
            _reader = name
            break
        else:
            _reader = "png-codec"
    return _reader


def _read(path, unchanged):
    lib = reader()
    if lib == "cv2":
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED if unchanged
                         else cv2.IMREAD_GRAYSCALE)
        if img is not None:
            return img
        lib = "imageio"  # formats cv2 cannot decode (some tiffs)
    if lib == "imageio":
        import imageio.v3 as iio

        return np.asarray(iio.imread(path))
    if lib == "PIL":
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im)
    return read_png(path)


def read_image(path):
    """Grayscale image -> (H, W) uint8/uint16 numpy."""
    img = _read(path, unchanged=False)
    return img[..., 0] if img.ndim == 3 else img


def read_mask(path):
    """Label mask -> (H, W) int64 numpy, any bit depth preserved."""
    msk = _read(path, unchanged=True)
    if msk.ndim == 3:
        msk = msk[..., 0]
    return msk.astype(np.int64)


def _chunk(kind, data):
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path, array):
    """(H, W) uint8 or uint16 -> a grayscale PNG file (filter 0)."""
    array = np.asarray(array)
    if array.ndim != 2 or array.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes (H, W) uint8/uint16, not "
                         f"{array.shape} {array.dtype}")
    h, w = array.shape
    depth = 8 * array.dtype.itemsize
    rows = array.astype(array.dtype.newbyteorder(">")).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data, h, stride, bpp):
    """Undo the five PNG row filters; returns (h, stride) uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1).astype(np.int64)
        pos += stride + 1
        if ftype == 1:  # Sub
            row = row.reshape(-1, bpp).cumsum(axis=0).reshape(-1) % 256
        elif ftype == 2:  # Up
            row = (row + prev) % 256
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            row = row.copy()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                pred = (a + prev[i]) // 2 if ftype == 3 \
                    else _paeth(a, prev[i], c)
                row[i] = (row[i] + pred) % 256
        elif ftype != 0:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = row
        prev = row
    return out


def read_png(path):
    """A non-interlaced 8/16-bit grayscale, RGB or RGBA PNG -> numpy
    (H, W) or (H, W, C), uint8 or uint16."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file, and no image library "
                         "(cv2, imageio, PIL) is installed")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if channels is None or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: PNG color type {color}, depth {depth}, "
                         f"interlace {interlace} is not supported")
    bpp = channels * depth // 8
    raw = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    dtype = np.dtype(">u2") if depth == 16 else np.dtype(np.uint8)
    img = raw.view(dtype).reshape(h, w, channels).astype(dtype.newbyteorder("="))
    return img[..., 0] if channels == 1 else img
