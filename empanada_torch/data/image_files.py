"""Reading and writing the image and mask files of the training set
and of curation.

Reads with the first of imageio and Pillow that imports; where neither
does, 8/16-bit PNG files and uncompressed TIFF files are read with the
package's own codecs (zlib + numpy), which also write them. ``reader()``
names the library in use. The choice concerns only the host's file
decoding; the package imports no OpenCV.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["reader", "read_image", "read_mask", "read_png", "write_png",
           "read_tiff", "write_tiff"]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_TIFF_SIGS = (b"II*\x00", b"MM\x00*")
_reader = None


def reader():
    """The image library the readers use: "imageio", "PIL" or
    "png-codec" (the package's own PNG and TIFF codecs)."""
    global _reader
    if _reader is None:
        for name in ("imageio", "PIL"):
            try:
                __import__(name)
            except ImportError:
                continue
            _reader = name
            break
        else:
            _reader = "png-codec"
    return _reader


def _read(path):
    lib = reader()
    if lib == "imageio":
        import imageio.v3 as iio

        return np.asarray(iio.imread(path))
    if lib == "PIL":
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im)
    with open(path, "rb") as f:
        head = f.read(4)
    return read_tiff(path) if head in _TIFF_SIGS else read_png(path)


def read_image(path):
    """Grayscale image -> (H, W) uint8/uint16 numpy (the first channel of
    a color image)."""
    img = _read(path)
    return img[..., 0] if img.ndim == 3 else img


def read_mask(path):
    """Label mask -> (H, W) int64 numpy, any bit depth preserved."""
    msk = _read(path)
    if msk.ndim == 3:
        msk = msk[..., 0]
    return msk.astype(np.int64)


def _check_gray(array, writer):
    array = np.asarray(array)
    if array.ndim != 2 or array.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{writer} takes (H, W) uint8/uint16, not "
                         f"{array.shape} {array.dtype}")
    return array


# baseline TIFF tags and field types
_TAGS = {256: "width", 257: "height", 258: "bits", 259: "compression",
         262: "photometric", 273: "offsets", 277: "samples",
         278: "rows_per_strip", 279: "byte_counts", 284: "planar"}
_TYPES = {3: "H", 4: "I"}  # SHORT, LONG


def write_tiff(path, array):
    """(H, W) uint8 or uint16 -> an uncompressed grayscale TIFF file, one
    strip, little-endian."""
    array = _check_gray(array, "write_tiff")
    h, w = array.shape
    data = array.astype(array.dtype.newbyteorder("<")).tobytes()
    entries = [(256, 4, w), (257, 4, h), (258, 3, 8 * array.itemsize),
               (259, 3, 1), (262, 3, 1), (273, 4, 8), (277, 3, 1),
               (278, 4, h), (279, 4, len(data)), (284, 3, 1)]
    ifd_offset = 8 + len(data) + (len(data) & 1)
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", ifd_offset))
        f.write(data + b"\x00" * (len(data) & 1))
        f.write(struct.pack("<H", len(entries)))
        for tag, kind, value in entries:
            f.write(struct.pack("<HHI", tag, kind, 1))
            f.write(struct.pack("<" + _TYPES[kind], value).ljust(4, b"\x00"))
        f.write(struct.pack("<I", 0))


def read_tiff(path):
    """An uncompressed 8/16-bit grayscale TIFF (first image; any strip
    layout, either byte order) -> (H, W) uint8 or uint16."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] not in _TIFF_SIGS:
        raise ValueError(f"{path}: not a TIFF file")
    order = "<" if blob[:2] == b"II" else ">"
    (ifd,) = struct.unpack(order + "I", blob[4:8])
    (count,) = struct.unpack(order + "H", blob[ifd:ifd + 2])
    fields = {}
    for i in range(count):
        tag, kind, n, raw = struct.unpack(
            order + "HHI4s", blob[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        if tag not in _TAGS:
            continue
        if kind not in _TYPES:
            raise ValueError(f"{path}: TIFF tag {tag} of type {kind} is not "
                             "supported")
        size = struct.calcsize(_TYPES[kind]) * n
        if size > 4:
            (offset,) = struct.unpack(order + "I", raw)
            raw = blob[offset:offset + size]
        fields[_TAGS[tag]] = struct.unpack(order + _TYPES[kind] * n,
                                           raw[:size])
    get = {k: v[0] for k, v in fields.items()}
    if (get.get("compression", 1) != 1 or get.get("samples", 1) != 1
            or get.get("bits") not in (8, 16)
            or get.get("photometric", 1) != 1
            or get.get("planar", 1) != 1):
        raise ValueError(f"{path}: only uncompressed 8/16-bit grayscale "
                         f"TIFF is supported, not {get}")
    h, w = get["height"], get["width"]
    data = b"".join(blob[o:o + n] for o, n in zip(fields["offsets"],
                                                  fields["byte_counts"]))
    dtype = np.dtype(np.uint8 if get["bits"] == 8 else order + "u2")
    img = np.frombuffer(data, dtype, h * w).reshape(h, w)
    return img.astype(dtype.newbyteorder("="))


def _chunk(kind, data):
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path, array):
    """(H, W) uint8 or uint16 -> a grayscale PNG file (filter 0)."""
    array = _check_gray(array, "write_png")
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
        raise ValueError(f"{path}: not a PNG or TIFF file, and no image "
                         "library (imageio, PIL) is installed")
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
