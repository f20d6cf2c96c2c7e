"""PNG codec for 8- and 16-bit images in NumPy (the port's copy of
``raft_tpu/data/png16.py``).

KITTI's optical-flow ground truth is 16 bits per channel RGB, which PIL
cannot read.  The decoder parses the chunks, inflates the IDAT stream with
:mod:`zlib` and undoes the row filters: in C through the native host
library when it loads, else in NumPy, row by row when every row is None,
Sub or Up, and one anti-diagonal of pixels at a time otherwise (real
KITTI files are mostly Paeth rows, whose pixels each need their left
neighbour).
Non-interlaced, 8 or 16 bits, gray, gray + alpha, RGB and RGBA.  The
writer emits filter type 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from raft_tpu_torch.native.build import load as native_lib

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> channel count


def read_png(path: str) -> np.ndarray:
    """Decode a PNG into ``(H, W)`` or ``(H, W, C)`` uint8/uint16."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")

    pos = 8
    idat = []
    header = None
    while pos < len(raw):
        (length,) = struct.unpack(">I", raw[pos:pos + 4])
        ctype = raw[pos + 4:pos + 8]
        data = raw[pos + 8:pos + 8 + length]
        pos += length + 12  # length + type + data + crc
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: missing IHDR")
    width, height, depth, color, _comp, _filt, interlace = header
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG unsupported")
    if color not in _CHANNELS or depth not in (8, 16):
        raise NotImplementedError(
            f"{path}: unsupported color type {color} / bit depth {depth}")

    nch = _CHANNELS[color]
    bpp = nch * depth // 8           # filter unit: bytes per pixel
    stride = width * bpp
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != height * (stride + 1):
        raise ValueError(
            f"{path}: IDAT inflates to {flat.size} bytes, expected "
            f"{height * (stride + 1)}")

    data8 = _unfilter(flat, height, stride, bpp)
    if depth == 16:
        img = data8.reshape(height, width, nch, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    else:
        img = data8.reshape(height, width, nch)
    if nch == 1:
        img = img[..., 0]
    return img


def _unfilter(flat: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """Undo the row filters of the inflated stream ``(height, 1 + stride)``
    -> ``(height, stride)`` uint8.

    With the native host library (``raft_tpu_torch/native``) every row
    goes through its C row filter, as in the JAX package.  Without it,
    rows of None, Sub and Up only go row by row, each row vectorized (Sub
    is a running sum over pixel columns, mod 256).  An Average or Paeth
    row needs its left neighbour decoded first, which a row loop can only
    walk pixel by pixel; so any such row sends the image through
    :func:`_unfilter_diagonals` instead."""
    lib = native_lib()
    if lib is not None:
        out = np.empty(height * stride, np.uint8)
        src = np.ascontiguousarray(flat)
        bad = lib.png_unfilter(src.ctypes.data, out.ctypes.data, height,
                               stride, bpp)
        if bad:
            raise ValueError(f"bad filter type {bad}")
        return out.reshape(height, stride)
    rows = flat.reshape(height, stride + 1)
    ftypes = rows[:, 0]
    bad = ftypes[ftypes > 4]
    if bad.size:
        raise ValueError(f"bad filter type {bad[0]}")
    if (ftypes >= 3).any():
        return _unfilter_diagonals(rows, height, stride, bpp)
    npix = stride // bpp
    scan = rows[:, 1:].astype(np.int64)
    out = np.zeros_like(scan)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        line = scan[y]
        ft = ftypes[y]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:  # Sub
            cur = (np.cumsum(line.reshape(npix, bpp), axis=0) & 0xFF).ravel()
        else:  # Up
            cur = (line + prev) & 0xFF
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def _unfilter_diagonals(rows: np.ndarray, height: int, stride: int,
                        bpp: int) -> np.ndarray:
    """Every filter type at once, one anti-diagonal of pixels at a time.

    A pixel (y, x) depends on its left (y, x-1), upper (y-1, x) and
    upper-left (y-1, x-1) neighbours, which lie on the two diagonals
    before its own (x + y = d); so each diagonal is decoded in one
    vectorized step over all its pixels and byte lanes, each pixel with
    its row's predictor: height + width steps instead of one per pixel
    of every Average or Paeth row."""
    ftypes = rows[:, 0].astype(np.intp)
    npix = stride // bpp
    scan = rows[:, 1:].reshape(height * npix, bpp).astype(np.int32)
    w1 = npix + 1
    # decoded bytes, with a zero row above and a zero column to the left
    out = np.zeros(((height + 1) * w1, bpp), np.int32)
    ys = np.arange(height)
    for d in range(height + npix - 1):
        y = ys[max(0, d - npix + 1):min(height, d + 1)]
        x = d - y
        up = y * w1 + x + 1
        left = up + w1 - 1
        a, b, c = out[left], out[up], out[up - 1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        out[left + 1] = (scan[y * npix + x]
                         + pred[ftypes[y], np.arange(len(y))]) & 0xFF
    out = out.reshape(height + 1, w1, bpp)[1:, 1:]
    return out.reshape(height, stride).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Encode ``(H, W)`` or ``(H, W, C)`` uint8/uint16 as PNG (filter 0)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nch = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[nch]
    if img.dtype == np.uint16:
        depth = 16
        payload = img.astype(">u2").tobytes()
        stride = w * nch * 2
    elif img.dtype == np.uint8:
        depth = 8
        payload = img.tobytes()
        stride = w * nch
    else:
        raise TypeError(f"dtype {img.dtype} not supported (uint8/uint16)")

    rows = np.frombuffer(payload, np.uint8).reshape(h, stride)
    scan = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(ctype: bytes, data: bytes) -> bytes:
        body = ctype + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    out = (_SIGNATURE + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(scan.tobytes(), 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(out)
