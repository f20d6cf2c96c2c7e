"""Optical-flow file formats (the port's copy of
``raft_tpu/data/frame_utils.py``): Middlebury ``.flo``, ``.pfm``, KITTI
16-bit PNG flow and disparity, and images through PIL.

Flow arrays are ``(H, W, 2)`` float32 holding ``(u, v) = (x, y)``
displacement; the KITTI readers also return an ``(H, W)`` validity array.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np
from PIL import Image

from raft_tpu_torch.data.png16 import read_png, write_png

#: Middlebury .flo magic number.
FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury ``.flo`` file -> ``(H, W, 2)`` float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, "<f4", count=1)
        if magic.size == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, "<i4", count=1)[0])
        h = int(np.fromfile(f, "<i4", count=1)[0])
        data = np.fromfile(f, "<f4", count=2 * w * h)
    if data.size != 2 * w * h:
        raise ValueError(f"{path}: truncated .flo ({data.size} floats)")
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write ``(H, W, 2)`` flow as Middlebury ``.flo``."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f".flo needs (H, W, 2), got {flow.shape}")
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], "<f4").tofile(f)
        np.array([w, h], "<i4").tofile(f)
        flow.astype("<f4").tofile(f)


def read_pfm(path: str) -> np.ndarray:
    """Read a ``.pfm`` of either byte order -> ``(H, W)`` or ``(H, W, 3)``
    float32, top row first."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        m = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f4")
    shape = (h, w, 3) if color else (h, w)
    # PFM stores the bottom row first.
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(path: str, data: np.ndarray) -> None:
    """Write a ``.pfm``: (H, W) -> ``Pf``, (H, W, 3) -> ``PF``, stored
    bottom-up little-endian (scale -1.0); the inverse of :func:`read_pfm`."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        header = b"Pf"
    elif data.ndim == 3 and data.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"PFM needs (H,W) or (H,W,3), got {data.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        np.flipud(data).astype("<f4").tofile(f)


def read_flow_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI flow PNG: ``flow = (png_uint16 - 2^15) / 64``; the third
    channel is the validity mask."""
    png = read_png(path).astype(np.float32)
    if png.ndim != 3 or png.shape[2] < 3:
        raise ValueError(f"{path}: expected 3-channel KITTI flow PNG")
    flow = (png[:, :, :2] - 2 ** 15) / 64.0
    valid = png[:, :, 2]
    return flow, valid


def write_flow_kitti(path: str, flow: np.ndarray) -> None:
    """Inverse of :func:`read_flow_kitti`, every pixel valid."""
    flow = np.asarray(flow)
    uv = (64.0 * flow[:, :, :2] + 2 ** 15)
    valid = np.ones(flow.shape[:2] + (1,), np.float64)
    png = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    write_png(path, png)


def read_disp_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI disparity PNG -> ``(flow, valid)`` with ``u = -disp``."""
    disp = read_png(path).astype(np.float32) / 256.0
    valid = disp > 0.0
    flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)
    return flow, valid


def read_image(path: str) -> np.ndarray:
    """Load an image as ``(H, W, C)`` uint8 (RGB or grayscale)."""
    with Image.open(path) as im:
        return np.array(im)


def read_gen(path: str) -> np.ndarray:
    """Read by extension: images -> uint8 arrays, ``.npy``/``.bin``/
    ``.raw`` -> ``np.load``, ``.flo``/``.pfm`` -> float32 flow (a PFM's
    third channel dropped)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm", ".bmp"):
        return read_image(path)
    if ext in (".bin", ".raw", ".npy"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(path)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    raise ValueError(f"unsupported extension: {path}")
