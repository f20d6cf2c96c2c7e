"""Host-side training augmentation in NumPy (the port's copy of
``raft_tpu/data/augment.py``).

Photometric color jitter (asymmetric with probability 0.2 for dense
data), occlusion "eraser" rectangles on frame 2, a random scale with
independent x / y stretch, horizontal / vertical flips with the flow's
sign fixed, a random crop, and the sparse variant's nearest-neighbour
flow-map rescale.  Every random draw comes from the caller's
``np.random.Generator``, in the JAX package's order, so a seed gives the
same sample in both packages.

Two backends compute the same thing: the C ops of the native host library
(``raft_tpu_torch/native/aug_ops.c``: resize + flip + crop fused into one
inverse-mapped pass over the output crop, photometric ops in one pass
without float temporaries, the GIL released so the loader's threads
scale), and NumPy + cv2 where the library is unavailable.  Both consume
the generator identically.  ``cv2`` is imported only by the fallback
functions that use it: the native path does not need it.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np

from raft_tpu_torch.native.build import aug_lib as _nlib

_cv2_module = None


def _cv2():
    """cv2, configured once: single-threaded (the loader's threads are the
    parallelism) and without OpenCL."""
    global _cv2_module
    if _cv2_module is None:
        import cv2

        cv2.setNumThreads(0)
        try:
            cv2.ocl.setUseOpenCL(False)
        except AttributeError:  # minimal cv2 builds
            pass
        _cv2_module = cv2
    return _cv2_module


def _warp_native(lib, arr: np.ndarray, crop: Tuple[int, int], sx: float,
                 sy: float, rh: int, rw: int, hflip: bool, vflip: bool,
                 x0: int, y0: int,
                 chan_scale: Optional[np.ndarray] = None) -> np.ndarray:
    """Fused resize (cv2's center-aligned bilinear) + flip + crop."""
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    out_shape = (crop[0], crop[1]) if arr.ndim == 2 \
        else (crop[0], crop[1], c)
    out = np.empty(out_shape, arr.dtype)
    args = (arr.ctypes.data, h, w, c, out.ctypes.data, crop[0], crop[1],
            sx, sy, rh, rw, int(hflip), int(vflip), x0, y0)
    if arr.dtype == np.uint8:
        lib.aug_warp_u8(*args)
    else:
        if chan_scale is None:
            chan_scale = np.ones(c, np.float32)
        cs = np.ascontiguousarray(chan_scale, np.float32)
        lib.aug_warp_f32(*args, cs.ctypes.data)
    return out


# ---------------------------------------------------------------------------
# Photometric jitter (torchvision ColorJitter's parameterization)
# ---------------------------------------------------------------------------

def _native_buf(img: np.ndarray, inplace: bool) -> np.ndarray:
    """A contiguous uint8 buffer for an in-place C op (``img`` itself when
    the caller owns a mutable working copy)."""
    if inplace and img.dtype == np.uint8 and img.flags.c_contiguous:
        return img
    return np.array(img, dtype=np.uint8, order="C")


def _adjust_brightness(img: np.ndarray, factor: float,
                       inplace: bool = False) -> np.ndarray:
    # PIL ImageEnhance.Brightness: blend with black.
    lib = _nlib()
    if lib is not None:
        out = _native_buf(img, inplace)
        lib.aug_brightness(out.ctypes.data, out.size, factor)
        return out
    return np.clip(img.astype(np.float32) * factor, 0, 255).astype(np.uint8)


def _adjust_contrast(img: np.ndarray, factor: float,
                     inplace: bool = False) -> np.ndarray:
    # PIL ImageEnhance.Contrast: blend with the mean gray, rounded.
    lib = _nlib()
    if lib is not None:
        out = _native_buf(img, inplace)
        n_px = out.size // 3
        mean = round(lib.aug_gray_sum(out.ctypes.data, n_px) / n_px)
        lib.aug_contrast(out.ctypes.data, out.size, factor, float(mean))
        return out
    cv2 = _cv2()
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    mean = round(float(gray.mean()))
    out = img.astype(np.float32) * factor + mean * (1.0 - factor)
    return np.clip(out, 0, 255).astype(np.uint8)


def _adjust_saturation(img: np.ndarray, factor: float,
                       inplace: bool = False) -> np.ndarray:
    # PIL ImageEnhance.Color: blend with the grayscale image.
    lib = _nlib()
    if lib is not None:
        out = _native_buf(img, inplace)
        lib.aug_saturation(out.ctypes.data, out.size // 3, factor)
        return out
    cv2 = _cv2()
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)[..., None].astype(np.float32)
    out = img.astype(np.float32) * factor + gray * (1.0 - factor)
    return np.clip(out, 0, 255).astype(np.uint8)


def _adjust_hue(img: np.ndarray, shift: float,
                inplace: bool = False) -> np.ndarray:
    # shift in [-0.5, 0.5] turns of the hue circle (torchvision's).
    lib = _nlib()
    if lib is not None:
        out = _native_buf(img, inplace)
        lib.aug_hue_shift(out.ctypes.data, out.size // 3,
                          int(round(shift * 180.0)))
        return out
    cv2 = _cv2()
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    h = hsv[..., 0].astype(np.int16)  # cv2's uint8 hue is [0, 180)
    h = (h + int(round(shift * 180.0))) % 180
    hsv[..., 0] = h.astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


@dataclasses.dataclass(frozen=True)
class ColorJitter:
    """Brightness, contrast and saturation factors ~ U[1 - x, 1 + x] and a
    hue shift ~ U[-h, h], applied in a random order."""

    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.5 / 3.14

    def __call__(self, rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
        factors = {
            "brightness": rng.uniform(max(0.0, 1 - self.brightness),
                                      1 + self.brightness),
            "contrast": rng.uniform(max(0.0, 1 - self.contrast),
                                    1 + self.contrast),
            "saturation": rng.uniform(max(0.0, 1 - self.saturation),
                                      1 + self.saturation),
            "hue": rng.uniform(-self.hue, self.hue),
        }
        ops = ["brightness", "contrast", "saturation", "hue"]
        order = rng.permutation(ops)

        # One working copy that the C ops change in place; the NumPy
        # versions ignore ``inplace`` and return new arrays.
        if _nlib() is not None:
            img = np.array(img, dtype=np.uint8, order="C")
        for name in order:
            f = factors[str(name)]
            if name == "brightness":
                img = _adjust_brightness(img, f, inplace=True)
            elif name == "contrast":
                img = _adjust_contrast(img, f, inplace=True)
            elif name == "saturation":
                img = _adjust_saturation(img, f, inplace=True)
            else:
                img = _adjust_hue(img, f, inplace=True)
        return img


# ---------------------------------------------------------------------------
# Dense augmentor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlowAugmentor:
    """Dense-flow augmentation.  ``crop_size`` is ``(H, W)``; the scale is
    ``2 ** U(min_scale, max_scale)`` with independent x / y stretch with
    probability ``stretch_prob``, clamped so the result covers the crop
    plus 8 pixels."""

    crop_size: Tuple[int, int]
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: bool = True
    spatial_aug_prob: float = 0.8
    stretch_prob: float = 0.8
    max_stretch: float = 0.2
    h_flip_prob: float = 0.5
    v_flip_prob: float = 0.1
    asymmetric_color_aug_prob: float = 0.2
    eraser_aug_prob: float = 0.5
    jitter: ColorJitter = dataclasses.field(default_factory=ColorJitter)

    def color_transform(self, rng, img1, img2):
        if rng.random() < self.asymmetric_color_aug_prob:
            return self.jitter(rng, img1), self.jitter(rng, img2)
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.jitter(rng, stack)
        return np.split(stack, 2, axis=0)

    def eraser_transform(self, rng, img1, img2, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            # one draw sequence for both backends
            rects = [(int(rng.integers(0, wd)), int(rng.integers(0, ht)),
                      int(rng.integers(bounds[0], bounds[1])),
                      int(rng.integers(bounds[0], bounds[1])))
                     for _ in range(rng.integers(1, 3))]
            lib = _nlib()
            if lib is not None:
                img2 = _native_buf(img2, inplace=False)
                sums = (ctypes.c_double * 3)()
                n_px = img2.size // 3
                lib.aug_channel_sums(img2.ctypes.data, n_px, sums)
                # NumPy's float64 mean assigned into uint8 truncates
                mc = [int(s / n_px) for s in sums]
                for x0, y0, dx, dy in rects:
                    lib.aug_fill_rect(img2.ctypes.data, ht, wd, y0, x0,
                                      dy, dx, mc[0], mc[1], mc[2])
                return img1, img2
            img2 = img2.copy()
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for x0, y0, dx, dy in rects:
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    def _sample_scales(self, rng, ht, wd, pad):
        floor = max((self.crop_size[0] + pad) / float(ht),
                    (self.crop_size[1] + pad) / float(wd))
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
        return max(sx, floor), max(sy, floor)

    def spatial_transform(self, rng, img1, img2, flow):
        ht, wd = img1.shape[:2]
        sx, sy = self._sample_scales(rng, ht, wd, pad=8)

        # every random decision drawn up front, so both backends consume
        # the generator identically
        if not (rng.random() < self.spatial_aug_prob):
            sx = sy = 1.0
        hflip = vflip = False
        if self.do_flip:
            hflip = rng.random() < self.h_flip_prob
            vflip = rng.random() < self.v_flip_prob
        # cv2.resize's dsize rounding is cvRound: half to even
        rh = int(np.rint(ht * sy)) if sy != 1.0 else ht
        rw = int(np.rint(wd * sx)) if sx != 1.0 else wd
        # max(1, .): an image exactly crop-sized crops at the origin
        y0 = int(rng.integers(0, max(1, rh - self.crop_size[0])))
        x0 = int(rng.integers(0, max(1, rw - self.crop_size[1])))

        lib = _nlib()
        if lib is not None:
            # the flow's unit rescale and the flips' sign fixes fold into
            # the f32 warp's channel scale
            cs = np.array([sx * (-1.0 if hflip else 1.0),
                           sy * (-1.0 if vflip else 1.0)], np.float32)
            warp = lambda a, s: _warp_native(
                lib, a, self.crop_size, sx, sy, rh, rw, hflip, vflip,
                x0, y0, s)
            return warp(img1, None), warp(img2, None), warp(flow, cs)

        if sx != 1.0 or sy != 1.0:
            cv2 = _cv2()
            img1 = cv2.resize(img1, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            flow = cv2.resize(flow, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            flow = flow * [sx, sy]
        if hflip:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
        if vflip:
            img1 = img1[::-1, :]
            img2 = img2[::-1, :]
            flow = flow[::-1, :] * [1.0, -1.0]
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, rng: np.random.Generator, img1, img2, flow):
        img1, img2 = self.color_transform(rng, img1, img2)
        img1, img2 = self.eraser_transform(rng, img1, img2)
        img1, img2, flow = self.spatial_transform(rng, img1, img2, flow)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow.astype(np.float32)))


# ---------------------------------------------------------------------------
# Sparse augmentor (KITTI / HD1K)
# ---------------------------------------------------------------------------

def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
    """Rescale a sparse flow field by scattering the valid samples into
    the resized grid at rounded coordinates (a bilinear resize would mix
    valid and invalid pixels at their borders)."""
    ht, wd = flow.shape[:2]
    ys, xs = np.nonzero(valid >= 1)
    flow0 = flow[ys, xs].astype(np.float32)

    ht1 = int(round(ht * fy))
    wd1 = int(round(wd * fx))
    xx = np.round(xs * fx).astype(np.int32)
    yy = np.round(ys * fy).astype(np.int32)
    flow1 = flow0 * [fx, fy]

    keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
    flow_img = np.zeros([ht1, wd1, 2], dtype=np.float32)
    valid_img = np.zeros([ht1, wd1], dtype=np.int32)
    flow_img[yy[keep], xx[keep]] = flow1[keep]
    valid_img[yy[keep], xx[keep]] = 1
    return flow_img, valid_img


@dataclasses.dataclass
class SparseFlowAugmentor(FlowAugmentor):
    """Sparse-flow augmentation for KITTI / HD1K: symmetric color with a
    softer jitter, no stretch, horizontal flip only, crop offsets drawn
    past the image border by (20, 50) margins and then clamped."""

    do_flip: bool = False
    jitter: ColorJitter = dataclasses.field(default_factory=lambda: ColorJitter(
        brightness=0.3, contrast=0.3, saturation=0.3, hue=0.3 / 3.14))
    margin_y: int = 20
    margin_x: int = 50

    def color_transform(self, rng, img1, img2):  # symmetric only
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.jitter(rng, stack)
        return np.split(stack, 2, axis=0)

    def spatial_transform(self, rng, img1, img2, flow, valid):
        ht, wd = img1.shape[:2]
        floor = max((self.crop_size[0] + 1) / float(ht),
                    (self.crop_size[1] + 1) / float(wd))
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = max(scale, floor)

        if not (rng.random() < self.spatial_aug_prob):
            sx = sy = 1.0
        hflip = self.do_flip and rng.random() < 0.5
        # the sparse flow and valid mask keep the NumPy scatter rescale;
        # only the two images take the native fused path
        if sx != 1.0:
            flow, valid = resize_sparse_flow_map(flow, valid, fx=sx, fy=sy)
        rh, rw = valid.shape[:2]
        if hflip:
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]

        y0 = int(rng.integers(0, rh - self.crop_size[0] + self.margin_y))
        x0 = int(rng.integers(-self.margin_x,
                              rw - self.crop_size[1] + self.margin_x))
        y0 = int(np.clip(y0, 0, rh - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, rw - self.crop_size[1]))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]

        lib = _nlib()
        if lib is not None:
            warp = lambda a: _warp_native(
                lib, a, self.crop_size, sx, sy, rh, rw, hflip, False,
                x0, y0)
            return warp(img1), warp(img2), flow[sl], valid[sl]

        if sx != 1.0:
            cv2 = _cv2()
            img1 = cv2.resize(img1, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
        if hflip:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
        return img1[sl], img2[sl], flow[sl], valid[sl]

    def __call__(self, rng, img1, img2, flow, valid):  # type: ignore[override]
        img1, img2 = self.color_transform(rng, img1, img2)
        img1, img2 = self.eraser_transform(rng, img1, img2)
        img1, img2, flow, valid = self.spatial_transform(
            rng, img1, img2, flow, valid)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow.astype(np.float32)),
                np.ascontiguousarray(valid))
