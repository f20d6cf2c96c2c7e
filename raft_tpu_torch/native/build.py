"""Build and load the port's native host library (the port's copy of
``raft_tpu/native/build.py``).

``raft_tpu_torch/native/*.c`` (the PNG row filter and the augmentation
ops: host code, not kernels) is compiled with ``cc -O3 -shared -fPIC`` at
first use into ``build/raft_tpu_torch/raftnative-<hash>.so`` at the
repository root.  The hash covers the sources and the flags, so an edited
source rebuilds and an unchanged one is reused.  The build runs under an
exclusive file lock and lands with an atomic ``os.replace``, so concurrent
processes do not race on it.  Nothing is compiled at import.

Every caller degrades when the library is unavailable (no compiler, a
failed build): ``load()`` returns None and the NumPy / cv2 versions run,
slower but equal.  ``RAFT_TPU_TORCH_NO_NATIVE_AUG=1`` makes the
augmentors take those versions even when the library loads.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raft_tpu_torch"
SOURCES = ("png_filters.c", "aug_ops.c")
CFLAGS = ("-O3", "-shared", "-fPIC")
NO_NATIVE_AUG_ENV = "RAFT_TPU_TORCH_NO_NATIVE_AUG"

_LOCK = threading.Lock()
_state = {"lib": None, "failed": False, "build_s": None, "error": None}


def library_path() -> Path:
    """Where the library lives at the sources' current hash."""
    digest = hashlib.sha256(
        b"".join((SRC_DIR / s).read_bytes() for s in SOURCES)
        + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"raftnative-{digest}.so"


def _compile(out: Path) -> None:
    cc = shutil.which("cc")
    if cc is None:
        raise OSError("no C compiler (cc) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():                 # another process built it
            return
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([cc, *CFLAGS, "-o", str(tmp),
                        *(str(SRC_DIR / s) for s in SOURCES), "-lm"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point's signature (those of the JAX loader)."""
    c = ctypes
    lib.png_unfilter.restype = c.c_int
    lib.png_unfilter.argtypes = [c.c_void_p, c.c_void_p, c.c_long, c.c_long,
                                 c.c_int]
    lib.aug_gray_sum.restype = c.c_double
    lib.aug_gray_sum.argtypes = [c.c_void_p, c.c_long]
    lib.aug_brightness.restype = None
    lib.aug_brightness.argtypes = [c.c_void_p, c.c_long, c.c_float]
    lib.aug_contrast.restype = None
    lib.aug_contrast.argtypes = [c.c_void_p, c.c_long, c.c_float, c.c_float]
    lib.aug_saturation.restype = None
    lib.aug_saturation.argtypes = [c.c_void_p, c.c_long, c.c_float]
    lib.aug_hue_shift.restype = None
    lib.aug_hue_shift.argtypes = [c.c_void_p, c.c_long, c.c_int]
    lib.aug_channel_sums.restype = None
    lib.aug_channel_sums.argtypes = [c.c_void_p, c.c_long,
                                     c.POINTER(c.c_double)]
    lib.aug_fill_rect.restype = None
    lib.aug_fill_rect.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_int,
                                  c.c_int, c.c_int, c.c_int, c.c_ubyte,
                                  c.c_ubyte, c.c_ubyte]
    warp = [c.c_void_p, c.c_long, c.c_long, c.c_long, c.c_void_p, c.c_long,
            c.c_long, c.c_double, c.c_double, c.c_long, c.c_long, c.c_int,
            c.c_int, c.c_long, c.c_long]
    lib.aug_warp_u8.restype = None
    lib.aug_warp_u8.argtypes = list(warp)
    lib.aug_warp_f32.restype = None
    lib.aug_warp_f32.argtypes = list(warp) + [c.c_void_p]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library, built first if needed; None when it cannot be
    built or loaded (the reason is in :func:`status`).  Tried once per
    process."""
    if _state["lib"] is not None or _state["failed"]:
        return _state["lib"]
    with _LOCK:
        if _state["lib"] is not None or _state["failed"]:
            return _state["lib"]
        try:
            out = library_path()
            if not out.is_file():
                t0 = time.perf_counter()
                _compile(out)
                _state["build_s"] = time.perf_counter() - t0
            _state["lib"] = _bind(ctypes.CDLL(str(out)))
        except (OSError, subprocess.SubprocessError, AttributeError) as e:
            _state["failed"] = True
            _state["error"] = f"{type(e).__name__}: {e}"
        return _state["lib"]


def status() -> dict:
    """Whether the library loaded, the seconds its build took in this
    process (None when it was built already or not at all), its path and
    the error that kept it from loading."""
    return {"loaded": _state["lib"] is not None,
            "build_s": _state["build_s"], "path": str(library_path()),
            "error": _state["error"]}


def aug_lib() -> Optional[ctypes.CDLL]:
    """The library for the augmentors: None under
    ``RAFT_TPU_TORCH_NO_NATIVE_AUG``, else :func:`load`."""
    if os.environ.get(NO_NATIVE_AUG_ENV):
        return None
    return load()
