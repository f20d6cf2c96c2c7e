"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``raft_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface,
``build/raft_tpu_torch/<name>-<hash>.so`` at the repository root.  The
hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused.  Builds of several sources run in parallel (one ``nvcc`` each)
under an exclusive file lock, so concurrent processes do not race on the
same output.  Nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raft_tpu_torch"
SOURCES = ("corr_ondemand", "gru_gates", "lookup_encode", "pyramid_lookup",
           "upsample_loss")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``).  Raises when there is none."""
    path = shutil.which("nvcc")
    if path:
        return path
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin); the "
        "raft_tpu_torch CUDA kernels are compiled at first use")


def library_path(name: str) -> Path:
    """Where the library for source ``name`` lives at its current hash."""
    parts = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in parts)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together.  Returns ``{name: ptxas report}`` for the
    sources compiled by this call (empty when all were built already).
    Raises ``RuntimeError`` with nvcc's output when a build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports: Dict[str, str] = {}
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [(n, library_path(n)) for n in names
                if not library_path(n).is_file()]
        if not todo:
            return reports
        nvcc = find_nvcc()
        procs = []
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed for csrc/{name}.cu "
                                f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            reports[name] = log
        if failures:
            raise RuntimeError("\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check_device(name: str, *tensors) -> None:
    """Refuse a tensor off the card: the kernels run only there."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got one on "
                             f"{t.device}")


def stream_handle(t) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device, for a ctypes call."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_status(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{rc}")
