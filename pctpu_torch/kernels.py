"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source is compiled by nvcc for Hopper (`sm_90a`) into a shared
library with a plain C interface, loaded with ctypes. Builds happen at
first use, never at import, into `build/pctpu_torch/` at the root of the
checkout; a library's file name carries a hash of its source and flags,
so an edited source is rebuilt and a stale one is never loaded. All
missing libraries are compiled together, one nvcc process per source.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "pctpu_torch"
SOURCES = ("nn1.cu", "fpfh.cu", "icp_mega.cu", "banded.cu", "fps.cu",
           "ballgroup.cu", "gather.cu")
# --fmad=false: no contraction of a*b+c into FMA, so each kernel rounds
# exactly where its plain PyTorch version does (ties and histogram bins
# stay put)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build_all(sources=SOURCES) -> float:
    """Compile every missing library, all nvcc processes at once.
    Returns the seconds spent; raises with nvcc's output on failure."""
    todo = [s for s in sources if not _target(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        out = _target(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if missing."""
    lib = _loaded.get(source)
    if lib is None:
        build_all((source,))
        lib = ctypes.CDLL(str(_target(source)))
        _loaded[source] = lib
    return lib


def entry(source: str, name: str, n_int: int = 0, n_float: int = 0,
          n_ptr: int = 0):
    """C function `name` of `source`, typed as n_ptr pointers, then n_int
    ints, then n_float floats, then the stream; returns int."""
    fn = getattr(library(source), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_sms: dict = {}


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (cached per device)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def require_cuda(name: str, *tensors: torch.Tensor, dtypes=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (and of the matching dtype in `dtypes`, when given)."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensor {i} is on {t.device}, "
                             f"expected the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor {i} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise ValueError(f"{name}: tensor {i} has dtype {t.dtype}, "
                             f"expected {dtypes[i]}")
