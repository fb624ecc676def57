"""Native (C++) host-side components with ctypes bindings (port of
`pctpu/native/__init__.py`): the concurrent raw-float32 file loader and
the occupied-voxel count (`fastio.cpp`), and the shared build of both
native libraries (`fastio.cpp`, and `spatial.cpp` for `native.spatial`).

Each library is compiled at first use, never at import, by one
`g++ -O3 [-std=c++17] -shared -fPIC ... -lpthread` into
`build/pctpu_torch/native/` at the root of the checkout. Its file name
carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded; g++ writes to a temporary name in
that directory, renamed into place, so processes that build the same
library at once never load a half-written file. A failed build raises
with g++'s output: unlike the reference, there is no scipy or numpy
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "pctpu_torch" / "native"
CXX = "g++"
# library name -> (source, flags); the reference's commands
LIBS = {
    "fastio": ("fastio.cpp", ("-O3", "-shared", "-fPIC")),
    "spatial": ("spatial.cpp", ("-O3", "-std=c++17", "-shared", "-fPIC")),
}
LINK = ("-lpthread",)

_loaded: Dict[str, ctypes.CDLL] = {}

_f32p = ctypes.POINTER(ctypes.c_float)


def source(name: str) -> Path:
    """The C++ source a library is compiled from."""
    return HERE / LIBS[name][0]


def _target(name: str) -> Path:
    src, flags = LIBS[name]
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join((CXX,) + flags + LINK).encode()
                            ).hexdigest()
    return BUILD_DIR / f"{Path(src).stem}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile library `name` unless it is built; returns its path. Raises
    with the compiler's output when the build fails."""
    out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", prefix=out.stem + ".",
                               dir=BUILD_DIR)
    os.close(fd)
    tmp = Path(tmp)
    cmd = [CXX, *LIBS[name][1], "-o", str(tmp), str(source(name)), *LINK]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cannot run {CXX} to build {name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)    # atomic: a concurrent loader sees all or none
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]


def get_lib() -> ctypes.CDLL:
    """The fastio library, built on first use (raises if it cannot be)."""
    lib = load("fastio")
    lib.read_f32.restype = ctypes.c_long
    lib.read_f32.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_long]
    lib.batch_read_f32.restype = ctypes.c_int
    lib.batch_read_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _f32p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.c_int]
    lib.voxel_count.restype = ctypes.c_long
    lib.voxel_count.argtypes = [_f32p, ctypes.c_long, ctypes.c_float]
    return lib


def available() -> bool:
    """Whether the fastio library builds and loads here. The functions
    below raise where it does not; none of them falls back."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def batch_read_f32(paths: List[str], floats_per_file: int,
                   n_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Load many raw-float32 files concurrently.

    Returns (arena [n_files, floats_per_file] f32, counts [n_files]:
    floats actually read, -1 for unreadable files)."""
    n = len(paths)
    arena = np.zeros((n, floats_per_file), np.float32)
    counts = np.zeros((n,), np.int64)
    lib = get_lib()
    if n > 0:
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        lib.batch_read_f32(
            c_paths, n, arena.ctypes.data_as(_f32p), floats_per_file,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n_threads)
    return arena, counts


def batch_read_velodyne(paths: List[str], max_points: int = 200_000,
                        n_threads: int = 8):
    """Concurrent KITTI scan loader -> list of (N_i, 3) xyz arrays (None
    for an unreadable file)."""
    arena, counts = batch_read_f32(paths, max_points * 4, n_threads)
    out = []
    for row, cnt in zip(arena, counts):
        if cnt < 0:
            out.append(None)
            continue
        n = int(cnt) // 4
        out.append(row[: n * 4].reshape(n, 4)[:, :3].copy())
    return out


def voxel_count(points: np.ndarray, leaf: float) -> int:
    """Occupied-voxel count (capacity sizing for voxel_downsample)."""
    points = np.ascontiguousarray(np.asarray(points)[:, :3], np.float32)
    return int(get_lib().voxel_count(points.ctypes.data_as(_f32p),
                                     points.shape[0], leaf))
