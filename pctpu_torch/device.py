"""Device selection and precision checks for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU; without a
card they raise rather than silently running the plain versions. Every
entry point also refuses to run when float32 matmuls may use TF32.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def check_precision() -> None:
    """Raise unless float32 matmuls run in full float32."""
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        raise RuntimeError(
            f"float32 matmul precision is {prec!r}; the port's geometry "
            "needs 'highest' (exact f32, no TF32): call "
            "torch.set_float32_matmul_precision('highest')")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is enabled; the port needs exact float32")


def f32_square(x: float) -> float:
    """float32(x) ** 2 rounded to float32: the reference's f32 thresholds
    (`jnp.float32(dist_thresh) ** 2`)."""
    return float(torch.tensor(float(x), dtype=torch.float32) ** 2)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only
    when the caller names it. Raises when CUDA is asked for (or implied)
    but absent. Also runs `check_precision`."""
    check_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
