"""pctpu_torch — the PyTorch/CUDA port of `pctpu`, for NVIDIA Hopper (H100).

The JAX package `pctpu` is the reference; this package mirrors its module
names so each function's counterpart is easy to find. Plain tensor code is
PyTorch; each TPU (Pallas) kernel on the ported path is a hand-written CUDA
kernel (`csrc/*.cu`, built with nvcc at first use, bound with ctypes).

Devices: entry points run on CUDA unless the caller passes `device="cpu"`;
without CUDA they raise instead of falling back. A kernel wrapper given a
CPU tensor runs the kernel's plain PyTorch version; given a CUDA tensor it
launches the kernel or raises.

Precision: geometry is exact float32 (no TF32 anywhere), see `device.py`;
a bfloat16 product (the models' `compute_dtype="bfloat16"`) sums in
float32, as the reference's does.
"""
import torch

# exact f32 geometry: TF32 keeps ~10 mantissa bits, enough to move 1-NN
# choices and histogram bins (the Hopper form of the TPU's bf16 trap)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# bf16 products sum in f32 (cuBLAS may otherwise reduce in bf16)
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
