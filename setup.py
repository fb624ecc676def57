"""Package install (C48 parity — replaces the reference's CUDAExtension
builds with a pure-Python package plus one optional C shared library)."""
import subprocess
from pathlib import Path

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


NATIVE = [
    ("fastio.cpp", "_fastio.so", []),
    ("spatial.cpp", "_spatial.so", ["-std=c++17"]),
]


class BuildWithNative(build_py):
    def run(self):
        native_dir = Path(__file__).parent / "pctpu" / "native"
        for src_name, out_name, extra in NATIVE:
            src = native_dir / src_name
            out = native_dir / out_name
            try:
                subprocess.run(
                    ["g++", "-O3", *extra, "-shared", "-fPIC", "-o",
                     str(out), str(src), "-lpthread"],
                    check=True, timeout=180)
            except Exception:
                pass  # NumPy/scipy fallbacks cover every native entry point
        super().run()


setup(
    name="pctpu",
    version="0.1.0",
    description=("TPU-native point-cloud processing framework "
                 "(JAX/XLA/Pallas)"),
    packages=find_packages(include=["pctpu", "pctpu.*",
                                    "pctpu_torch", "pctpu_torch.*"]),
    # pctpu_torch's CUDA kernels are compiled by nvcc at first use
    package_data={"pctpu.native": ["*.cpp", "*.so"],
                  "pctpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "scipy",
    ],
    extras_require={
        "full": ["scikit-learn", "h5py", "pandas", "matplotlib"],
        "torch": ["torch"],     # the PyTorch/CUDA port, pctpu_torch
    },
    cmdclass={"build_py": BuildWithNative},
)
