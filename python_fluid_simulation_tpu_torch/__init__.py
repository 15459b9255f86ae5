"""python_fluid_simulation_tpu_torch — the fluid engine in PyTorch + CUDA.

A port of ``python_fluid_simulation_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA Hopper GPU.  It keeps the JAX package's module names so each
counterpart is easy to find, and imports neither JAX nor that package.

The hot solver loops are CUDA C++ kernels written for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_cuda_build.py``).  Every kernel wrapper routes on the device of its
tensors: CUDA tensors launch the kernel, CPU tensors run the plain PyTorch
version beside it — there is no other switch.  Entry points default to
``device="cuda"``; pass ``device="cpu"`` to run on the CPU.
"""

__version__ = "0.1.0"

from python_fluid_simulation_tpu_torch.config import (  # noqa: F401
    GridConfig2D,
    GridConfig3D,
    PhysicsConfig,
    SimConfig,
    SolverConfig,
)
