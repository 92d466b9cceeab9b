"""lammps_buck_intel_tpu_torch — the PyTorch + CUDA port for one H100.

Runs the cell-pair NVE main path of ``lammps_buck_intel_tpu`` (the JAX
package, which stays the unchanged reference) through hand-written CUDA
kernels: the cell-pair force kernel (csrc/cellpair.cu) and the cell-slot
rebin (csrc/rebin.cu), built with nvcc at first use and bound with
ctypes.  The package imports torch and never jax.

Layout mirrors the JAX package: core/, io/, neighbor/, models/pair/,
integrate/, run.py; ops/ holds the kernel build and launch wrappers.
"""

__version__ = "0.1.0"

from . import core
from . import io
