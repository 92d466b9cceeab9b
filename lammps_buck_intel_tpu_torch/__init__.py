"""lammps_buck_intel_tpu_torch — the PyTorch + CUDA port for one H100.

Runs the cell-pair NVE main path of ``lammps_buck_intel_tpu`` (the JAX
package, which stays the unchanged reference), buck and buck/coul/long
with PPPM, through hand-written CUDA kernels: the cell-pair forces
(csrc/cellpair.cu), the cell-slot rebin (csrc/rebin.cu) and the PPPM
deposit, spectral solve and gather (csrc/pppm.cu), built with nvcc at
first use and bound with ctypes.  The package imports torch and never
jax.

Layout mirrors the JAX package: core/, io/, neighbor/, models/pair/,
models/kspace/, integrate/, run.py; ops/ holds the kernel build and
launch wrappers, utils/ the device-trace reader of the measurement
scripts.
"""

__version__ = "0.1.0"

from . import core
from . import io
