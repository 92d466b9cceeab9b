"""Hand-written CUDA kernels: build, ctypes binding and launch wrappers.

``cellpair`` (csrc/cellpair.cu), ``rebin`` (csrc/rebin.cu) and ``pppm``
(csrc/pppm.cu: deposit, spectral, gather) wrap one kernel library each.
A wrapper checks device, dtype, shape and contiguity, launches on the
current CUDA stream and raises if the launch reports an error; it never
falls back to the plain version.  Each wrapper adds one to its entry of
``LAUNCHES`` when it launches, so a run can show that the main path went
through the kernels.  Modules here import no CUDA toolchain when
imported: a library is built and loaded at its first launch.
"""
from __future__ import annotations

LAUNCHES = {"cellpair": 0, "rebin_incremental": 0, "rebin": 0,
            "pppm_deposit": 0, "pppm_spectral": 0, "pppm_gather": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
