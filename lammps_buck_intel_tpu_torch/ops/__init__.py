"""Hand-written CUDA kernels: build, ctypes binding and launch wrappers.

``cellpair`` (csrc/cellpair.cu), ``rebin`` (csrc/rebin.cu), ``pppm``
(csrc/pppm.cu: deposit, spectral, gather), ``bonded`` (csrc/bonded.cu:
bonds and angles, dihedrals, impropers), ``verlet`` (csrc/verlet.cu:
kick and drift, kick with the force sum, kinetic sums, the thermostat
chain), ``shake`` (csrc/shake.cu: reference bond vectors, SHAKE
positions, RATTLE velocities, the constraint virial), ``nlist``
(csrc/nlist.cu: the neighbor-list build and the pair pass over the list)
and ``npt`` (csrc/npt.cu: the traced influence function, the per-axis
kinetic sums, the barostat's velocity scale and kick, the drift with the
box dilation) wrap one kernel library each.
A wrapper checks device, dtype, shape and contiguity, launches on the
current CUDA stream and raises if the launch reports an error; it never
falls back to the plain version.  Each wrapper adds one to its entry of
``LAUNCHES`` when it launches, so a run can show that the main path went
through the kernels.  Modules here import no CUDA toolchain when
imported: a library is built and loaded at its first launch.
"""
from __future__ import annotations

LAUNCHES = {"cellpair": 0, "rebin_incremental": 0, "rebin": 0,
            "pppm_deposit": 0, "pppm_spectral": 0, "pppm_gather": 0,
            "bonded_bond_angle": 0, "dihedral_charmm": 0,
            "improper_harmonic": 0, "verlet_kick_drift": 0, "verlet_kick": 0,
            "verlet_ke": 0, "nhc_scale": 0, "shake_ref": 0,
            "shake_positions": 0, "rattle_velocities": 0, "shake_virial": 0,
            "nlist_build": 0, "nlist_pair": 0, "traced_greens": 0,
            "npt_ke3": 0, "npt_vscale_kick": 0, "npt_drift_dilate": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
