"""Hand-written CUDA kernels: build, ctypes binding and launch wrappers.

``cellpair`` (csrc/cellpair.cu), ``rebin`` (csrc/rebin.cu), ``pppm``
(csrc/pppm.cu: deposit in slot or atom order and by cell, spectral,
gather, the ad spectral and gather, the slab term, and the per-atom
spectral and gather, the latter also in slot order), ``bonded``
(csrc/bonded.cu: bonds and angles, dihedrals, impropers, and the per-atom
tallies of all four),
``verlet``
(csrc/verlet.cu: kick and drift, kick with the force sum, kinetic sums,
the thermostat chain), ``shake`` (csrc/shake.cu: reference bond vectors,
SHAKE positions, RATTLE velocities, the constraint virial), ``nlist``
(csrc/nlist.cu: the binned and the dense neighbor-list builds, the pair
pass over the list and its per-atom variant), ``npt`` (csrc/npt.cu: the
traced influence function, the per-axis kinetic sums, the barostat's
velocity scale and kick, the drift with the box dilation), ``ewald``
(csrc/ewald.cu: the structure factors with the energy and virial, the
forces, the per-atom energy and virial, the tables of a box on the card),
``pppm_disp`` (csrc/pppm_disp.cu: the multi-channel dispersion deposit,
the dispersion half-spectrum solve, the multi-channel ik gather, the
per-atom spectra and the per-atom gather, the latter also in slot order)
and ``rigid``
(csrc/rigid.cu: the rigid bodies' force and torque sums, their update
with the atoms' positions or velocities, the constraint virial) wrap one
kernel library each.
A wrapper checks device, dtype, shape and contiguity, launches on the
current CUDA stream and raises if the launch reports an error; it never
falls back to the plain version.  Each wrapper adds one to its entry of
``LAUNCHES`` when it launches, so a run can show that the main path went
through the kernels; ``LAUNCHES`` is the launch part of the counter store
of ``utils.trace``.  Modules here import no CUDA toolchain when
imported: a library is built and loaded at its first launch.
"""
from __future__ import annotations

from ..utils.trace import LAUNCHES

LAUNCHES.update({"cellpair": 0, "rebin_incremental": 0, "rebin": 0,
                 "pppm_deposit": 0, "pppm_deposit_cells": 0,
                 "pppm_spectral": 0, "pppm_gather": 0,
                 "pppm_peratom_spectral": 0, "pppm_peratom_gather": 0,
                 "pppm_peratom_slots": 0, "pppm_ad_spectral": 0,
                 "pppm_gather_ad": 0, "pppm_slab": 0, "ewald_traced": 0,
                 "bonded_bond_angle": 0, "dihedral_charmm": 0,
                 "improper_harmonic": 0, "bonded_peratom": 0,
                 "verlet_kick_drift": 0, "verlet_kick": 0, "verlet_ke": 0,
                 "nhc_scale": 0, "shake_ref": 0, "shake_positions": 0,
                 "rattle_velocities": 0, "shake_virial": 0, "nlist_build": 0,
                 "nlist_dense": 0, "nlist_pair": 0, "nlist_pair_peratom": 0,
                 "traced_greens": 0, "npt_ke3": 0, "npt_vscale_kick": 0,
                 "npt_drift_dilate": 0, "ewald_sk": 0, "ewald_force": 0,
                 "ewald_peratom": 0, "disp_deposit": 0, "disp_spectral": 0,
                 "disp_gather": 0, "disp_peratom_spectral": 0,
                 "disp_peratom_gather": 0, "disp_peratom_slots": 0,
                 "rigid_force_torque": 0, "rigid_update": 0,
                 "rigid_virial": 0})


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
