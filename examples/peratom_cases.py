"""The cases of the per-atom records (tests/goldens/torch_peratom.json and
torch_peratom_disp.json): decks of examples/decks/ in f64 with ``run: 0``,
built alike by the JAX package's deck runner (tools/record_peratom.py),
the port's CPU tests (tests/test_torch_peratom.py, test_torch_dump.py,
test_torch_peratom_disp.py) and chip_smoke.py.

``CASES`` (torch_peratom.json):

- ``silica_pppm``: cristobalite_pppm.yaml at one copy of
  examples/data.cristobalite, which gen_cristobalite.jitter displaced by
  up to 0.1 A (1,440 atoms), on the neighbor-list engine, PPPM at 1e-2;
- ``silica_ewald``: cristobalite_ewald.yaml on the same jittered copy,
  Ewald at 1e-4, the pair cutoff 10 A (the copy is 21.5 A along z: the
  deck's 12 A would break the minimum image);
- ``rhodo_class``: rhodo_class.yaml (1,728 atoms, the cell engine, SHAKE,
  specials, the bonded terms), PPPM at 1e-2, as the JAX package's
  tests/test_computes.py runs it;
- ``rhodo_npt``: rhodo_npt.yaml at one copy (the NPT engine's
  TracedPPPM).

``DISP_CASES`` (torch_peratom_disp.json), the dispersion k-space:

- ``silica_buck_long``: cristobalite_buck_long.yaml on the jittered copy
  (1,440 atoms): the box is too small for the cell engine, so the
  neighbor-list engine with the Coulomb PPPM beside the no-mix dispersion
  channels (CombinedKSpace[PPPM, BoundKSpace typed]), the Coulomb PPPM at
  1e-2 as in ``silica_pppm``;
- ``hexane_cut``, ``hexane_cut_arith``: hexane_gen.yaml and
  hexane_gen_arith.yaml on the 4x4x4 cut-out of gen_hexane (384 atoms,
  ``write_hexane_cut``) at cut 5 / skin 1: the cell engine with fix
  rigid/small and CellPPPMDisp (geometric), or the seven arithmetic
  channels (BoundKSpace typed on the slots).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import yaml

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DECKS = os.path.join(HERE, "decks")
SEED = 20261
NSAMPLE = 64
JITTER = 0.1
# case -> (deck, overrides); "jitter": read_data is the jittered copy
CASES = {
    "silica_pppm": ("cristobalite_pppm.yaml", dict(
        replicate=[1, 1, 1], engine="nlist", jitter=True,
        kspace_style={"name": "pppm", "accuracy": 1e-2, "order": 7})),
    "silica_ewald": ("cristobalite_ewald.yaml", dict(
        replicate=[1, 1, 1], jitter=True, pair_cut=10.0,
        kspace_style={"name": "ewald", "accuracy": 1e-4})),
    "rhodo_class": ("rhodo_class.yaml", dict(
        kspace_style={"name": "pppm", "accuracy": 1e-2})),
    "rhodo_npt": ("rhodo_npt.yaml", dict(replicate=[1, 1, 1])),
}
# "hexane_cut": read_data is the cut-out, at cut 5 and skin 1
DISP_CASES = {
    "silica_buck_long": ("cristobalite_buck_long.yaml", dict(
        replicate=[1, 1, 1], jitter=True,
        kspace_style={"name": "pppm/disp", "accuracy": 1e-2,
                      "force_disp_real": 1e-4, "order": 7, "mix": "none"})),
    "hexane_cut": ("hexane_gen.yaml", dict(hexane_cut=True)),
    "hexane_cut_arith": ("hexane_gen_arith.yaml", dict(hexane_cut=True)),
}
ALL_CASES = {**CASES, **DISP_CASES}
HEXANE_CUT = (4, 4, 4)


def case_config(name: str, jitter_path: str, hexane_path=None) -> dict:
    """The case's deck: precision double, run 0, its overrides applied;
    jitter_path: the jittered copy ``write_jitter`` wrote; hexane_path: the
    cut-out ``write_hexane_cut`` wrote (the hexane cases)."""
    deck, over = ALL_CASES[name]
    with open(os.path.join(DECKS, deck)) as f:
        cfg = yaml.safe_load(f)
    over = dict(over)
    cfg["read_data"] = (jitter_path if over.pop("jitter", False)
                        else os.path.join(ROOT, cfg["read_data"]))
    if over.pop("hexane_cut", False):
        cfg["read_data"] = hexane_path
        over.update(pair_cut=5.0)
        cfg["neighbor"] = dict(cfg["neighbor"], skin=1.0)
    if "pair_cut" in over:
        cfg["pair_style"] = dict(cfg["pair_style"], cut=over.pop("pair_cut"))
    cfg.update(precision="double", run=0, **over)
    return cfg


def write_jitter(path: str):
    """The jittered copy of examples/data.cristobalite at ``path``."""
    sys.path.insert(0, HERE)
    import gen_cristobalite

    gen_cristobalite.write(path, jitter_amp=JITTER)


def write_hexane_cut(path: str):
    """The 4x4x4 cut-out of the generated hexane liquid at ``path``."""
    sys.path.insert(0, HERE)
    import gen_hexane

    gen_hexane.write(path, *HEXANE_CUT)


def sample_idx(n: int) -> np.ndarray:
    """The NSAMPLE atoms of n whose values the record keeps."""
    return np.sort(np.random.default_rng(SEED).choice(n, NSAMPLE,
                                                      replace=False))


def half_spectrum_stress(sim, stress, cache: dict):
    """The port's ``stress_atom`` result ``stress`` in the JAX package's
    half-spectrum PPPM convention, which its record holds: the frame's
    k-space virial shares (``cache["kspace"]``, after ``stress_atom`` with
    that cache) swapped for ``_kspace_peratom(..., nyquist=False)``'s on
    the same f32 snapshot.  Only the off-diagonal components move."""
    from lammps_buck_intel_tpu_torch import computes

    if sim.kspace is None:
        return stress
    _, v_full = cache["kspace"]
    _, v_half = computes._kspace_peratom(sim, cache["atoms"], nyquist=False)
    dv = (v_half.to(v_full.dtype) - v_full).to(stress.dtype)
    return stress - dv * sim.units.nktv2p
