"""Per-atom computes: ``compute pe/atom`` and ``compute stress/atom``.

Counterpart of ``lammps_buck_intel_tpu.computes`` (``pe_atom``,
``stress_atom``, ``evaluate``, the frame cache ``_cached``, ``_check_scope``
and the k-space dispatch ``_kspace_peratom``): the per-atom tallies of the
reference's ``/intel`` styles (pair_buck_intel.cpp:303-322 under
eflag_atom / vflag_atom; pppm_intel.cpp:224-252 poisson_peratom and
fieldforce_peratom) assembled into the two computes a deck names, on any
of the port's engines (the cell engine, the list ``Simulation``, the NPT
engine).  They run at dump cadence, outside the timed blocks.

The snapshot is each engine's ``atoms_on_device()``: the atoms in atom
order stay on the card, and only the dump writer copies results to the
host.  The contributions (the ``compute pe/atom pair kspace ...`` keyword
scope, by default all of them):

- ``pair``: half of every pair term to each of its atoms, on a fresh full
  list of the snapshot (``neighbor_list.make_spec`` at the style's
  largest cutoff times 1.0001, ``build_with_retry``; K9a or K9c), with the
  special-bond codes and the same-molecule exclusion of the engine, then
  ``driver.compute_pair_peratom`` (K9d); the CHARMM 1-4 pair terms join
  it (they are pair energies in the thermo ledger);
- ``kspace``: ``pppm.compute_peratom`` (K5, K10pa) for the generic
  ``PPPM``, the cell engine's ``CellPPPM`` (its mesh) and the NPT engine's
  ``TracedPPPM`` (rebuilt by ``setup_pppm`` on the current box with mesh,
  order and g_ewald pinned, as the JAX package does),
  ``ewald.ewald_compute_peratom`` (K11a, K11pa), or
  ``PPPMDisp.compute_peratom`` (K12b, K12pa) for pppm/disp: the cell
  engine's ``CellPPPMDisp`` (its cell-aligned dispersion mesh, b =
  B[type] in the positions' dtype) and ``BoundKSpace`` (typed or per-atom
  charges, ``BoundKSpace.compute_peratom``), summed over the solvers of a
  ``CombinedKSpace``;
- ``bond`` / ``angle`` / ``dihedral`` / ``improper``:
  ``harmonic.compute_bonded_peratom`` (K18b) over the engine's active
  bonded table (the SHAKE-stripped one the thermo emol sums);
- stress/atom adds the kinetic m v (x) v.

As in the JAX package the pair and k-space passes read the positions and
charges cast to f32 whatever the deck's precision, the bonded pass in f64.
The sums equal the thermo ledger: sum pe = epair (+ emol), and -trace(sum
stress) / (3 V) = press on decks whose constraints add no virial (SHAKE's
and the rigid bodies' are global only).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .utils import trace

_PAIR_KSPACE = ("pair", "kspace")
_BONDED_KEYS = ("bond", "angle", "dihedral", "improper")
_DEFAULT = _PAIR_KSPACE + _BONDED_KEYS


def _pair_list(sim, at: dict, flt=torch.float32):
    """The fresh full list of the snapshot the pair pass runs on: (x in
    ``flt``, box lengths in ``flt``, the list, use_special)."""
    from .neighbor import neighbor_list as nlmod

    style = sim.pair
    x = at["x"].to(flt)
    n, dev = x.shape[1], x.device
    box = sim.box
    L = np.asarray(box.lengths, np.float64)
    spec = nlmod.make_spec(n, L, math.sqrt(style.cutsq_max) * 1.0001)
    lo = torch.as_tensor(np.asarray(box.lo, np.float64)).to(dev, flt)
    Lt = torch.as_tensor(L).to(dev, flt)
    special = at["special"]
    use_special = special is not None and special[0].shape[1] > 0
    nl, _ = nlmod.build_with_retry(x, lo, Lt, spec,
                                   special if use_special else None)
    if at["mol"] is not None:
        nl = nlmod.exclude_molecule(nl, at["mol"])
    return x, Lt, nl, use_special


def _pair_peratom(sim, at: dict, flt=torch.float32):
    """(eatom, vatom) of the pair style on ``_pair_list``, the positions
    and charges in ``flt`` (f32 in the computes, as in the JAX package)."""
    from .models.pair.driver import compute_pair_peratom

    x, Lt, nl, use_special = _pair_list(sim, at, flt)
    return compute_pair_peratom(sim.pair, x, at["typ"], at["q"].to(flt), Lt,
                                nl, acc_dtype=flt, use_special=use_special)


def _solvers(ks):
    """The solvers of an engine's k-space term."""
    from .models.kspace.base import CombinedKSpace

    return ks.solvers if isinstance(ks, CombinedKSpace) else [ks]


def _kspace_peratom(sim, at: dict, flt=torch.float32, nyquist=True):
    """(eatom, vatom) of the engine's k-space term (zeros without one),
    summed over the solvers of a CombinedKSpace; the positions and charges
    in ``flt``, the PPPM spectra with ``nyquist`` (see
    ``pppm.peratom_spectral_plain``).  The dispatch order of the JAX
    ``_kspace_peratom``: ``CellPPPMDisp`` before the Coulomb solvers, an
    unbound ``PPPMDisp`` refused (the runner always binds it)."""
    from .models.kspace.base import BoundKSpace
    from .models.kspace.ewald import Ewald, ewald_compute_peratom
    from .models.kspace.pppm import PPPM, compute_peratom, setup_pppm
    from .models.kspace.pppm_cells import CellPPPM, CellPPPMDisp
    from .models.kspace.pppm_disp import PPPMDisp
    from .models.kspace.pppm_npt import TracedPPPM
    from .integrate.npt import NPTSimulation

    n, dev = at["x"].shape[1], at["x"].device
    if sim.kspace is None:
        return (torch.zeros(n, dtype=torch.float64, device=dev),
                torch.zeros((n, 6), dtype=torch.float64, device=dev))
    x, q = at["x"].to(flt), at["q"].to(flt)

    def one(s):
        if isinstance(s, PPPM):
            return compute_peratom(s, x, q, nyquist)
        if isinstance(s, CellPPPMDisp):
            return s.compute_peratom(x, at["typ"])
        if isinstance(s, CellPPPM):
            # the solver tables of the cell-aligned mesh; only the transfer
            # between slots and mesh differs
            return compute_peratom(s.pm, x, q, nyquist)
        if isinstance(s, BoundKSpace):
            return s.compute_peratom(x)
        if isinstance(s, PPPMDisp):
            raise TypeError("unbound PPPMDisp (the deck runner always binds "
                            "it in a BoundKSpace)")
        if isinstance(s, Ewald):
            if isinstance(sim, NPTSimulation):
                # the variable cell: the set-up's m triples on the CURRENT
                # box, as TracedPPPM below and Ewald.compute_traced do (the
                # JAX computes.py:162-163 keeps the set-up box's k vectors:
                # ROADMAP queue 3)
                return ewald_compute_peratom(s.at_box(sim.box.lengths), x, q)
            return ewald_compute_peratom(s, x, q)
        if isinstance(s, TracedPPPM):
            # the variable cell: the box-baked solver at the CURRENT box,
            # mesh, order, g_ewald, diff and slab factor pinned (the JAX
            # computes.py:178-182)
            pm0 = s.pm
            pm = setup_pppm(sim.box, at["q"].double().cpu().numpy(),
                            cutoff=1.0, accuracy_rel=1e-4,
                            qqrd2e=pm0.qqrd2e, order=pm0.order,
                            g_ewald=pm0.g_ewald, grid=pm0.grid,
                            diff=pm0.diff, slab=pm0.slab,
                            acc_dtype=pm0.acc_dtype)
            return compute_peratom(pm, x, q, nyquist)
        raise NotImplementedError(
            f"per-atom k-space for {type(s).__name__}")

    eat = vat = None
    for s in _solvers(sim.kspace):
        e, v = one(s)
        eat = e if eat is None else eat + e
        vat = v if vat is None else vat + v
    return eat, vat


def _check_scope(scope):
    bad = [s for s in scope
           if s not in _PAIR_KSPACE and s not in _BONDED_KEYS]
    if bad:
        raise NotImplementedError(
            f"per-atom scope {bad}: supported contributions are "
            f"{list(_PAIR_KSPACE) + list(_BONDED_KEYS)} (SHAKE/rigid "
            "constraint virials remain global-only)")


def _bonded_peratom(sim, at: dict, include):
    """Per-atom bonded tallies over the engine's active bonded table, the
    1-4 pair terms apart: (eatom, vatom, e14, v14) in f64."""
    from .models.bonded import compute_bonded_peratom

    n, dev = at["x"].shape[1], at["x"].device
    if sim.bonded is None or not sim.bonded.has_terms:
        z, z6 = (torch.zeros(n, dtype=torch.float64, device=dev),
                 torch.zeros((n, 6), dtype=torch.float64, device=dev))
        return z, z6, z, z6
    xs = tuple(at["x"].to(torch.float64).unbind(0))
    return compute_bonded_peratom(sim.bonded, xs, sim.box,
                                  acc_dtype=torch.float64, include=include)


def _cached(cache, key, fn):
    """Frame memo: pe_atom and stress_atom each use half of every (eatom,
    vatom) pass, so a dump that asks for both runs the pair and k-space
    passes once through a shared per-frame dict."""
    if cache is None:
        return fn()
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def _tallies(sim, scope, cache, which: int):
    """The sum of the (eatom, vatom)[which] contributions in scope, f64 on
    the device, and the snapshot (span ``peratom``)."""
    _check_scope(scope)
    with trace.span("peratom"):
        at = _cached(cache, "atoms", sim.atoms_on_device)
        out = None

        def add(t):
            nonlocal out
            t = t.to(torch.float64)
            out = t if out is None else out + t

        if "pair" in scope:
            add(_cached(cache, "pair", lambda: _pair_peratom(sim, at))[which])
        if "kspace" in scope and sim.kspace is not None:
            add(_cached(cache, "kspace",
                        lambda: _kspace_peratom(sim, at))[which])
        inc = tuple(k for k in _BONDED_KEYS if k in scope)
        if inc:
            b = _cached(cache, ("bonded", inc),
                        lambda: _bonded_peratom(sim, at, inc))
            add(b[which])
            if "pair" in scope:
                # the 1-4 pair terms belong to the pair ledger (thermo adds
                # them to evdwl and ecoul)
                add(b[2 + which])
        if out is None:
            n, dev = at["x"].shape[1], at["x"].device
            out = torch.zeros((n,) if which == 0 else (n, 6),
                              dtype=torch.float64, device=dev)
        return out, at


def pe_atom(sim, scope=_DEFAULT, cache=None) -> torch.Tensor:
    """``compute pe/atom`` (compute_pe_atom.cpp): (N,) f64 per-atom
    potential energy over the scope's contributions, on the engine's
    device.  sum = epair (+ emol) of the thermo row."""
    return _tallies(sim, tuple(scope), cache, 0)[0]


def stress_atom(sim, scope=_DEFAULT, include_ke: bool = True,
                cache=None) -> torch.Tensor:
    """``compute stress/atom`` (compute_stress_atom.cpp): (N, 6) f64
    per-atom stress in pressure * volume units, S_i = -(mvv2e m_i v_i (x)
    v_i + W_i) nktv2p (xx, yy, zz, xy, xz, yz), so that press = -trace(sum
    S) / (3 V) on decks without constraint virials.  The PPPM virial
    shares sum to the full-spectrum virial (``pppm.peratom_spectral_plain``
    with ``nyquist``), where the JAX package's half-spectrum shares miss it
    off the diagonal."""
    w, at = _tallies(sim, tuple(scope), cache, 1)
    u = sim.units
    if include_ke:
        v = at["v"].to(torch.float64)
        mc = at["mass"] * u.mvv2e
        w = w + torch.stack([mc * v[a] * v[b] for a, b in
                             ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                              (1, 2))], -1)
    return -w * u.nktv2p


_COMPUTES = {"pe/atom": pe_atom, "stress/atom": stress_atom}


def evaluate(sim, name: str, scope=None, cache=None) -> torch.Tensor:
    """A named compute on the current frame.  scope: the optional LAMMPS
    keyword list (e.g. ["pair", "kspace"]); cache: a per-frame dict that
    shares the pair and k-space passes between computes (``_cached``)."""
    fn = _COMPUTES.get(name)
    if fn is None:
        raise NotImplementedError(
            f"compute {name!r}: only {sorted(_COMPUTES)} implemented")
    return fn(sim, tuple(scope) if scope else _DEFAULT, cache=cache)
