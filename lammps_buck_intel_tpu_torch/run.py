"""Deck runner for the PyTorch port.

Counterpart of ``lammps_buck_intel_tpu.run`` for the decks this port
runs: with ``engine: cellpair`` under ``fix nve`` or ``fix nvt``, with or
without ``fix shake`` (a fix list without nve or nvt integrates as NVE);
and, whatever ``engine`` says (the JAX package's NPT branch comes before
the engine choice), ``fix npt`` (iso, aniso or per-axis x/y/z, mtk,
pchain, tchain; with or without ``fix shake``) on the neighbor-list NPT
engine (``integrate.npt.NPTSimulation``) with the variable-cell PPPM
(``pppm_npt.TracedPPPM``) on the generic mesh of the deck's box.  Atoms: a
lattice built with ``create_atoms`` or atoms read with ``read_data`` (atom
style charge or full, optionally ``replicate``d); ``pair_style buck``, or
``buck/coul/long`` / ``lj/charmm/coul/long`` with ``kspace_style pppm``
(ik); ``special_bonds``, harmonic bonds, harmonic or CHARMM angles, CHARMM
dihedrals and harmonic impropers (examples/decks/buck.yaml,
buck_big.yaml, cristobalite_pppm.yaml, rhodo_nve.yaml, rhodo_32k.yaml,
rhodo_class.yaml, rhodo_flex_nve.yaml, rhodo_flex_nvt.yaml,
rhodo_npt.yaml).  Every other deck key or value raises
NotImplementedError naming its ROADMAP item; nothing is ignored.  A
relative ``read_data`` path resolves against the working directory, as
in the JAX package.

CLI:  python -m lammps_buck_intel_tpu_torch.run examples/decks/buck.yaml \
          --device cuda [--steps N]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

# deck key -> where its port stands in ROADMAP queue 1
_UNPORTED_KEYS = {
    "delete_atoms": "item 15",
    "regions": "item 15",
    "exclude_intra": "item 13",
    "dump": "item 15",
    "write_data": "item 15",
    "write_restart": "item 15",
    "minimize": "item 15",
    "devices": "item 16",
    "devices_2d": "item 16",
    "pair_kernel": "queue 2 (the port has one pair kernel)",
}
_KEYS = {"units", "precision", "timestep", "engine", "lattice", "mass",
         "read_data", "replicate", "velocity", "pair_style", "kspace_style",
         "neighbor", "fixes", "thermo", "run", "cap", "special_bonds",
         "special_bonds_coul", "bond_style", "angle_style", "dihedral_style",
         "improper_style"}
# fix name -> (keys the port reads, ROADMAP item of an unported fix)
_FIX_KEYS = {"nve": {"name"},
             "nvt": {"name", "t_start", "t_stop", "t_damp", "tchain"},
             "shake": {"name", "m", "b", "a", "iters", "tol"},
             "npt": {"name", "t_start", "t_stop", "t_damp", "tchain", "iso",
                     "aniso", "x", "y", "z", "mtk", "pchain"}}
_UNPORTED_FIXES = {
    "rigid/small": "item 13 (rigid bodies, K15)",
    "rigid/npt/small": "item 13 (rigid bodies under the barostat, K15)",
}
# fix npt keywords of a tilted (triclinic) barostat
_NPT_TILT_KEYS = {"tri", "xy", "xz", "yz"}
# kspace_style pieces the port refuses, by ROADMAP queue 1 item
_KSPACE_UNPORTED = {
    "ewald": "item 10 (Ewald, K11)",
    "pppm/disp": "item 13 (dispersion PPPM, K12 / K16d)",
    "diff": "item 10 (pppm diff ad, K10)",
    "slab": "item 10 (kspace_modify slab, K10)",
    "grid": "item 10 (kspace_modify mesh)",
}
# bonded styles whose formula the kernels hard-code
_BONDED_STYLES = {"bond": {"harmonic"}, "angle": {"harmonic", "charmm"},
                  "dihedral": {"charmm"}, "improper": {"harmonic"}}
_SPECIAL_SETS = {"charmm": ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
                 "amber": ([0.0, 0.0, 0.5], [0.0, 0.0, 1.0 / 1.2])}
# kspace_style keys the port reads; "grid" (kspace_modify mesh) is left
# out because the cell-pair engine aligns the mesh to its cells
_KSPACE_KEYS = {"name", "accuracy", "order", "diff", "gewald"}


def _parse_pair_key(k: str):
    i, j = k.split()
    return (int(i) - 1, int(j) - 1)


def _check_npt(cfg: dict, fx: dict):
    """fix npt: one pressure form, no other integrator, no unported
    variable-cell piece (the JAX package's NPT branch)."""
    others = [f["name"] for f in cfg["fixes"] if f["name"] in ("nve", "nvt")]
    if others:
        raise ValueError(f"fix npt integrates the atoms; drop fix {others}")
    forms = [k for k in ("iso", "aniso") if k in fx]
    axes = [k for k in ("x", "y", "z") if k in fx]
    if len(forms) + bool(axes) != 1:
        raise ValueError(
            "fix npt needs exactly one pressure form: iso, aniso, or per-axis "
            f"x/y/z (got {forms + axes})")
    engine = cfg.get("engine", "nlist")
    if engine not in ("nlist", "cellpair"):
        raise NotImplementedError(
            f"fix npt on engine {engine!r} (the slab barostat) is not "
            "ported: ROADMAP queue 1 item 16")


def _check_deck(cfg: dict):
    for key in cfg:
        if key not in _KEYS:
            where = _UNPORTED_KEYS.get(key, "queue 1")
            raise NotImplementedError(
                f"deck key {key!r} is not ported: ROADMAP {where}")
    npt = [fx for fx in cfg.get("fixes", []) if fx.get("name") == "npt"]
    engine = cfg.get("engine", "nlist")
    if not npt and engine != "cellpair":
        raise NotImplementedError(
            f"engine {engine!r} is not ported without fix npt: ROADMAP queue "
            "1 item 11 (the nlist Simulation) / item 16 (slab); set engine: "
            "cellpair")
    for fx in cfg.get("fixes", [{"name": "nve"}]):
        fn = fx.get("name")
        if fn in _UNPORTED_FIXES:
            raise NotImplementedError(
                f"fix {fn} is not ported: ROADMAP queue 1 "
                f"{_UNPORTED_FIXES[fn]}")
        if fn == "npt" and set(fx) & _NPT_TILT_KEYS:
            raise NotImplementedError(
                f"fix npt {sorted(set(fx) & _NPT_TILT_KEYS)} (a triclinic "
                "barostat) is not ported: ROADMAP queue 1 item 14")
        if fn == "shake" and set(fx) - _FIX_KEYS[fn]:
            raise NotImplementedError(
                f"fix shake keys {sorted(set(fx) - _FIX_KEYS[fn])} are not "
                "ported: ROADMAP queue 1 item 12's constraint port (K13) "
                "reads m, b, a, iters and tol")
        if fn not in _FIX_KEYS or set(fx) - _FIX_KEYS[fn]:
            raise NotImplementedError(
                f"fix {fx!r} is not ported: nve, nvt (t_start, t_stop, "
                "t_damp, tchain), shake (m, b, a, iters, tol) and npt "
                "(t_start, t_stop, t_damp, tchain, iso / aniso / x, y, z, "
                "mtk, pchain) only (ROADMAP queue 1)")
        if fn == "npt":
            _check_npt(cfg, fx)
    if "lattice" not in cfg and "read_data" not in cfg:
        raise ValueError("deck needs read_data or lattice")
    name = cfg["pair_style"]["name"]
    if name not in ("buck", "buck/coul/long", "lj/charmm/coul/long"):
        raise NotImplementedError(
            f"pair_style {name!r} is not ported: buck, buck/coul/long and "
            "lj/charmm/coul/long only (ROADMAP queue 1 item 10 coul/cut, "
            "item 13 lj/cut and */long dispersion)")
    ks = cfg.get("kspace_style")
    if (ks is None) != (name == "buck"):
        raise NotImplementedError(
            f"pair_style {name!r} with kspace_style {ks!r} is not ported: "
            "buck runs without k-space, the coul/long styles with pppm")
    for kind, ok in _BONDED_STYLES.items():
        style = cfg.get(f"{kind}_style", {}).get("name")
        if style is not None and style not in ok:
            raise NotImplementedError(
                f"{kind}_style {style!r}: only {sorted(ok)} implemented")
    if ks is not None:
        extra = set(ks) - _KSPACE_KEYS
        if ks["name"] != "pppm":
            where = _KSPACE_UNPORTED.get(ks["name"], "queue 1")
            raise NotImplementedError(
                f"kspace_style {ks['name']!r} is not ported: ROADMAP queue 1 "
                f"{where}")
        if ks.get("diff", "ik") != "ik":
            raise NotImplementedError(
                f"pppm diff {ks['diff']!r} is not ported: ROADMAP queue 1 "
                f"{_KSPACE_UNPORTED['diff']}")
        if extra:
            where = "; ".join(f"{k}: ROADMAP queue 1 "
                              f"{_KSPACE_UNPORTED.get(k, 'item 10')}"
                              for k in sorted(extra))
            raise NotImplementedError(
                f"kspace_style keys {sorted(extra)} are not ported ({where})")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _geometry(cfg: dict):
    """Atoms of the deck as a dict of host numpy arrays: x, lo, hi, typ,
    q, image, v0 (None where the deck gives no velocities), mass, mol,
    the four term tables (None without topology) and data_coeffs, the
    data file's coefficient sections by kind."""
    from .io import lattice, read_data

    if "read_data" in cfg:
        d = read_data(cfg["read_data"])
        if d.tilt is not None and np.any(d.tilt != 0.0):
            raise NotImplementedError(
                "triclinic data files are not ported: ROADMAP queue 1 "
                "item 14")
        g = dict(x=d.x, lo=d.box_lo, hi=d.box_hi, typ=d.type, q=d.q,
                 image=d.image, v0=d.v if np.abs(d.v).any() else None,
                 mass=d.mass, mol=d.molecule, bonds=d.bonds, angles=d.angles,
                 dihedrals=d.dihedrals, impropers=d.impropers,
                 data_coeffs=dict(bond=d.bond_coeffs, angle=d.angle_coeffs,
                                  dihedral=d.dihedral_coeffs,
                                  improper=d.improper_coeffs,
                                  pair=d.pair_coeffs))
        rep = cfg.get("replicate")
        if rep:
            per_atom = {"type": g["typ"], "q": g["q"], "image": g["image"]}
            if g["v0"] is not None:
                per_atom["v"] = g["v0"]
            (g["x"], g["lo"], g["hi"], pa, g["bonds"], g["angles"],
             g["dihedrals"], g["impropers"], g["mol"]) = lattice.replicate(
                g["x"], g["lo"], g["hi"], tuple(rep), per_atom=per_atom,
                bonds=g["bonds"], angles=g["angles"],
                dihedrals=g["dihedrals"], impropers=g["impropers"],
                molecule=g["mol"])
            g.update(typ=pa["type"], q=pa["q"], image=pa["image"],
                     v0=pa.get("v"))
        return g
    if "replicate" in cfg:
        raise NotImplementedError(
            "replicate without read_data is not ported (the JAX package "
            "ignores it on lattice decks)")
    lc = cfg["lattice"]
    x, lo, hi = lattice.create_atoms(
        lc.get("style", "fcc"), lc["density"], lc["nx"], lc["ny"], lc["nz"])
    n = len(x)
    return dict(x=x, lo=lo, hi=hi, typ=np.zeros(n, np.int32), q=np.zeros(n),
                image=np.zeros((n, 3), np.int32), v0=None,
                mass=np.asarray(cfg.get("mass", [1.0]), np.float64),
                mol=None, bonds=None, angles=None, dihedrals=None,
                impropers=None, data_coeffs={})


def _special_factors(cfg: dict):
    """(special_lj, special_coul) 4-tuples from ``special_bonds``: a named
    set (charmm, amber), a list of three weights (with an optional
    ``special_bonds_coul`` list), or the keyword form {lj/coul | lj, coul}
    where an unnamed channel keeps the LAMMPS default 0 0 0."""
    sb = cfg.get("special_bonds", [1.0, 1.0, 1.0])
    if isinstance(sb, str):
        if sb not in _SPECIAL_SETS:
            raise ValueError(f"unknown special_bonds set {sb!r}")
        sb, sbc = _SPECIAL_SETS[sb]
    elif isinstance(sb, dict):
        both = sb.get("lj/coul")
        sbc = both if both is not None else sb.get("coul", [0.0, 0.0, 0.0])
        sb = both if both is not None else sb.get("lj", [0.0, 0.0, 0.0])
    else:
        sbc = cfg.get("special_bonds_coul", sb)
    return ((1.0,) + tuple(float(v) for v in sb[:3]),
            (1.0,) + tuple(float(v) for v in sbc[:3]))


def _pair_style(cfg: dict, ntypes: int, data_pair: dict, qqrd2e: float):
    from .models.pair import build_buck, build_lj_charmm

    ps = cfg["pair_style"]
    name = ps["name"]
    special_lj, special_coul = _special_factors(cfg)
    coeffs = {_parse_pair_key(k): tuple(v)
              for k, v in ps.get("coeffs", {}).items()}
    if name.startswith("lj/charmm"):
        # per-type (eps, sigma[, eps14, sigma14]); the deck's over the data
        # file's Pair Coeffs
        lj = {i: c for (i, j), c in coeffs.items() if i == j}
        if not lj and data_pair:
            lj = {t: tuple(c) for t, c in data_pair.items()}
        return build_lj_charmm(
            ntypes, lj, inner=ps["inner"], cut_lj=ps["cut"], coul="long",
            cut_coul=ps.get("cut_coul"), name=name, special_lj=special_lj,
            special_coul=special_coul, qqrd2e=qqrd2e)
    return build_buck(
        ntypes, coeffs, cut_global=ps["cut"],
        coul="long" if name == "buck/coul/long" else "none",
        cut_coul=ps.get("cut_coul"), name=name, special_lj=special_lj,
        special_coul=special_coul, qqrd2e=qqrd2e,
        shift=ps.get("shift", False))


def _coeff_table(cfg: dict, g: dict, kind: str, ncols: int):
    """A bonded kind's coefficient table: the deck's over the data
    file's."""
    deck = cfg.get(f"{kind}_style", {}).get("coeffs")
    if deck:
        return np.asarray(deck, np.float64)
    rows = g["data_coeffs"].get(kind)
    out = np.zeros((max(rows) + 1 if rows else 0, ncols))
    for t, row in (rows or {}).items():
        out[t, :min(ncols, len(row))] = row[:ncols]
    return out


def _angle_ncols(cfg: dict) -> int:
    return 4 if cfg.get("angle_style", {}).get("name") == "charmm" else 2


def _shake(cfg: dict, fx: dict, g: dict):
    """``fix shake``: the constraints and the bond and angle types they
    take out of the bonded terms.  ``m`` constrains every bond type that
    touches an atom whose mass is within 0.1 of a listed value (the
    fix_shake.cpp mass list); ``b`` and ``a`` name types (1-based);
    ``iters`` defaults to 30.  ``tol`` is accepted and, as in the JAX
    package, not read: the solve runs a fixed min(iters, 4) Newton
    iterations."""
    from .integrate.shake import make_shake

    bonds, angles = g["bonds"], g["angles"]
    mass_per_atom = np.asarray(g["mass"], np.float64)[g["typ"]]
    b_types = tuple(t - 1 for t in fx.get("b", []))
    if "m" in fx and bonds is not None and len(bonds):
        mvals = np.atleast_1d(np.asarray(fx["m"], np.float64))
        light = np.any(np.abs(mass_per_atom[:, None] - mvals[None, :]) <= 0.1,
                       axis=1)
        sel = light[bonds[:, 1]] | light[bonds[:, 2]]
        b_types = tuple(sorted(set(int(t) for t in np.unique(bonds[sel, 0]))
                               | set(b_types)))
    if not b_types and "m" not in fx:
        b_types = (0,)
    a_types = tuple(t - 1 for t in fx.get("a", []))
    ac = _coeff_table(cfg, g, "angle", _angle_ncols(cfg))
    if not len(ac):
        ac = np.asarray([[0.0, 109.47]])
    sc = make_shake(
        bonds if bonds is not None else np.zeros((0, 3), np.int32),
        _coeff_table(cfg, g, "bond", 2),
        angles if angles is not None else np.zeros((0, 4), np.int32), ac,
        mass_per_atom, bond_types=b_types, angle_types=a_types,
        iters=fx.get("iters", 30))
    return sc, b_types, a_types


def _bonded(cfg: dict, g: dict, style, qqrd2e: float, shaken=((), ())):
    """The deck's bonded tables (None without a ``*_style`` key, or when
    nothing is left): deck coefficients over the data file's, the 1-4
    terms of dihedral charmm baked from the pair style's eps14/sig14, less
    the bond and angle types ``shaken`` = (bond types, angle types) that
    fix shake constrains."""
    from .models.bonded import bake_charmm_14, make_bonded

    kinds = ("bond", "angle", "dihedral", "improper")
    if not any(cfg.get(f"{k}_style") for k in kinds):
        return None
    angle_style = cfg.get("angle_style", {}).get("name", "harmonic")

    def unshaken(terms, types):
        if terms is None or not len(terms):
            return terms
        return terms[~np.isin(terms[:, 0], types)]

    dc = _coeff_table(cfg, g, "dihedral", 4)
    d14 = None
    dihedrals = g["dihedrals"]
    if (dihedrals is not None and len(dihedrals) and len(dc)
            and style.eps14 is not None):
        d14 = bake_charmm_14(dihedrals, dc, g["typ"], g["q"], style.eps14,
                             style.sig14, qqrd2e)
    bonded = make_bonded(
        bonds=unshaken(g["bonds"], shaken[0]),
        angles=unshaken(g["angles"], shaken[1]),
        bond_coeffs=_coeff_table(cfg, g, "bond", 2),
        angle_coeffs=_coeff_table(cfg, g, "angle", _angle_ncols(cfg)),
        angle_style=angle_style, dihedrals=dihedrals,
        impropers=g["impropers"], dihedral_coeffs=dc,
        improper_coeffs=_coeff_table(cfg, g, "improper", 2), d14=d14)
    return bonded if bonded.has_terms else None


def _patch_aligned_smin(nc, L, skin, order):
    """Per-axis mesh points per cell, the JAX package's rule for its
    spline patches: S >= (order+1)//2 + margin, the margin covering the
    inter-rebin skin drift.  The port keeps the rule so both packages
    solve on the same mesh."""
    smin = []
    for ax in range(3):
        s = (order + 1) // 2 + 2
        while True:
            h = L[ax] / (s * nc[ax])
            m = max(2, int(np.ceil(0.5 * skin / h - 1e-9)))
            if s >= (order + 1) // 2 + m:
                break
            s += 1
        smin.append(s)
    return smin


def _pppm_for_grid(cfg: dict, box, q, style, prec, skin: float):
    """The engine's k-space solver as a function of its cell grid: PPPM
    on a mesh aligned to the grid's coarse (reach-1) cells, with the
    g_ewald the pair style already carries."""
    from .models.kspace import CellPPPM, setup_pppm

    ks, ps = cfg["kspace_style"], cfg["pair_style"]
    order = ks.get("order", 5)

    def make(grid):
        kgrid = grid.coarse()
        nc = np.asarray(kgrid.nc)
        smin = _patch_aligned_smin(nc, np.asarray(box.perp_widths), skin,
                                   order)
        pm = setup_pppm(box, q, cutoff=ps.get("cut_coul", ps["cut"]),
                        accuracy_rel=ks.get("accuracy", 1e-4),
                        qqrd2e=style.qqrd2e, order=order,
                        g_ewald=style.g_ewald, diff=ks.get("diff", "ik"),
                        multiple_of=kgrid.nc,
                        grid_min=tuple(int(s * c) for s, c in zip(smin, nc)),
                        acc_dtype=prec.acc)
        return CellPPPM(pm, grid.n_atoms)

    return make


def _npt_config(fx: dict):
    """fix npt -> (NPTConfig, NVTConfig), the JAX package's parse: iso
    and aniso couple all three axes (iso to their mean pressure), the
    per-axis form barostats the axes it names with one damping."""
    from .integrate import NPTConfig, NVTConfig

    thermostat = NVTConfig(t_start=fx["t_start"],
                           t_stop=fx.get("t_stop", fx["t_start"]),
                           t_damp=fx["t_damp"], tchain=fx.get("tchain", 3))
    common = dict(mtk=fx.get("mtk", True), pchain=fx.get("pchain", 0))
    for form, couple in (("iso", "xyz"), ("aniso", "none")):
        if form in fx:
            pv = fx[form]
            return NPTConfig(p_start=(pv[0],) * 3, p_stop=(pv[1],) * 3,
                             p_damp=pv[2], flags=(True, True, True),
                             couple=couple, **common), thermostat
    flags, p0, p1, damp = [False] * 3, [0.0] * 3, [0.0] * 3, None
    for a, ax in enumerate("xyz"):
        if ax in fx:
            flags[a] = True
            p0[a], p1[a], damp = fx[ax]
    return NPTConfig(p_start=tuple(p0), p_stop=tuple(p1), p_damp=damp,
                     flags=tuple(flags), couple="none", **common), thermostat


def _npt_traced_kspace(cfg: dict, box, q, style, prec):
    """The deck's PPPM in its variable-cell form: ``setup_pppm`` at the
    deck's box (the generic mesh, not a cell-aligned one, as the JAX
    package's NPT branch builds it) wrapped in ``TracedPPPM``."""
    from .models.kspace import setup_pppm
    from .models.kspace.pppm_npt import make_traced_kspace

    ks, ps = cfg["kspace_style"], cfg["pair_style"]
    pm = setup_pppm(box, q, cutoff=ps.get("cut_coul", ps["cut"]),
                    accuracy_rel=ks.get("accuracy", 1e-4),
                    qqrd2e=style.qqrd2e, order=ks.get("order", 5),
                    g_ewald=style.g_ewald, diff=ks.get("diff", "ik"),
                    acc_dtype=prec.acc)
    center = np.asarray(box.lo, np.float64) + 0.5 * np.asarray(box.lengths)
    return make_traced_kspace(pm, center)


def build_simulation(cfg: dict, device="cuda"):
    """Construct the deck's engine on ``device``: an NPTSimulation for fix
    npt, else a CellPairSimulation."""
    from .core import (build_topology, get_precision, get_units, make_box,
                       make_system)
    from .integrate import CellPairSimulation, NeighborPolicy, NVTConfig
    from .io import velocity
    from .models.kspace import pppm_g_ewald

    dev = _device(device)
    _check_deck(cfg)
    u = get_units(cfg.get("units", "lj"))
    prec = get_precision(cfg.get("precision", "single"))
    dt = cfg.get("timestep", u.dt)

    g = _geometry(cfg)
    x, typ, q, mass, v0 = g["x"], g["typ"], g["q"], g["mass"], g["v0"]
    n = len(x)
    vel = cfg.get("velocity")
    if vel:
        v0 = velocity.create(
            n, vel["temp"], vel.get("seed", 12345), mass[typ], u,
            dist=vel.get("dist", "gaussian"), rng=vel.get("rng", "numpy"),
            loop=vel.get("loop", "all"), coords=x)

    box = make_box(g["lo"], g["hi"])
    bonds = g["bonds"]
    topo = (build_topology(n, bonds=bonds, angles=g["angles"],
                           dihedrals=g["dihedrals"],
                           impropers=g["impropers"])
            if bonds is not None and len(bonds) else None)
    ps = cfg["pair_style"]
    style = _pair_style(cfg, len(mass), g["data_coeffs"].get("pair"),
                        u.qqrd2e)
    ks = cfg.get("kspace_style")
    if ks is not None:
        gew = ks.get("gewald")
        if gew is None:
            gew = pppm_g_ewald(box, q, ps.get("cut_coul", ps["cut"]),
                               ks.get("accuracy", 1e-4), u.qqrd2e)
        style = style.replace(g_ewald=float(gew))
    thermostat = shake = npt_fix = None
    shaken = ((), ())
    for fx in cfg.get("fixes", [{"name": "nve"}]):
        if fx["name"] == "nvt":
            thermostat = NVTConfig(
                t_start=fx["t_start"], t_stop=fx.get("t_stop", fx["t_start"]),
                t_damp=fx["t_damp"], tchain=fx.get("tchain", 3))
        elif fx["name"] == "npt":
            npt_fix, thermostat = _npt_config(fx)
        elif fx["name"] == "shake":
            shake, *shaken = _shake(cfg, fx, g)
    # the special-bond table above keeps the full topology; the bonded
    # terms lose the constrained types
    bonded = _bonded(cfg, g, style, u.qqrd2e, shaken)

    nb = cfg.get("neighbor", {})
    policy = NeighborPolicy(
        skin=nb.get("skin", u.skin), every=nb.get("every", 1),
        delay=nb.get("delay", 0), check=nb.get("check", True))
    system = make_system(x, box, type=typ, v=v0, q=q, image=g["image"],
                         mass=mass, molecule=g["mol"], dtype=prec.flt,
                         device=dev)
    if npt_fix is not None:
        # the NPT branch comes before the engine choice, as in the JAX
        # package: the neighbor-list engine with the variable-cell PPPM
        from .integrate import NPTSimulation

        kspace = (None if ks is None
                  else _npt_traced_kspace(cfg, box, q, style, prec))
        return NPTSimulation(
            system, style, npt_fix, thermostat, kspace=kspace, bonded=bonded,
            units=u, precision=prec, dt=dt, neighbor=policy, shake=shake,
            topology=topo)
    kspace = (None if ks is None
              else _pppm_for_grid(cfg, box, q, style, prec, policy.skin))
    try:
        return CellPairSimulation(
            system, style, units=u, precision=prec, dt=dt, neighbor=policy,
            cap=int(cfg["cap"]) if cfg.get("cap") else None, kspace=kspace,
            topology=topo, bonded=bonded, thermostat=thermostat,
            shake=shake)
    except ValueError as e:
        if "box too small" not in str(e):
            raise
        raise NotImplementedError(str(e)) from e


def run_deck(cfg: dict, device="cuda", log: bool = True):
    """Build and run a deck; returns (sim, thermo_rows)."""
    sim = build_simulation(cfg, device=device)
    nsteps = int(cfg.get("run", 0))
    thermo = int(cfg.get("thermo", max(nsteps // 10, 1)))
    t0 = time.perf_counter()
    rows = sim.run(nsteps, thermo_every=thermo, log=log)
    wall = time.perf_counter() - t0
    if log:
        print(f"# {nsteps} steps, {sim.n_atoms} atoms: {wall:.2f}s "
              f"-> {sim.n_atoms * nsteps / wall:,.0f} atom-steps/s")
    return sim, rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="lammps_buck_intel_tpu_torch deck runner")
    ap.add_argument("deck", help="YAML deck file")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "versions of the kernels)")
    ap.add_argument("--steps", type=int, help="override run length")
    args = ap.parse_args(argv)
    if not args.deck.endswith((".yaml", ".yml")):
        raise NotImplementedError(
            "literal LAMMPS input scripts are not ported: ROADMAP queue 1 "
            "item 15 (io/lammps_input.py)")
    import yaml

    with open(args.deck) as f:
        cfg = yaml.safe_load(f)
    if args.steps is not None:
        cfg["run"] = args.steps
    dev = _device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# deck: {args.deck} on {name}")
    run_deck(cfg, device=dev)


if __name__ == "__main__":
    main()
