"""Deck runner for the PyTorch port.

Counterpart of ``lammps_buck_intel_tpu.run`` for the decks this port
runs, under ``fix nve`` or ``fix nvt``, with or without ``fix shake`` (a
fix list without nve or nvt integrates as NVE), on the JAX package's
engines: ``engine: cellpair`` builds the cell engine
(``integrate.CellPairSimulation``) with PPPM on a mesh aligned to its
cells; ``engine: nlist``, the default when the deck names no engine,
builds the neighbor-list engine (``integrate.Simulation``) with PPPM on
the generic mesh ``setup_pppm`` gives for the deck's box, and so does a
cell-engine deck whose box holds fewer than 3 cells on an axis.  Whatever
``engine`` says (the JAX package's NPT branch comes before the engine
choice), ``fix npt`` (iso, aniso or per-axis x/y/z, mtk, pchain, tchain;
with or without ``fix shake``) runs on the neighbor-list NPT engine
(``integrate.npt.NPTSimulation``) with the variable-cell PPPM
(``pppm_npt.TracedPPPM``) on the generic mesh of the deck's box, or the
variable-cell Ewald sum (``Ewald.compute_traced``).  Atoms: a
lattice built with ``create_atoms`` or atoms read with ``read_data`` (atom
style charge or full, optionally ``replicate``d); ``pair_style buck``,
``buck/coul/cut``, ``lj/cut``, ``lj/cut/coul/cut`` or
``lj/charmm/coul/cut`` without k-space, or ``buck/coul/long`` /
``lj/cut/coul/long`` / ``lj/charmm/coul/long`` with ``kspace_style
pppm`` (``diff`` ik or ad; ``slab``, kspace_modify slab, which the cell
engine runs as the generic z-extended PPPM on its slot positions; ``grid``,
kspace_modify mesh, on the neighbor-list engine: the cell engine sizes its
own mesh) or ``kspace_style ewald`` (``models.kspace.ewald``; the cell
engine runs it on its slot positions); ``lj/long/coul/long`` (``coul: off``
or coul long) and ``buck/long/coul/long`` with ``kspace_style pppm/disp``
(ik; ``mix`` geometric, arithmetic or none), built as the JAX package
builds it: a Coulomb ``PPPM`` on the generic mesh when the style has
long-range Coulomb, beside a dispersion ``PPPMDisp`` bound to the atoms
(``BoundKSpace``), summed by ``CombinedKSpace``; the cell engine with
geometric mixing and no long-range Coulomb runs
``models.kspace.CellPPPMDisp`` on a dispersion mesh aligned to its cells
instead, every other pppm/disp deck the generic solvers (the cell engine
on its slot positions); ``fix rigid/small`` (quaternion rigid bodies, one
per molecule, on the cell engine) and ``exclude_intra``;
``special_bonds``, harmonic bonds, harmonic or CHARMM angles, CHARMM
dihedrals and harmonic impropers (examples/decks/buck.yaml,
buck_small.yaml, buck_big.yaml, cristobalite_pppm.yaml,
cristobalite_pppm_nlist.yaml, cristobalite_pppm_ad.yaml,
cristobalite_pppm_ad_nlist.yaml, cristobalite_slab.yaml,
cristobalite_ewald.yaml, cristobalite_ewald_cell.yaml,
cristobalite_ewald_npt.yaml, rhodo_npt_ad.yaml,
cristobalite_coul_cut.yaml, cristobalite_buck_long.yaml,
cristobalite_buck_long_nlist.yaml, rhodo_nve.yaml, rhodo_nve_nlist.yaml,
rhodo_32k.yaml, rhodo_class.yaml, rhodo_flex_nve.yaml,
rhodo_flex_nvt.yaml, rhodo_npt.yaml, hexane_gen.yaml,
hexane_gen_arith.yaml, hexane_gen_big.yaml, and the dump decks
cristobalite_pppm_dump.yaml, cristobalite_ewald_dump.yaml,
rhodo_nve_dump.yaml, cristobalite_buck_long_dump.yaml,
hexane_gen_dump.yaml, hexane_gen_arith_dump.yaml).  A ``dump`` block
writes frames every ``every`` steps from step 0 (``run_deck``): ``style``
lammpstrj, xyz, image or custom, whose ``columns`` may name the per-atom
computes c_pe (compute pe/atom) and c_stress[1..6] (compute stress/atom),
with their keyword ``scope`` or per-compute ``scopes`` (``computes``,
``io.dump``), on every k-space solver, pppm/disp's included.
Every other deck key or value raises NotImplementedError naming its
ROADMAP item; nothing is ignored.  A
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

from .utils import trace

# deck key -> where its port stands in ROADMAP queue 1
_UNPORTED_KEYS = {
    "delete_atoms": "item 15",
    "regions": "item 15",
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
         "exclude_intra", "dump",
         "special_bonds_coul", "bond_style", "angle_style", "dihedral_style",
         "improper_style"}
# fix name -> (keys the port reads, ROADMAP item of an unported fix)
_FIX_KEYS = {"nve": {"name"},
             "nvt": {"name", "t_start", "t_stop", "t_damp", "tchain"},
             "shake": {"name", "m", "b", "a", "iters", "tol"},
             "npt": {"name", "t_start", "t_stop", "t_damp", "tchain", "iso",
                     "aniso", "x", "y", "z", "mtk", "pchain"},
             "rigid/small": {"name"}}
_UNPORTED_FIXES = {
    "rigid/npt/small": "item 13(c) (rigid bodies under the barostat, K15 "
                       "with K16d)",
}
# engine -> where its port stands in ROADMAP queue 1 (nlist and cellpair
# run)
_UNPORTED_ENGINES = {"slab": "item 16 (the multi-device slab engine)"}
# fix npt keywords of a tilted (triclinic) barostat
_NPT_TILT_KEYS = {"tri", "xy", "xz", "yz"}
# bonded styles whose formula the kernels hard-code
_BONDED_STYLES = {"bond": {"harmonic"}, "angle": {"harmonic", "charmm"},
                  "dihedral": {"charmm"}, "improper": {"harmonic"}}
_SPECIAL_SETS = {"charmm": ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
                 "amber": ([0.0, 0.0, 0.5], [0.0, 0.0, 1.0 / 1.2])}
# kspace_style keys the port reads, by style ("grid" is kspace_modify mesh,
# "slab" kspace_modify slab)
_KSPACE_KEYS = {"pppm": {"name", "accuracy", "order", "diff", "gewald",
                         "slab", "grid"},
                "ewald": {"name", "accuracy", "gewald"},
                "pppm/disp": {"name", "accuracy", "force_disp_real",
                              "order_disp", "order", "mix", "diff"}}
# the dump block: the keys the runner reads, and its styles
_DUMP_KEYS = {"style", "every", "file", "columns", "scope", "scopes", "size",
              "view"}
_DUMP_STYLES = ("lammpstrj", "custom", "xyz", "image")
_PAIR_STYLES = ("buck", "buck/coul/long", "buck/coul/cut",
                "buck/long/coul/long", "lj/charmm/coul/long",
                "lj/charmm/coul/cut", "lj/cut", "lj/cut/coul/long",
                "lj/cut/coul/cut", "lj/long/coul/long")


def _parse_pair_key(k: str):
    i, j = k.split()
    return (int(i) - 1, int(j) - 1)


def _pair_forms(ps: dict):
    """(coul, disp) of a pair_style entry, the JAX package's reading: coul
    "long" / "cut" / "none" from the name, "none" under ``coul: off``;
    disp "long" for the lj/long and buck/long styles."""
    name = ps["name"]
    coul = ("long" if "coul/long" in name
            else "cut" if "coul/cut" in name else "none")
    if "coul_off" in ps or ps.get("coul") == "off":
        coul = "none"
    disp = "long" if name.startswith(("lj/long", "buck/long")) else "cut"
    return coul, disp


def _disp_mix(cfg: dict) -> str:
    ks, ps = cfg.get("kspace_style") or {}, cfg["pair_style"]
    return ks.get("mix", ps.get("mix", "geometric"))


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


def _check_dump(dmp: dict):
    """The dump block: known keys, a known style, custom's columns and the
    computes' keyword scopes (the JAX runner's reading)."""
    from .computes import _check_scope
    from .io.dump import CUSTOM_COLUMNS

    if not isinstance(dmp, dict) or "file" not in dmp:
        raise ValueError("dump needs a mapping with a file")
    extra = set(dmp) - _DUMP_KEYS
    if extra:
        raise NotImplementedError(
            f"dump keys {sorted(extra)} are not ported: "
            f"{sorted(_DUMP_KEYS)} only")
    style = dmp.get("style", "lammpstrj")
    if style not in _DUMP_STYLES:
        raise NotImplementedError(
            f"dump style {style!r} is not ported: {', '.join(_DUMP_STYLES)}")
    if "every" in dmp and int(dmp["every"]) < 1:
        raise ValueError(f"dump every {dmp['every']!r}: at least 1")
    if style != "custom" and (set(dmp) & {"columns", "scope", "scopes"}):
        raise ValueError(f"dump style {style!r} takes no columns or scopes "
                         "(dump custom does)")
    bad = [c for c in dmp.get("columns", []) if c not in CUSTOM_COLUMNS]
    if bad:
        raise NotImplementedError(
            f"dump custom columns {bad} are not ported: "
            f"{', '.join(CUSTOM_COLUMNS)}")
    scopes = dict(dmp.get("scopes") or {})
    if set(scopes) - {"pe", "stress"}:
        raise ValueError(f"dump scopes {sorted(scopes)}: pe and stress only")
    for sc in [dmp.get("scope")] + list(scopes.values()):
        if sc:
            _check_scope(tuple(sc))


def _check_deck(cfg: dict):
    for key in cfg:
        if key not in _KEYS:
            where = _UNPORTED_KEYS.get(key, "queue 1")
            raise NotImplementedError(
                f"deck key {key!r} is not ported: ROADMAP {where}")
    if "dump" in cfg:
        _check_dump(cfg["dump"])
    engine = cfg.get("engine", "nlist")
    if engine in _UNPORTED_ENGINES:
        raise NotImplementedError(
            f"engine {engine!r} is not ported: ROADMAP queue 1 "
            f"{_UNPORTED_ENGINES[engine]}")
    if engine not in ("nlist", "cellpair"):
        raise ValueError(f"unknown engine {engine!r} (nlist, cellpair)")
    npt = any(fx.get("name") == "npt" for fx in cfg.get("fixes", []))
    rigid = any(fx.get("name") == "rigid/small"
                for fx in cfg.get("fixes", []))
    if cfg.get("cap") and (engine != "cellpair" or npt):
        raise NotImplementedError(
            "deck key 'cap' sizes the cell engine's slots, which this deck "
            "does not run (the neighbor-list engines size their own "
            "capacities): drop cap")
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
    if rigid and npt:
        raise NotImplementedError(
            "fix npt with fix rigid/small (the coupled barostat is fix "
            "rigid/npt/small: ROADMAP queue 1 item 13(c))")
    if (rigid or cfg.get("exclude_intra")) and engine != "cellpair":
        raise NotImplementedError(
            "fix rigid/small and exclude_intra on the neighbor-list engine "
            "are not ported (the port runs them on engine cellpair): ROADMAP "
            "queue 1 item 13(c)")
    if "lattice" not in cfg and "read_data" not in cfg:
        raise ValueError("deck needs read_data or lattice")
    name = cfg["pair_style"]["name"]
    if name not in _PAIR_STYLES:
        raise NotImplementedError(
            f"pair_style {name!r} is not ported: {', '.join(_PAIR_STYLES)} "
            "only (ROADMAP queue 1)")
    coul, disp = _pair_forms(cfg["pair_style"])
    ks = cfg.get("kspace_style")
    kname = None if ks is None else ks["name"]
    want = (("pppm/disp",) if disp == "long"
            else ("pppm", "ewald") if coul == "long" else None)
    if (kname is None) != (want is None) or (
            want is not None and kname not in want):
        where = ("ROADMAP queue 1 item 13 (pppm/disp beside a style "
                 "without long-range dispersion)" if kname == "pppm/disp"
                 else "ROADMAP queue 1")
        raise NotImplementedError(
            f"pair_style {name!r} with kspace_style {kname!r} is not "
            "ported: buck and the lj/cut, coul/cut styles run without "
            "k-space, the coul/long styles with pppm or ewald, lj/long and "
            f"buck/long with pppm/disp ({where})")
    if kname == "pppm/disp":
        if _disp_mix(cfg) not in ("geometric", "arithmetic", "none"):
            raise ValueError(f"unknown pppm/disp mix {_disp_mix(cfg)!r}")
        if _disp_mix(cfg) == "arithmetic" and name.startswith("buck"):
            raise ValueError(
                "pppm/disp mix arithmetic needs the lj styles' epsilon and "
                "sigma; buck/long takes mix none (or geometric)")
        if npt:
            raise NotImplementedError(
                "pppm/disp under fix npt (the dispersion PPPM on a traced "
                "box, K16d) is not ported: ROADMAP queue 1 item 13(c)")
    for kind, ok in _BONDED_STYLES.items():
        style = cfg.get(f"{kind}_style", {}).get("name")
        if style is not None and style not in ok:
            raise NotImplementedError(
                f"{kind}_style {style!r}: only {sorted(ok)} implemented")
    if ks is not None:
        if ks["name"] not in _KSPACE_KEYS:
            raise NotImplementedError(
                f"kspace_style {ks['name']!r} is not ported: ROADMAP queue 1")
        extra = set(ks) - _KSPACE_KEYS[ks["name"]]
        if extra:
            raise NotImplementedError(
                f"kspace_style {ks['name']} keys {sorted(extra)} are not "
                f"ported: {sorted(_KSPACE_KEYS[ks['name']])} only (ROADMAP "
                "queue 1 item 10)")
        if ks.get("diff", "ik") not in ("ik", "ad"):
            raise ValueError(f"unknown pppm diff {ks['diff']!r} (ik, ad)")
        if kname == "pppm/disp" and ks.get("diff", "ik") == "ad":
            raise NotImplementedError(
                "pppm/disp diff ad (the multi-channel ad gather, K10 disp "
                "ad) is not ported: ROADMAP queue 1 item 10, the dispersion "
                "ad, the next slice")
        if (kname == "pppm" and ks.get("grid") and engine == "cellpair"
                and not ks.get("slab") and not npt):
            # the JAX runner rebuilds the cell engine's cell-aligned mesh
            # without the deck's grid (its run.py:921-929), dropping it
            raise NotImplementedError(
                "kspace_modify mesh (grid) on engine cellpair is not ported: "
                "ROADMAP queue 1 item 10 (the cell engine sizes its own "
                "cell-aligned mesh; the JAX runner drops the deck's grid "
                "there, queue 3); run engine nlist")


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
    from .models.pair import build_buck, build_lj, build_lj_charmm

    ps = cfg["pair_style"]
    name = ps["name"]
    coul, disp = _pair_forms(ps)
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
            ntypes, lj, inner=ps["inner"], cut_lj=ps["cut"], coul=coul,
            cut_coul=ps.get("cut_coul"), name=name, special_lj=special_lj,
            special_coul=special_coul, qqrd2e=qqrd2e)
    if name.startswith("lj"):
        # per-type (eps, sigma) on the diagonal, cross terms mixed unless
        # the deck gives them (the JAX package's reading)
        lj = {((i, j) if i != j else i): c for (i, j), c in coeffs.items()}
        return build_lj(
            ntypes, lj, cut_global=ps["cut"], coul=coul, disp=disp,
            cut_coul=ps.get("cut_coul"), mix=ps.get("mix", "geometric"),
            name=name, special_lj=special_lj, special_coul=special_coul,
            qqrd2e=qqrd2e, shift=ps.get("shift", False))
    return build_buck(
        ntypes, coeffs, cut_global=ps["cut"], coul=coul, disp=disp,
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
    ``iters`` defaults to 30.  As in the JAX package the solve runs a
    fixed min(iters, 4) Newton iterations; ``tol`` (default 1e-4) is what
    the ``shake.unconverged`` counter holds the clusters to at each
    thermo row."""
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
        iters=fx.get("iters", 30), tol=fx.get("tol", 1e-4))
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
    g_ewald the pair style already carries, and those cells' bricks for
    the slot deposit (K5 by cell)."""
    from .models.kspace import CellPPPM, setup_pppm
    from .models.kspace.pppm_cells import cell_bricks

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
        return CellPPPM(pm, grid.n_atoms,
                        bricks=cell_bricks(pm, kgrid.nc, skin))

    return make


def _disp_for_grid(cfg: dict, box, typ, B, style, prec, skin: float):
    """The engine's dispersion solver as a function of its cell grid:
    pppm/disp on a mesh aligned to the grid's coarse cells (the JAX
    package's ``use_celldisp`` branch, its run.py :926-944: geometric
    mixing without long-range Coulomb), with the g_ewald_6 the pair style
    already carries and the per-type dispersion charges B, and the cells'
    bricks for the slot deposit (K5 by cell)."""
    from .models.kspace import CellPPPMDisp, setup_pppm_disp
    from .models.kspace.pppm_cells import cell_bricks

    ks, ps = cfg["kspace_style"], cfg["pair_style"]
    order6 = ks.get("order_disp", ks.get("order", 5))

    def make(grid):
        kgrid = grid.coarse()
        nc = np.asarray(kgrid.nc)
        smin = _patch_aligned_smin(nc, np.asarray(box.perp_widths), skin,
                                   order6)
        pmd = setup_pppm_disp(
            box, B, typ, cutoff=ps["cut"], g_ewald_6=style.g_ewald_6,
            acc_dtype=prec.acc, mix="geometric",
            diff=ks.get("diff", "ik"), order=order6, multiple_of=kgrid.nc,
            grid_min=tuple(int(s * c) for s, c in zip(smin, nc)))
        return CellPPPMDisp(pmd, grid.n_atoms, typ,
                            bricks=cell_bricks(pmd, kgrid.nc, skin))

    return make


def _disp_b(cfg: dict, ntypes: int) -> np.ndarray:
    """B per type from the deck's ``i i`` coefficients, the JAX package's
    expressions (its run.py :359-368): sqrt(4 eps) sigma^3 for the lj
    styles, sqrt(C) for buck."""
    ps = cfg["pair_style"]
    coeffs = {_parse_pair_key(k): tuple(v)
              for k, v in ps.get("coeffs", {}).items()}
    if ps["name"].startswith("buck"):
        return np.sqrt(np.array([coeffs[(t, t)][2] for t in range(ntypes)]))
    eps = np.array([coeffs[(t, t)][0] for t in range(ntypes)])
    sig = np.array([coeffs[(t, t)][1] for t in range(ntypes)])
    return np.sqrt(4.0 * eps) * sig**3


def _generic_disp(cfg: dict, box, typ, B, style, prec):
    """The deck's dispersion PPPM on the generic mesh of its box, bound to
    the atoms, as the JAX package's deck runner builds it (its run.py
    :354-391): geometric mixing binds B per atom, arithmetic (the ``i i``
    epsilon and sigma) and none (C6 from the pair tables' e1 column, the
    r^-6 energy coefficient of both families) bind the type ids to the
    channel tables."""
    from .models.kspace import BoundKSpace, setup_pppm_disp

    ks, ps = cfg["kspace_style"], cfg["pair_style"]
    mix = _disp_mix(cfg)
    kw = {}
    if mix == "arithmetic":
        coeffs = {_parse_pair_key(k): tuple(v)
                  for k, v in ps.get("coeffs", {}).items()}
        kw = dict(epsilon=np.array([coeffs[(t, t)][0]
                                    for t in range(len(B))]),
                  sigma=np.array([coeffs[(t, t)][1] for t in range(len(B))]))
    elif mix == "none":
        kw = dict(C6=np.asarray(style.tables)[:, :, 3])
    pmd = setup_pppm_disp(box, B, typ, cutoff=ps["cut"],
                          g_ewald_6=style.g_ewald_6, acc_dtype=prec.acc,
                          mix=mix, diff=ks.get("diff", "ik"),
                          order=ks.get("order_disp", ks.get("order", 5)),
                          **kw)
    if mix == "geometric":
        return BoundKSpace(pmd, np.asarray(B)[typ])
    return BoundKSpace(pmd, typ, typed=True)


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


def _generic_pppm(cfg: dict, box, q, style, prec):
    """The deck's PPPM on the generic mesh of its box (``setup_pppm`` with
    no cell alignment; ``diff``, ``slab`` and the ``grid`` of kspace_modify
    mesh as the deck gives them), as the JAX package's deck runner builds
    it for the neighbor-list engines and for a slab deck on the cell
    engine (its ``run.py:326-352``)."""
    from .models.kspace import setup_pppm

    ks, ps = cfg["kspace_style"], cfg["pair_style"]
    return setup_pppm(box, q, cutoff=ps.get("cut_coul", ps["cut"]),
                      accuracy_rel=ks.get("accuracy", 1e-4),
                      qqrd2e=style.qqrd2e, order=ks.get("order", 5),
                      g_ewald=style.g_ewald, diff=ks.get("diff", "ik"),
                      slab=ks.get("slab"), grid=ks.get("grid"),
                      acc_dtype=prec.acc)


def _npt_traced_kspace(cfg: dict, box, q, style, prec, ewald=None):
    """The deck's k-space solver in its variable-cell form: its PPPM on the
    generic mesh (``_generic_pppm``) wrapped in ``TracedPPPM``, or its
    Ewald sum as it is (``Ewald.compute_traced``), as the JAX runner's
    ``_npt_traced_kspace`` hands them to its NPTSimulation."""
    from .models.kspace.pppm_npt import make_traced_kspace

    ks = ewald if ewald is not None else _generic_pppm(cfg, box, q, style,
                                                       prec)
    center = np.asarray(box.lo, np.float64) + 0.5 * np.asarray(box.lengths)
    return make_traced_kspace(ks, center)


def build_simulation(cfg: dict, device="cuda"):
    """Construct the deck's engine on ``device``: an NPTSimulation for fix
    npt; else a CellPairSimulation for ``engine: cellpair`` unless its box
    is too small for the cells; else a Simulation, whose k-space is the
    deck's PPPM on the generic mesh or its Ewald sum.  The stages are the
    spans ``setup.geometry``, ``setup.velocity``, ``setup.params`` and
    ``setup.engine`` (``utils.trace``); the last ends when the device has
    done the engine's set-up work."""
    from .core import (build_topology, get_precision, get_units, make_box,
                       make_system)
    from .integrate import (CellPairSimulation, NeighborPolicy, NVTConfig,
                            Simulation)
    from .io import velocity
    from .models.kspace import pppm_g_ewald, setup_ewald

    dev = _device(device)
    _check_deck(cfg)
    u = get_units(cfg.get("units", "lj"))
    prec = get_precision(cfg.get("precision", "single"))
    dt = cfg.get("timestep", u.dt)

    with trace.span("setup.geometry"):
        g = _geometry(cfg)
    x, typ, q, mass, v0 = g["x"], g["typ"], g["q"], g["mass"], g["v0"]
    n = len(x)
    vel = cfg.get("velocity")
    if vel:
        with trace.span("setup.velocity"):
            v0 = velocity.create(
                n, vel["temp"], vel.get("seed", 12345), mass[typ], u,
                dist=vel.get("dist", "gaussian"), rng=vel.get("rng", "numpy"),
                loop=vel.get("loop", "all"), coords=x)

    with trace.span("setup.params"):
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
        ewald = B = None
        coul, _ = _pair_forms(ps)
        if ks is not None and ks["name"] == "pppm/disp":
            from .models.kspace import solve_g6

            if coul == "long":
                # the JAX run.py's order: g_ewald of the Coulomb PPPM first,
                # then g_ewald_6 of the dispersion split
                style = style.replace(g_ewald=float(pppm_g_ewald(
                    box, q, ps.get("cut_coul", ps["cut"]),
                    ks.get("accuracy", 1e-4), u.qqrd2e)))
            style = style.replace(g_ewald_6=solve_g6(
                ps["cut"], ks.get("force_disp_real", 1e-4)))
            B = _disp_b(cfg, len(mass))
        elif ks is not None:
            gew = ks.get("gewald")
            if ks["name"] == "ewald":
                # the JAX run.py's order: the k set first, its g_ewald to the
                # pair style
                ewald = setup_ewald(
                    box, q, cutoff=ps.get("cut_coul", ps["cut"]),
                    accuracy_rel=ks.get("accuracy", 1e-4), qqrd2e=u.qqrd2e,
                    g_ewald=gew, acc_dtype=prec.acc)
                gew = ewald.g_ewald
            elif gew is None:
                gew = pppm_g_ewald(box, q, ps.get("cut_coul", ps["cut"]),
                                   ks.get("accuracy", 1e-4), u.qqrd2e,
                                   slab=ks.get("slab"))
            style = style.replace(g_ewald=float(gew))
        thermostat = shake = npt_fix = rigid = None
        exclude_intra = bool(cfg.get("exclude_intra", False))
        shaken = ((), ())
        for fx in cfg.get("fixes", [{"name": "nve"}]):
            if fx["name"] == "nvt":
                thermostat = NVTConfig(
                    t_start=fx["t_start"],
                    t_stop=fx.get("t_stop", fx["t_start"]),
                    t_damp=fx["t_damp"], tchain=fx.get("tchain", 3))
            elif fx["name"] == "npt":
                npt_fix, thermostat = _npt_config(fx)
            elif fx["name"] == "shake":
                shake, *shaken = _shake(cfg, fx, g)
            elif fx["name"] == "rigid/small":
                from .integrate.rigid import make_rigid_bodies

                rigid = make_rigid_bodies(x, g["mol"], mass[typ], box)
        if (rigid is not None or exclude_intra) and g["mol"] is None:
            raise ValueError("fix rigid/small and exclude_intra need molecule "
                             "ids (a data file of atom style full)")
        # the special-bond table above keeps the full topology; the bonded
        # terms lose the constrained types
        bonded = _bonded(cfg, g, style, u.qqrd2e, shaken)

        nb = cfg.get("neighbor", {})
        policy = NeighborPolicy(
            skin=nb.get("skin", u.skin), every=nb.get("every", 1),
            delay=nb.get("delay", 0), check=nb.get("check", True))

    def engine():
        system = make_system(x, box, type=typ, v=v0, q=q, image=g["image"],
                             mass=mass, molecule=g["mol"], dtype=prec.flt,
                             device=dev)
        if npt_fix is not None:
            # the NPT branch comes before the engine choice, as in the JAX
            # package: the neighbor-list engine with the variable-cell PPPM
            from .integrate import NPTSimulation

            kspace = (None if ks is None
                      else _npt_traced_kspace(cfg, box, q, style, prec, ewald))
            return NPTSimulation(
                system, style, npt_fix, thermostat, kspace=kspace,
                bonded=bonded, units=u, precision=prec, dt=dt,
                neighbor=policy, shake=shake, topology=topo)
        generic = None
        if B is not None:
            # pppm/disp: the Coulomb PPPM on the generic mesh (with long-range
            # Coulomb) beside the bound dispersion solver, the JAX package's
            # solvers for the list engine and for the cell engine's slot
            # positions
            generic = _generic_disp(cfg, box, typ, B, style, prec)
            if coul == "long":
                from .models.kspace import CombinedKSpace

                generic = CombinedKSpace(
                    [_generic_pppm(cfg, box, q, style, prec), generic])
        if cfg.get("engine", "nlist") == "cellpair":
            if ks is None:
                kspace = None
            elif B is not None and coul != "long" and _disp_mix(cfg) == \
                    "geometric":
                # the JAX package's use_celldisp: one channel on a mesh aligned
                # to the cells
                kspace = _disp_for_grid(cfg, box, typ, B, style, prec,
                                        policy.skin)
            elif B is not None:
                kspace = lambda grid: generic  # noqa: E731
            elif ewald is not None or ks.get("slab"):
                # the JAX runner's generic solvers on the slot positions: an
                # Ewald sum, or a slab deck's PPPM (its z-extended mesh is not
                # aligned to the cells, JAX run.py:858)
                solver = ewald if ewald is not None else _generic_pppm(
                    cfg, box, q, style, prec)
                kspace = lambda grid: solver  # noqa: E731
            else:
                kspace = _pppm_for_grid(cfg, box, q, style, prec, policy.skin)
            try:
                return CellPairSimulation(
                    system, style, units=u, precision=prec, dt=dt,
                    neighbor=policy,
                    cap=int(cfg["cap"]) if cfg.get("cap") else None,
                    kspace=kspace, topology=topo, bonded=bonded,
                    thermostat=thermostat, shake=shake, rigid=rigid,
                    exclude_intra=exclude_intra)
            except ValueError as e:
                # ONLY the box-too-small geometry falls through to the
                # neighbor-list engine, as in the JAX package; every other
                # error stays loud
                if "box too small" not in str(e):
                    raise
            if cfg.get("cap"):
                raise NotImplementedError(
                    "deck key 'cap' sizes the cell engine's slots; this "
                    "deck's box is too small for the cell engine, and the "
                    "neighbor-list engine sizes its own capacities: drop cap")
            if rigid is not None or exclude_intra:
                raise NotImplementedError(
                    "this deck's box is too small for the cell engine, and "
                    "fix rigid/small and exclude_intra on the neighbor-list "
                    "engine are not ported: ROADMAP queue 1 item 13(c)")
        kspace = ewald if generic is None else generic
        if ks is not None and kspace is None:
            kspace = _generic_pppm(cfg, box, q, style, prec)
        return Simulation(
            system, style, topology=topo, kspace=kspace, bonded=bonded,
            units=u, precision=prec, dt=dt, neighbor=policy,
            thermostat=thermostat, shake=shake)

    with trace.span("setup.engine"):
        sim = engine()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return sim


def _frame_writer(dmp: dict, sim):
    """write(append) of the dump block's style (the JAX run_deck's
    dispatch; ``style: xyz`` writes xyz frames)."""
    from .io import dump as dumpmod

    style = dmp.get("style", "lammpstrj")
    path = dmp["file"]

    def write(append: bool = True):
        if style == "image":
            # one PPM per frame, * -> the step
            dumpmod.write_image(path.replace("*", str(sim.step_count)), sim,
                                size=int(dmp.get("size", 512)),
                                view=dmp.get("view", "xy"))
        elif style == "custom":
            dumpmod.write_custom(
                path, sim, dmp.get("columns", ["id", "type", "x", "y", "z"]),
                append=append, scope=dmp.get("scope"),
                scopes=dmp.get("scopes"))
        elif style == "xyz":
            dumpmod.write_xyz(path, sim, append=append)
        else:
            dumpmod.write_lammpstrj(path, sim, append=append)

    return write


def run_deck(cfg: dict, device="cuda", log: bool = True):
    """Build and run a deck; returns (sim, thermo_rows).  With a ``dump``
    block a frame is written at the first step and after every ``every``
    steps (the run goes in chunks of ``every``); the frames' seconds are
    ``sim.timings["dump"]``, outside ``sim.timings["run"]``."""
    sim = build_simulation(cfg, device=device)
    nsteps = int(cfg.get("run", 0))
    thermo = int(cfg.get("thermo", max(nsteps // 10, 1)))
    dmp = cfg.get("dump")
    t0 = time.perf_counter()
    if dmp:
        every = int(dmp.get("every", thermo))
        write = _frame_writer(dmp, sim)
        sim.timings["dump"] = 0.0
        rows, left, append = [], nsteps, False
        while True:
            tf = time.perf_counter()
            write(append)
            sim.timings["dump"] += time.perf_counter() - tf
            append = True
            if left <= 0:
                break
            chunk = min(every, left)
            rows += sim.run(chunk, thermo_every=thermo, log=log)
            left -= chunk
    else:
        rows = sim.run(nsteps, thermo_every=thermo, log=log)
    wall = time.perf_counter() - t0
    if log:
        print(f"# {nsteps} steps, {sim.n_atoms} atoms: {wall:.2f}s "
              f"-> {sim.n_atoms * nsteps / wall:,.0f} atom-steps/s")
        if dmp:
            print(f"# dump: {sim.timings['dump']:.2f}s of frames "
                  f"({dmp['file']})")
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
