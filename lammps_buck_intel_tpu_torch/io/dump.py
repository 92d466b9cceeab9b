"""Trajectory dumps: lammpstrj, ``dump custom`` with per-atom computes,
xyz and image.

Counterpart of ``lammps_buck_intel_tpu.io.dump`` (``_box_bounds_lines``,
``write_lammpstrj``, ``write_xyz``, ``write_image``, ``read_lammpstrj``,
``write_custom``), in the JAX package's text format: the same ITEM lines,
``%.8g`` per value, box bounds in ``%.16e``.  The rows are formatted by
numpy (``np.savetxt``) rather than a Python loop over atoms.  Orthogonal
boxes only (the port has no tilted box: ROADMAP queue 1 item 14).  The
JAX package's native writer (``native/libfastdata.so``) is not ported
(ROADMAP queue 1 item 15); numpy writes the same text.

The per-atom computes (``computes``) run on the engine's device; this
module is where their results and the snapshot come to the host.
"""
from __future__ import annotations

import numpy as np


def _atoms_of(sim) -> dict:
    """The engine's atom-order snapshot as host numpy arrays: x, v, f (N,
    3), typ (N,), q (N,)."""
    at = sim.atoms_on_device()
    out = {k: at[k].t().cpu().numpy() for k in ("x", "v", "f")}
    out["typ"] = at["typ"].cpu().numpy()
    out["q"] = at["q"].cpu().numpy()
    return out


def _box_bounds_lines(box):
    """(header, 3 bound lines) in the lammpstrj convention."""
    if box.is_triclinic:
        raise NotImplementedError(
            "dumps of a tilted box are not ported: ROADMAP queue 1 item 14")
    lo = np.asarray(box.lo, np.float64)
    hi = np.asarray(box.hi, np.float64)
    return ("ITEM: BOX BOUNDS pp pp pp\n",
            [f"{lo[ax]:.16e} {hi[ax]:.16e}\n" for ax in range(3)])


def _write_frame(path: str, sim, names, cols, fmt, append: bool):
    """One lammpstrj frame: the header of the engine's current step and box,
    then the (N, ncol) rows of ``cols`` in ``fmt``."""
    header, bound_lines = _box_bounds_lines(sim.box)
    with open(path, "a" if append else "w") as f:
        f.write("ITEM: TIMESTEP\n")
        f.write(f"{sim.step_count}\n")
        f.write("ITEM: NUMBER OF ATOMS\n")
        f.write(f"{cols.shape[0]}\n")
        f.write(header)
        for ln in bound_lines:
            f.write(ln)
        f.write("ITEM: ATOMS " + " ".join(names) + "\n")
        np.savetxt(f, cols, fmt=fmt)


def write_lammpstrj(path: str, sim, append: bool = True) -> None:
    """``dump atom``-style frame: id type x y z vx vy vz."""
    a = _atoms_of(sim)
    n = len(a["x"])
    cols = np.column_stack([np.arange(1, n + 1), a["typ"] + 1, a["x"],
                            a["v"]]).astype(np.float64)
    _write_frame(path, sim, ("id", "type", "x", "y", "z", "vx", "vy", "vz"),
                 cols, ["%d", "%d"] + ["%.8g"] * 6, append)


def write_xyz(path: str, sim, append: bool = True, symbols=None) -> None:
    """Minimal xyz: the atom count, ``step N``, then ``symbol x y z`` (T1,
    T2, ... without ``symbols``)."""
    a = _atoms_of(sim)
    typ = a["typ"]
    n = len(typ)
    names = (np.asarray(symbols, dtype=object) if symbols
             else np.array([f"T{t + 1}" for t in range(int(typ.max()) + 1)],
                           dtype=object))
    rows = np.column_stack([names[typ], a["x"].astype(np.float64)])
    with open(path, "a" if append else "w") as f:
        f.write(f"{n}\n")
        f.write(f"step {sim.step_count}\n")
        np.savetxt(f, rows, fmt=["%s", "%.8g", "%.8g", "%.8g"])


_TYPE_COLORS = np.array([
    [220, 60, 60], [60, 120, 220], [60, 200, 90], [230, 200, 60],
    [200, 90, 220], [90, 210, 210], [230, 140, 60], [160, 160, 160],
], np.int32)


def write_image(path: str, sim, size: int = 512, view: str = "xy",
                radius_frac: float = 0.01) -> None:
    """``dump image`` analog (in.spce:39): an orthographic depth-sorted
    sphere render of the frame to a binary PPM, atoms coloured by type and
    shaded toward the disc centre and by depth (the JAX package's
    painter's loop, far to near)."""
    a = _atoms_of(sim)
    x, typ = a["x"], a["typ"]
    lo = np.asarray(sim.box.lo, np.float64)
    hi = np.asarray(sim.box.hi, np.float64)
    L = hi - lo
    ax_u, ax_v = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}[view]
    ax_w = 3 - ax_u - ax_v
    xw = lo + np.mod(x - lo, L)          # wrapped view
    u = (xw[:, ax_u] - lo[ax_u]) / L[ax_u]
    v = (xw[:, ax_v] - lo[ax_v]) / L[ax_v]
    w = (xw[:, ax_w] - lo[ax_w]) / L[ax_w]
    order = np.argsort(w)                 # far -> near painter's sort
    img = np.zeros((size, size, 3), np.uint8)
    r_px = max(1, int(radius_frac * size))
    yy, xx = np.mgrid[-r_px:r_px + 1, -r_px:r_px + 1]
    disc = xx * xx + yy * yy <= r_px * r_px
    shade = np.clip(1.0 - 0.5 * (xx * xx + yy * yy)
                    / max(r_px * r_px, 1), 0.4, 1.0)
    for i in order:
        cu = int(u[i] * (size - 1))
        cv = int((1.0 - v[i]) * (size - 1))
        col = _TYPE_COLORS[int(typ[i]) % len(_TYPE_COLORS)]
        depth = 0.6 + 0.4 * w[i]          # nearer = brighter
        u0, u1 = max(cu - r_px, 0), min(cu + r_px + 1, size)
        v0, v1 = max(cv - r_px, 0), min(cv + r_px + 1, size)
        du0, dv0 = u0 - (cu - r_px), v0 - (cv - r_px)
        d = disc[dv0:dv0 + (v1 - v0), du0:du0 + (u1 - u0)]
        s = shade[dv0:dv0 + (v1 - v0), du0:du0 + (u1 - u0)]
        tile = img[v0:v1, u0:u1]
        px = np.clip(col[None, None, :] * (s * depth)[..., None],
                     0, 255).astype(np.uint8)
        tile[d] = px[d]
    with open(path, "wb") as f:
        f.write(f"P6\n{size} {size}\n255\n".encode())
        f.write(img.tobytes())


def read_lammpstrj(path: str) -> list:
    """The frames of a lammpstrj file: dicts of step, lo, hi (3,), cols
    (the ATOMS item's names) and data (N, ncol) float64."""
    frames = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if not lines[i].startswith("ITEM: TIMESTEP"):
            raise ValueError(f"{path}:{i + 1}: expected ITEM: TIMESTEP")
        step = int(lines[i + 1])
        n = int(lines[i + 3])
        bounds = np.array([lines[i + 5 + ax].split()[:2] for ax in range(3)],
                          np.float64)
        cols = lines[i + 8].split()[2:]
        data = np.array(" ".join(lines[i + 9:i + 9 + n]).split(),
                        np.float64).reshape(n, len(cols))
        frames.append(dict(step=step, lo=bounds[:, 0], hi=bounds[:, 1],
                           cols=cols, data=data))
        i += 9 + n
    return frames


STRESS_COLS = ("c_stress[1]", "c_stress[2]", "c_stress[3]",
               "c_stress[4]", "c_stress[5]", "c_stress[6]")
CUSTOM_COLUMNS = ("id", "type", "x", "y", "z", "vx", "vy", "vz", "fx", "fy",
                  "fz", "q", "c_pe") + STRESS_COLS


def write_custom(path: str, sim, columns, append: bool = True, scope=None,
                 scopes=None) -> None:
    """``dump custom``: the named per-atom columns in lammpstrj framing.
    Columns: ``CUSTOM_COLUMNS`` (c_pe is compute pe/atom, c_stress[1..6]
    compute stress/atom).  ``scope`` is one compute keyword list for every
    per-atom compute, ``scopes`` one per compute ({"pe": [...], "stress":
    [...]}); the two computes share the frame's pair and k-space passes."""
    from .. import computes

    bad = [c for c in columns if c not in CUSTOM_COLUMNS]
    if bad:
        raise NotImplementedError(
            f"dump custom columns {bad}: {list(CUSTOM_COLUMNS)} only")
    scopes = scopes or {}
    sc_pe = scopes.get("pe", scope)
    sc_stress = scopes.get("stress", scope)
    at = sim.atoms_on_device()
    frame_cache = {"atoms": at}   # the computes read this snapshot too
    n = at["x"].shape[1]
    host = {}

    def col(name):
        if name == "id":
            return np.arange(1, n + 1, dtype=np.float64)
        if name == "type":
            return at["typ"].cpu().numpy().astype(np.float64) + 1
        if name in ("x", "y", "z", "vx", "vy", "vz", "fx", "fy", "fz"):
            key = "x" if len(name) == 1 else name[0]
            if key not in host:
                host[key] = at[key].cpu().numpy().astype(np.float64)
            return host[key]["xyz".index(name[-1])]
        if name == "q":
            return at["q"].cpu().numpy().astype(np.float64)
        if name == "c_pe":
            if "pe" not in host:
                host["pe"] = computes.evaluate(
                    sim, "pe/atom", sc_pe, cache=frame_cache).cpu().numpy()
            return host["pe"]
        if "stress" not in host:
            host["stress"] = computes.evaluate(
                sim, "stress/atom", sc_stress,
                cache=frame_cache).cpu().numpy()
        return host["stress"][:, STRESS_COLS.index(name)]

    cols = np.column_stack([col(c) for c in columns])
    _write_frame(path, sim, columns, cols, "%.8g", append)
