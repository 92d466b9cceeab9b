"""Precision policy: the (flt, acc) dtype pair every kernel is built for.

``flt`` is the per-pair compute and state dtype, ``acc`` the accumulation
dtype for forces, energies and virials.  The three modes match the
reference's ``template<flt_t, acc_t>`` instantiations: single
(float, float), mixed (float, double) and double (double, double).  The
H100 has native f64, so ``mixed`` is literal f32 compute with f64
accumulation; the JAX package's two-float ``compensated`` planes exist
only for f32-only hardware and are not carried over.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    flt: torch.dtype  # pair compute and slot-plane dtype
    acc: torch.dtype  # force / energy / virial accumulation dtype


def single() -> Precision:
    return Precision("single", torch.float32, torch.float32)


def mixed() -> Precision:
    return Precision("mixed", torch.float32, torch.float64)


def double() -> Precision:
    return Precision("double", torch.float64, torch.float64)


def single_comp() -> Precision:
    raise NotImplementedError(
        "precision 'single_comp' (two-float compensated integration) is not "
        "ported: ROADMAP queue 1, 'compensated' note")


def get_precision(name: str) -> Precision:
    try:
        make = {"single": single, "mixed": mixed, "double": double,
                "single_comp": single_comp}[name]
    except KeyError:
        raise ValueError(f"unknown precision mode {name!r}") from None
    return make()
