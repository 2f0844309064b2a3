"""Slater-Koster electrode parameters from Harrison's universal LCAO rules.

The reference ships fitted gold parameter files (``Au.bethe`` /
``Au2.bethe``, parsed at surfGBethe.py:326-355) whose numeric values are
proprietary-fit data this project deliberately does not copy.  This module
is the independently-sourced replacement: it GENERATES .bethe parameter
sets for fcc metals from Harrison's universal tight-binding rules
(W. A. Harrison, "Electronic Structure and the Properties of Solids",
Freeman 1980; Froyen & Harrison, PRB 20, 2420 (1979)):

    V_{ll'm}      = eta_{ll'm} * hbar^2 / (m_e d^2)          (s/p blocks)
    V_{ldm}       = eta_{ldm} * hbar^2 r_d^{3/2} / (m_e d^{7/2})
    V_{ddm}       = eta_{ddm} * hbar^2 r_d^3 / (m_e d^5)

with the universal dimensionless couplings eta (below), the bond length d
(= a/sqrt(2) for fcc nearest neighbours) and the element's d-state radius
r_d.  Harrison's scheme is an ORTHOGONAL tight-binding theory: all overlap
parameters are zero, which exercises the Bethe machinery's ANT-style
de-orthogonalization branch (models/bethe.py ``orthogonal``;
surfGBethe.py:530-533).

The bundled element table gives a usable out-of-the-box gold (and copper /
silver) electrode: lattice constants are textbook room-temperature values;
r_d and the onsite splittings are Harrison-scale values chosen and
DOCUMENTED here so the generated electrode reproduces the qualitative
noble-metal electronic structure (filled ~3-7 eV wide d-band whose top
sits a few eV below the half-filled s-band's Fermi level).  Users fitting
quantitative band structures should pass their own (a, r_d, onsite)
inputs or a fitted .bethe file -- this generator's value is a sane,
reproducible, license-clean default.
"""

from __future__ import annotations

import io
from typing import Dict, Optional

import numpy as np

from gaunegf_tpu_torch.units import HAR_TO_EV

__all__ = ["HARRISON_ETA", "ELEMENTS", "harrison_hoppings",
           "harrison_bethe_dict", "write_bethe", "bethe_params"]

HBAR2_OVER_ME = 7.6199682      # hbar^2/m_e in eV * Angstrom^2

# Universal dimensionless couplings (Harrison 1980, solid-state table).
HARRISON_ETA = {
    "sss": -1.32, "sps": 1.42, "pps": 2.22, "ppp": -0.63,   # ~ 1/d^2
    "sds": -3.16, "pds": -2.95, "pdp": 1.36,                # ~ r_d^1.5/d^3.5
    "dds": -16.2, "ddp": 8.75, "ddd": 0.0,                  # ~ r_d^3/d^5
}

# Element defaults: fcc lattice constant a (Angstrom, room-temperature
# textbook values), Harrison-scale d-state radius r_d (Angstrom), onsite
# energies (eV) and the s+d valence electron count.  The onsite values are
# this framework's documented defaults (see module docstring), placed so
# the generated Bethe DOS shows the noble-metal ordering
# eps_d < eps_s < eps_p with the d-band fully occupied.
# eps_d is tuned (see tests/test_harrison.py) so the Bethe-lattice DOS
# reproduces the photoemission d-band onset below the computed contact
# Fermi level: ~2 eV for Cu and Au, ~4 eV for Ag.
ELEMENTS = {
    "Cu": dict(a=3.615, r_d=0.67, eps_s=-7.7, eps_p=-2.1, eps_d=-15.0,
               ne=11),
    "Ag": dict(a=4.085, r_d=0.89, eps_s=-7.1, eps_p=-1.9, eps_d=-15.0,
               ne=11),
    "Au": dict(a=4.078, r_d=0.95, eps_s=-6.9, eps_p=-1.7, eps_d=-13.0,
               ne=11),
}


def harrison_hoppings(d: float, r_d: float) -> Dict[str, float]:
    """The 10 Slater-Koster hopping integrals (eV) at bond length d (A)."""
    f_sp = HBAR2_OVER_ME / d ** 2
    f_sd = HBAR2_OVER_ME * r_d ** 1.5 / d ** 3.5
    f_dd = HBAR2_OVER_ME * r_d ** 3 / d ** 5
    scale = {"sss": f_sp, "sps": f_sp, "pps": f_sp, "ppp": f_sp,
             "sds": f_sd, "pds": f_sd, "pdp": f_sd,
             "dds": f_dd, "ddp": f_dd, "ddd": f_dd}
    return {k: HARRISON_ETA[k] * scale[k] for k in HARRISON_ETA}


def harrison_bethe_dict(element: Optional[str] = None, *,
                        a: Optional[float] = None,
                        r_d: Optional[float] = None,
                        eps_s: Optional[float] = None,
                        eps_p: Optional[float] = None,
                        eps_d: Optional[float] = None,
                        ne: Optional[int] = None) -> Dict[str, float]:
    """The 25 .bethe keys (energies in HARTREE, matching the file format).

    Start from an ``ELEMENTS`` entry and/or override any input.  Overlaps
    are zero (Harrison's theory is orthogonal)."""
    spec = dict(ELEMENTS.get(element, {})) if element else {}
    for k, v in dict(a=a, r_d=r_d, eps_s=eps_s, eps_p=eps_p, eps_d=eps_d,
                     ne=ne).items():
        if v is not None:
            spec[k] = v
    missing = {"a", "r_d", "eps_s", "eps_p", "eps_d", "ne"} - set(spec)
    if missing:
        raise ValueError(f"missing inputs {sorted(missing)}; pass an "
                         f"element in {sorted(ELEMENTS)} or explicit values")
    d_nn = spec["a"] / np.sqrt(2.0)
    hop = harrison_hoppings(d_nn, spec["r_d"])
    out = {"ne": float(spec["ne"]),
           "es": spec["eps_s"] / HAR_TO_EV,
           "ep": spec["eps_p"] / HAR_TO_EV,
           "edd": spec["eps_d"] / HAR_TO_EV,
           "edt": spec["eps_d"] / HAR_TO_EV}
    for k, v in hop.items():
        out[k] = v / HAR_TO_EV
    for k in hop:
        out["S" + k] = 0.0
    return out


def write_bethe(path: str, element: Optional[str] = None, **overrides):
    """Write a .bethe parameter file generated by harrison_bethe_dict."""
    params = harrison_bethe_dict(element, **overrides)
    buf = io.StringIO()
    buf.write(f"# {element or 'custom'} fcc electrode parameters generated "
              "by gaunegf_tpu_torch.models.harrison\n")
    buf.write("# (Harrison universal LCAO rules; orthogonal set -- zero "
              "overlaps).  Energies in Hartree.\n")
    for k, v in params.items():
        if k == "ne":
            buf.write(f"ne = {int(v)}\n")
        else:
            buf.write(f"{k} = {v:.10f}\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())
    return params


def bethe_params(element: str = "Au", **overrides):
    """BetheParams ready for BetheSelfEnergy(lat_file=...) construction."""
    from gaunegf_tpu_torch.models.slater_koster import bethe_params_from_dict
    return bethe_params_from_dict(harrison_bethe_dict(element, **overrides))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Generate a .bethe electrode parameter file")
    ap.add_argument("element", choices=sorted(ELEMENTS))
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args()
    out = args.out or f"{args.element}.bethe"
    write_bethe(out, args.element)
    print(f"wrote {out}")
