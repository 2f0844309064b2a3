"""density_pts_s: energy points a second inside FockToP in the traced
window: the grid points handed to the energy engine's outermost sums
(gr_sum, gless_sum, density_neq_sum, density_eq_split) over the seconds
inside FockToP."""

import numpy as np

_ENGINE = "gaunegf_tpu_torch.ops.greens:EnergyEngine."


def _points(*grids):
    return lambda a, k, out: int(sum(np.size(a[i]) for i in grids))


SPANS = [
    {"name": "scf.FockToP", "target": "gaunegf_tpu_torch.scfe:NEGFE.FockToP"},
    {"name": "engine.gr_sum", "target": _ENGINE + "gr_sum",
     "group": "engine", "record": _points(1)},
    {"name": "engine.gless_sum", "target": _ENGINE + "gless_sum",
     "group": "engine", "record": _points(1)},
    {"name": "engine.density_neq_sum", "target": _ENGINE + "density_neq_sum",
     "group": "engine", "record": _points(1, 3)},
    {"name": "engine.density_eq_split",
     "target": _ENGINE + "density_eq_split", "group": "engine",
     "record": _points(1, 3)},
]


def read(run):
    inside = run.spans.seconds["scf.FockToP"]
    pts = sum(v for name in ("engine.gr_sum", "engine.gless_sum",
                             "engine.density_neq_sum",
                             "engine.density_eq_split")
              for phase, v in run.spans.records[name] if phase == "window")
    if not inside or not pts:
        return None
    return pts / inside
