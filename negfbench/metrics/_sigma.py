"""Spans on the closures the Bethe provider hands the energy engine: each
call of them timed between two synchronisations (the fixed points of
kernel A, the embedding and B g B+)."""

_P = "gaunegf_tpu_torch.models.bethe:BetheSelfEnergy."
NAMES = ["sigma.total_apply", "sigma.contact_apply",
         "sigma.contacts_warm_apply", "sigma.total_apply_warm"]
SPANS = [{"name": n, "target": _P + n.split(".")[1], "group": "sigma",
          "returns_callable": True} for n in NAMES]


def seconds(run):
    return sum(run.spans.seconds[n] for n in NAMES)


def calls(run):
    return sum(run.spans.calls[n] for n in NAMES)
