"""Spans on the closures the 1D-chain provider hands the energy engine:
each call of them timed between two synchronisations (the surface
decimations of kernel B, t g t+ and the embedding)."""

_P = "gaunegf_tpu_torch.models.chain1d:Chain1DSelfEnergy."
NAMES = ["sigma_chain.total_apply", "sigma_chain.contact_apply",
         "sigma_chain.contacts_warm_apply"]
SPANS = [{"name": n, "target": _P + n.split(".")[1], "group": "sigma",
          "returns_callable": True} for n in NAMES]


def seconds(run):
    return sum(run.spans.seconds[n] for n in NAMES)


def calls(run):
    return sum(run.spans.calls[n] for n in NAMES)
