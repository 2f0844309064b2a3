"""scf_host_ms: milliseconds a cycle outside FockToP in the traced window
(PMix, PToFock with the backend's Fock rebuild, the loop's bookkeeping)."""

SPANS = [{"name": "scf.FockToP",
          "target": "gaunegf_tpu_torch.scfe:NEGFE.FockToP"}]


def read(run):
    if run.job.unit != "cycle" or not run.units:
        return None
    inside = run.spans.seconds["scf.FockToP"]
    return (run.window_s - inside) / run.units * 1e3
