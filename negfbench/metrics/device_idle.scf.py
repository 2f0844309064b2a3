"""device_idle.scf: per cent of the profiled stretch of SCF cycles in
which no operation ran on the device."""

SPANS = []


def read(run):
    if run.job.unit != "cycle" or run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)
