"""device_idle.transport: per cent of the profiled stretch of T(E) sweeps
in which no operation ran on the device."""

SPANS = []


def read(run):
    if run.job.unit != "sweep" or run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)
