"""strip_elim_roofline: kernel 1's (csrc/strip_elim.cu) share of its
roofline over the profiled stretch: the least time its launches need,
from each launch's shape and available lanes (roofline.strip_bound),
over the device time of its kernels in the trace."""

from negfbench import roofline

SPANS = [{"name": "lu.eliminate_strip",
          "target": "gaunegf_tpu_torch.ops.zlinalg:eliminate_strip",
          "record": lambda a, k, out: (a[1], tuple(a[0].shape))}]


def read(run):
    launches = [v for phase, v in run.spans.records["lu.eliminate_strip"]
                if phase == "stretch"]
    device_s = run.profile.kernel_seconds("strip_elim") if run.profile \
        else 0.0
    if not launches or device_s <= 0:
        return None
    ms = sum(roofline.strip_bound(avail.sum(1).tolist(), shape[1],
                                  shape[2])[0]
             for avail, shape in launches)
    return 100.0 * ms / 1e3 / device_s
