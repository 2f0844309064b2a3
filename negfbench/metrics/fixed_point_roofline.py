"""fixed_point_roofline: kernel A's (csrc/fixed_point.cu) share of its
FP64 roofline over the profiled stretch: the operations its launches'
sweeps needed (roofline.fixed_point_ops, from the per-lane sweep counts
each launch returns) at 67 TFLOP/s, over the device time of its kernel
in the trace."""

from negfbench import roofline


def _launch(a, k, out):
    bulk = k.get("bulk", a[6] if len(a) > 6 else "jacobi")
    exclusion = k.get("exclusion", a[7] if len(a) > 7 else True)
    surface = k.get("surface", a[8] if len(a) > 8 else False)
    return out[2], bulk, exclusion, surface


SPANS = [{"name": "kernel.fixed_point",
          "target": "gaunegf_tpu_torch.ops.kernels.fixed_point:fixed_point",
          "record": _launch}]


def read(run):
    launches = [v for phase, v in run.spans.records["kernel.fixed_point"]
                if phase == "stretch"]
    device_s = run.profile.kernel_seconds("fixed_point") if run.profile \
        else 0.0
    if not launches or device_s <= 0:
        return None
    ops = sum(roofline.fixed_point_ops(c.cpu().tolist(), bulk, exc, surf)
              for c, bulk, exc, surf in launches)
    return 100.0 * ops / roofline.PEAK_OPS / device_s
