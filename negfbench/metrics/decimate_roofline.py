"""decimate_roofline: kernel B's (csrc/sancho_rubio.cu) share of its FP64
roofline over the profiled stretch, in its one-CTA-a-lane layouts (the
cell's 150-orbital blocks): the operations its launches' iterations
needed (roofline.decimate_ops, from the per-lane iteration counts each
launch returns, n and the mode) at 67 TFLOP/s, over the device time of
its kernels sancho_kernel and dyson_kernel in the trace."""

from negfbench import roofline

KERNELS = ("sancho_kernel", "dyson_kernel")
MIN_CTA_N = 17          # n at and above which a lane takes a whole CTA


def _launch(a, k, out):
    mode = k.get("mode", a[4] if len(a) > 4 else "sancho")
    return out[1], int(a[0].shape[-1]), mode


SPANS = [{"name": "kernel.sancho_rubio",
          "target": "gaunegf_tpu_torch.ops.kernels.sancho_rubio:decimate",
          "record": _launch}]


def read(run):
    launches = [v for phase, v in run.spans.records["kernel.sancho_rubio"]
                if phase == "stretch" and v[1] >= MIN_CTA_N]
    device_s = sum(run.profile.kernel_seconds(k) for k in KERNELS) \
        if run.profile else 0.0
    if not launches or device_s <= 0:
        return None
    ops = sum(roofline.decimate_ops(c.cpu().tolist(), n, mode)
              for c, n, mode in launches)
    return 100.0 * ops / roofline.PEAK_OPS / device_s
