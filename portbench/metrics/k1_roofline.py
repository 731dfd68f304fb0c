"""k1_roofline: K1 (the NMS keep-mask kernel, its mask pass and scan) at
its roofline, in %: the least time of the IoU tests these calls'
candidates need (`core/roofline.py::nms_work`) over K1's device time a
call in the trace."""

KERNELS = ("nms_mask_pass", "nms_scan")


def read(run):
    t, r = run["trace"], run["record"]
    if t is None or "k1_bound_ms" not in r:
        return None
    ms = 1e3 * sum(s for n, (_, s) in t["kernels"].items()
                   if any(k in n for k in KERNELS)) / len(t["calls"])
    return 100.0 * r["k1_bound_ms"] / ms if ms > 0 else None
