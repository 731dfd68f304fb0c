"""q2_roofline: Q2 (the int8 conv kernel with its epilogue) at its
roofline, in %: the least time of every quantized conv of a call
(`core/roofline.py::int8_conv_work`, summed) over Q2's summed device time
a call in the trace."""

KERNEL = "int8_conv_tma_kernel"


def read(run):
    t, r = run["trace"], run["record"]
    if t is None or "q2_bound_ms" not in r:
        return None
    ms = 1e3 * sum(s for n, (_, s) in t["kernels"].items()
                   if KERNEL in n) / len(t["calls"])
    return 100.0 * r["q2_bound_ms"] / ms if ms > 0 else None
