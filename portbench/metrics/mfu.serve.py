"""mfu.serve: the served forward's share of the card's peak, in %: the
forward conv FLOPs of an image (walked on the benchmark's reference
model) times the window's img/s, over the peak of the cell's dtype
(bfloat16, or int8 for an int8 cell)."""

from portbench.core.roofline import H100_PEAK_FLOPS


def read(run):
    r = run["record"]
    peak = H100_PEAK_FLOPS[r["dtype"]]
    return 100.0 * r["flops_per_img"] * r["img_s"] / peak
