"""mfu.train: a training step's share of the card's peak, in %: 3x the
forward conv FLOPs of an image (walked on the benchmark's reference
model) times the window's img/s, over the dtype's peak FLOP/s."""

from portbench.core.roofline import H100_PEAK_FLOPS


def read(run):
    r = run["record"]
    peak = H100_PEAK_FLOPS[r["dtype"]]
    return 100.0 * r["flops_per_img"] * r["img_s"] / peak
