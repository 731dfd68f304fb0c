"""device_idle_pct.train: the share of the traced window in which no
kernel, copy or memset ran on the card, in %."""


def read(run):
    t = run["trace"]
    return None if t is None else 100.0 * (1 - t["busy_s"] / t["window_s"])
