"""host_ms_per_call.serve: a traced call's wall time less the card's busy
time inside it, ms, the mean over the traced calls: what the predictor's
host work (letterbox, staging, the lists) adds to a call."""


def read(run):
    t = run["trace"]
    if t is None or not t["calls"]:
        return None
    return 1e3 * sum(w - b for w, b in t["calls"]) / len(t["calls"])
