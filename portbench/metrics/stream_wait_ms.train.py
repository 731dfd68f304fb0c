"""stream_wait_ms.train: the host's wait for the stream's next staged
chunk (`ChunkStream`'s iterator), ms a chunk, the mean over the window
(the benchmark's span around each `next()`)."""


def read(run):
    waits = run["record"]["spans"].get("stream.next")
    return 1e3 * sum(waits) / len(waits) if waits else None
