"""gather_ms.train: the stream's gather of one chunk into (pinned) host
memory on its producer thread (the program's span `stream.gather`), ms a
chunk, the mean over every chunk the process gathered (set-up's first
chunks and the traced ones included)."""

from portbench.core.spans import mean_ms


def read(run):
    return mean_ms(run, "stream.gather")
