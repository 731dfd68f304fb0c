"""take_wait_ms.train: the consumer's wait for the stream's next staged
chunk (the program's span `stream.take`: the queue's `get` and the wait
on the upload's event; an epoch's first take waits for its first
gather), ms a chunk, the mean over every chunk the process took (set-up's
first chunk and the traced ones included)."""

from portbench.core.spans import mean_ms


def read(run):
    return mean_ms(run, "stream.take")
