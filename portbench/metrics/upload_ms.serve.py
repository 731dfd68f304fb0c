"""upload_ms.serve: the batch's and its params' upload to the card (the
program's span `serve.upload`), ms a call, the mean over every
`BatchPredictor` call of the process (set-up's warm-up calls and the
traced calls included)."""

from portbench.core.spans import mean_ms


def read(run):
    return mean_ms(run, "serve.upload", per="serve.call")
