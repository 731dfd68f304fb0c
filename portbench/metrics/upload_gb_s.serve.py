"""upload_gb_s.serve: the bytes the predictor uploads over the host time
of its uploads (the program's span `serve.upload`), GB/s, over every
`BatchPredictor` call of the process (set-up's warm-up calls and the
traced calls included)."""

from portbench.core.spans import gb_s


def read(run):
    return gb_s(run, "serve.upload")
