"""lists_ms.serve: building the per-image detection lists from the
downloaded outputs (the program's span `serve.lists`), ms a call, the
mean over every `BatchPredictor` call of the process (set-up's warm-up
calls and the traced calls included)."""

from portbench.core.spans import mean_ms


def read(run):
    return mean_ms(run, "serve.lists", per="serve.call")
