"""letterbox_ms.serve: the predictor's host letterbox (the program's span
`serve.letterbox`: per-image letterbox, `np.stack`, the params tensor),
ms a call, the mean over every `BatchPredictor` call of the process
(set-up's warm-up calls and the traced calls included)."""

from portbench.core.spans import mean_ms


def read(run):
    return mean_ms(run, "serve.letterbox", per="serve.call")
