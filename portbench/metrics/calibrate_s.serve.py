"""calibrate_s.serve: the int8 predictor's calibration at set-up (the
program's span `serve.calibrate`: letterboxing the calibration frames,
the calibration forwards, quantizing the weights), s in all."""

from portbench.core.spans import total_s


def read(run):
    return total_s(run, "serve.calibrate")
