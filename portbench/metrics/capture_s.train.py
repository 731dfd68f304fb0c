"""capture_s.train: the warm-up and capture of the trainer's CUDA graphs
(the program's span `graph.capture`), s in all over the process: one
capture at set-up; more would be recaptures (0 where nothing was
captured, as on the CPU)."""

from portbench.core.spans import total_s


def read(run):
    return total_s(run, "graph.capture")
