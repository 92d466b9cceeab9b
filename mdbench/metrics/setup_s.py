"""Process start to the window's start: imports, CUDA initialisation,
the kernels' load (or build), the deck's construction and the warm-up
(host clock)."""


def read(run):
    return run.setup_s
