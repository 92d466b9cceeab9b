"""Atom-steps completed in the window over its wall seconds (host clock,
the window ending at a thermo row, which waits for the device)."""


def read(run):
    return run.n_atoms * run.window_steps / run.window_s
