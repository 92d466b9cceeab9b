"""Cell capacity grows (each a rollback, rebin and replay) over the run
(the engine's ``grows`` counter)."""


def read(run):
    return None if run.grows is None else float(run.grows)
