"""Host seconds of ``build_simulation``: the deck read, replicated and
turned into the engine (host clock around the call)."""


def read(run):
    return run.frontend_s
