"""Mean host seconds of a dump frame in the window: the per-atom
computes and the text written (host clock around ``write_custom``)."""


def read(run):
    if not run.frames_s:
        return None
    return sum(run.frames_s) / len(run.frames_s)
