"""Device operations (kernels, copies, fills) in the traced stretch over
its batched frames: the host's dispatch a frame, which does not grow with
the lanes."""

UNIT = "launches"


def read(run):
    if run.stretch is None or not run.stretch.n_ops:
        return None
    steps = run.stretch_scans / max(1, run.lanes)
    return run.stretch.n_ops / steps if steps else None
