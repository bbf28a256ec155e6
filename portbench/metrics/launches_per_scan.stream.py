"""Device operations (kernels, copies, fills) in the traced stretch over
its scans."""

UNIT = "launches"


def read(run):
    if run.stretch is None or not run.stretch_scans or not run.stretch.n_ops:
        return None
    return run.stretch.n_ops / run.stretch_scans
