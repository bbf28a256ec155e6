"""The traced stretch's idle share: the time no device operation ran,
over the stretch's host time."""

UNIT = "%"


def read(run):
    tr = run.stretch
    if tr is None or tr.window_s <= 0 or not tr.n_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
