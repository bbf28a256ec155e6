"""The card's time a scan: the summed device time of every operation
the window issued (kernels, copies, fills), over the scans it completed.
Recorded with CUPTI activity only, in the untraced run."""

UNIT = "ms"
NEEDS_WINDOW_DEVICE_TRACE = True


def read(run):
    tr = run.window_trace
    if tr is None or run.scans == 0:
        return None
    dev = tr.device_s()
    return dev / run.scans * 1e3 if dev > 0 else None
