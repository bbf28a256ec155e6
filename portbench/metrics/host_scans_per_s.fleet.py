"""Lane-scans completed over the untraced window's wall time: the fleet's
throughput, which the host still paces where the card idles half the
time, so it is read here and does not decide the cell."""

UNIT = "scans/s"


def read(run):
    return run.scans / run.wall_s if run.wall_s > 0 else None
