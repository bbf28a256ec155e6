"""Host wall time over the untraced window, which ends in a synchronise,
over its scans."""

UNIT = "ms"


def read(run):
    return run.wall_s / run.scans * 1e3 if run.scans else None
