"""Set-up: from the start of the process to the first measured scan
(imports, kernel builds or loads, the pool, the warm-up frames)."""

UNIT = "s"


def read(run):
    return run.setup_s
