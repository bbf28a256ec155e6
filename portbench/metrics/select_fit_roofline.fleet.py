"""select_fit's roofline share in the traced stretch: its calls' bounds
(``portbench/roofline.py``) over its device time."""

from portbench import roofline

UNIT = "%"


def read(run):
    return roofline.share(run, "select_fit")
