"""Share (%) of the measured window with nothing running on the device,
no kernel and no copy: the traced stretch's device time a pair times the
window's pairs, over the window's length (``harness.idle_share``)."""

from flowbench.harness import idle_share


def read(view):
    return idle_share(view)
