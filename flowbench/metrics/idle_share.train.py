"""Share (%) of the measured window with nothing running on the device,
no kernel and no copy: the traced stretch's device time a step times the
window's steps, over the window's length (``harness.idle_share``)."""

from flowbench.harness import idle_share


def read(view):
    return idle_share(view)
