"""Device ms per pair with a kernel running (the union of the traced
stretch's kernel intervals, copies left out)."""

from flowbench.harness import union_us


def read(view):
    busy = union_us(view.kernels, view.stretch)
    return busy / 1e3 / view.items if busy > 0 else None
