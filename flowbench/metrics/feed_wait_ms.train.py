"""Host ms per step spent getting the batch (the benchmark's span around
the feed's call, the device batcher's), over the measured window."""


def read(view):
    if view.window_items == 0 or view.window_feed_s <= 0:
        return None
    return 1e3 * view.window_feed_s / view.window_items
