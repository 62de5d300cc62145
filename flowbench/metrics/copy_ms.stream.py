"""Device ms per pair of the host-to-device and device-to-host copies in
the traced stretch (Entry layer: the images in, the flow out)."""


def read(view):
    ms = sum(e - s for name, s, e in view.copies
             if "HtoD" in name or "DtoH" in name) / 1e3
    return ms / view.items if ms > 0 else None
