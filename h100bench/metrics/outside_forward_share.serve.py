"""Share of a serving window's wall time outside the model's forwards: 1 -
the forwards' CUDA-event time over the window.  Window assembly, the
host-to-device and device-to-host copies, the syncs and the host's work
between forwards."""


def read(t):
    if t.kind != "serve" or not t.forwards:
        return None
    return 100.0 * (1.0 - sum(f["ms"] for f in t.forwards) / 1e3 / t.window_s)
