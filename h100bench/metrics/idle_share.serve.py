"""The device's idle share over a serving window: 1 - the union of its
kernels' and copies' intervals (``torch.profiler``) over the window.  The
profiler's host cost is in the window, so this is an upper bound."""


def read(t):
    if t.kind != "serve" or t.busy_s is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
