"""The device's idle share over a training window, as ``idle_share.serve``
reads it."""


def read(t):
    if t.kind != "train" or t.busy_s is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
