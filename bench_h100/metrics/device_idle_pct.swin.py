"""The device's idle share in a Video Swin cell: 100 less the union of
its kernel and copy intervals (torch.profiler) over a steady traced
slice of the cell's traffic, as a share of the slice."""


def read(view):
    if view.kind != "batch" or view.slice is None:
        return None
    return 100.0 * (1.0 - view.slice.busy_s / view.slice.window_s)
