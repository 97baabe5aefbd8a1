"""Device idle share of a cell's traced window: 100 · (1 − busy / window).
Busy is the union of the card's records (kernels, copies, sets) in the
trace; the window is the host clock's. Kernels summed: all. The train
cell's traced window is one miner refresh period of steps."""

KERNELS = ("all device records",)


def read(observed):
    trace = observed["trace"]
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
