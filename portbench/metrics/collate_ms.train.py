"""Host milliseconds a train step spends in collation (selection,
tokenization of the four roles, stacking) on the prefetch thread, over the
traced window's batches, timed by the probe around the program's
``QuadrupletCollator``. Kernels summed: none."""

KERNELS = ()


def read(observed):
    if not observed.get("steps"):
        return None
    return 1e3 * observed["collate_s"] / observed["steps"]
