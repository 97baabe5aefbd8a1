"""Real tokens over token slots of the traced window's train batches, an
exact count: the attention masks the collator returned (the probe around the
program's ``QuadrupletCollator``) over 4 · batch · S slots a step.
Kernels summed: none."""

KERNELS = ()


def read(observed):
    if not observed.get("slots") or observed.get("lengths") is None:
        return None
    return 100.0 * float(sum(observed["lengths"])) / observed["slots"]
