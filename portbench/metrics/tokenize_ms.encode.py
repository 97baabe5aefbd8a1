"""Host milliseconds a call of the port's tokenizer (``batch_encode`` of
one encode batch, 256 texts) in the traced window, timed by the probe the
harness hands the encoder in place of the tokenizer. Kernels summed: none."""

KERNELS = ()


def read(observed):
    calls = observed.get("tokenize_calls", 0)
    if not calls:
        return None
    return 1e3 * observed["tokenize_s"] / calls
