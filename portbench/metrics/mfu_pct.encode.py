"""The encoder's share of the card's bf16 peak over the traced window: every
layer's forward on the real tokens of the texts encoded in it
(``work.encoder_flops``) over window seconds · 989 TFLOP/s. Kernels
summed: none (the whole window)."""

from portbench import work

KERNELS = ()


def read(observed):
    trace = observed["trace"]
    lengths = observed.get("lengths")
    if trace is None or lengths is None or len(lengths) == 0:
        return None
    return work.mfu_pct(work.encoder_flops(observed["cfg"], lengths), trace.window_s,
                        observed["device_name"])
