"""The train step's share of the card's bf16 peak over the traced window
(one period of steps): forward and backward of every layer on the real
tokens of the window's batches (``work.train_flops``: 6 · layer parameters
· tokens plus attention), with the miner's forward of its anchors and its
table refresh on their real tokens, over window seconds · 989 TFLOP/s.
Kernels summed: none (the whole window)."""

from portbench import work

KERNELS = ()


def read(observed):
    trace = observed["trace"]
    if trace is None or observed.get("lengths") is None:
        return None
    cfg = observed["cfg"]
    flops = work.train_flops(cfg, observed["lengths"]) + work.encoder_flops(
        cfg, observed["miner"][0])
    return work.mfu_pct(flops, trace.window_s, observed["device_name"])
