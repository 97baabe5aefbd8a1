"""K1's share of its roofline in the traced train window (with dropout):
the least time the layers' forward on the window's real tokens could take
— the train step's batches and the miner's encodes (its anchors a batch,
its table refresh) — over the device seconds of the layer kernels that run
before a step's K3 (``kernels.label_kernels``). Kernels summed: the port's
layer kernels (``kernels.LAYER``) in the forward phase."""

import numpy as np

from portbench import work

KERNELS = ("gemm_bf16_kernel", "attention_mma_kernel", "layernorm_kernel", "sum_rows_kernel")


def read(observed):
    trace = observed["trace"]
    if trace is None or trace.seconds("K1") <= 0 or observed.get("lengths") is None:
        return None
    cfg = observed["cfg"]
    L = cfg["num_hidden_layers"]
    miner_lengths, miner_calls = observed["miner"]
    lengths = np.concatenate([observed["lengths"], miner_lengths])
    flops = L * work.layer_flops(cfg, lengths)
    nbytes = L * work.layer_bytes(cfg, lengths, observed["steps"] + miner_calls)
    return work.roofline_pct(flops, nbytes, trace.seconds("K1"), observed["device_name"])
