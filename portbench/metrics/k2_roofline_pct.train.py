"""K2's share of its roofline in the traced train window: the least time
the layers' backward on the window's real tokens could take (twice the
forward's operations, ``work.layer_flops``; twice its bytes, the weights
once a launch) over the device seconds of the layer kernels that run after
a step's K3 backward until its optimizer (``kernels.label_kernels``). The
miner's forward kernels that overlap a backward count there too, which
reads K2 a little low. Kernels summed: the port's layer kernels
(``kernels.LAYER``) in the backward phase."""

from portbench import work

KERNELS = ("gemm_bf16_kernel", "attention_mma_kernel", "attention_bwd_mma_kernel",
           "layernorm_kernel", "layernorm_bwd_kernel", "sum_rows_kernel")


def read(observed):
    trace = observed["trace"]
    if trace is None or trace.seconds("K2") <= 0 or observed.get("lengths") is None:
        return None
    cfg = observed["cfg"]
    L = cfg["num_hidden_layers"]
    flops = 2 * L * work.layer_flops(cfg, observed["lengths"])
    nbytes = 2 * L * work.layer_bytes(cfg, observed["lengths"], observed["steps"])
    return work.roofline_pct(flops, nbytes, trace.seconds("K2"), observed["device_name"])
