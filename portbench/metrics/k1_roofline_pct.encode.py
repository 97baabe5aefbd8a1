"""K1's share of its roofline in the traced encode window: the least time
the layers' forward on the real tokens could take (operations at the bf16
peak or bytes at HBM's, whichever is longer; ``work.layer_flops`` and
``work.layer_bytes`` a layer and batch) over the device seconds of K1's
kernels. Kernels summed: the port's layer kernels (``kernels.LAYER``:
GEMMs, attention, LayerNorm, ordered sums), labelled K1 outside training."""

from portbench import work

KERNELS = ("gemm_bf16_kernel", "attention_mma_kernel", "attention_kb_mma_kernel",
           "attention_kernel", "attention_kb_kernel", "layernorm_kernel", "sum_rows_kernel")


def read(observed):
    trace = observed["trace"]
    lengths = observed.get("lengths")
    if trace is None or lengths is None or len(lengths) == 0 or trace.seconds("K1") <= 0:
        return None
    cfg = observed["cfg"]
    flops = work.encoder_flops(cfg, lengths)
    nbytes = cfg["num_hidden_layers"] * work.layer_bytes(cfg, lengths, observed["batches"])
    return work.roofline_pct(flops, nbytes, trace.seconds("K1"), observed["device_name"])
