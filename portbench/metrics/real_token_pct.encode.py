"""Real tokens over the token slots K1 ran in the traced encode window, an
exact count: the attention masks' sums (from the tokenizer the harness hands
the encoder) over the (batch, sequence) shapes ``SentenceEncoder.encode_ids``
received after trimming and bucketing. Kernels summed: none."""

KERNELS = ()


def read(observed):
    slots = observed.get("slots", 0)
    lengths = observed.get("lengths")
    if not slots or lengths is None:
        return None
    return 100.0 * float(sum(lengths)) / slots
