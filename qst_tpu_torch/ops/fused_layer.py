"""K1: the fused BERT encoder layer, forward — counterpart of
``qst_tpu/ops/fused_layer_pallas.py``.

Replaces the TPU kernel ``_layer_kernel`` (``fused_layer_pallas.py:111``)
behind ``fused_bert_layer`` (``:189``). On the H100 the layer is a chain of
hand-written kernels in ``kernels/csrc/fused_layer.cu``: tensor-core GEMMs
with the bias, erf-GELU or residual fused into their epilogues, one
attention block per (sequence, head) whose (S, S) probabilities stay in
shared memory, and a warp-per-row LayerNorm with f32 statistics. What bounds
it and what the design does about it is in that file's header.

``fused_bert_layer`` takes the plain version, ``fused_bert_layer_plain``,
only for a tensor on the CPU; a CUDA tensor launches the kernels or raises.
``fused_bert_layer.launches`` counts the kernel launches.

Scope of the CUDA path: S ≤ 128, head_dim 32 or 64, float32 or bfloat16,
deterministic. MPNet's relative bias and in-kernel dropout (the training
forward) raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict

import torch

from qst_tpu_torch.core.config import EncoderConfig

MASK_BIAS = -1e9  # additive bias for padded key positions (models/bert.py)

# Weight order of the TPU kernel (fused_layer_pallas.py:51-54)
WEIGHT_NAMES = (
    "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
    "ln1_g", "ln1_b", "w1", "b1", "w2", "b2", "ln2_g", "ln2_b",
)
# What the CUDA entry point takes: Q, K and V as one (H, 3H) GEMM operand
_KERNEL_OPERANDS = ("wqkv", "bqkv") + WEIGHT_NAMES[6:]
_MATRICES = ("wqkv", "wo", "w1", "w2")
MAX_SEQ = 128
HEAD_DIMS = (32, 64)


def _layernorm_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics over the last axis (x already f32)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def fused_bert_layer_plain(x: torch.Tensor, mask_bias: torch.Tensor,
                           weights: Dict[str, torch.Tensor], *, num_heads: int,
                           eps: float = 1e-12) -> torch.Tensor:
    """Plain PyTorch version of K1: the TPU kernel's body for the whole
    batch at once, with its rounding points (q/k/v after bias, the
    probabilities before P·V, ctx, the LN1 output, the GELU output and the
    layer output round to x.dtype; everything else is f32). Products upcast
    to f32 first, so bf16 operands give exact products with f32 sums."""
    B, S, H = x.shape
    hd = H // num_heads
    dt = x.dtype
    w = {n: weights[n].float() for n in WEIGHT_NAMES}
    x2 = x.reshape(B * S, H).float()

    def proj(wn, bn):
        return (x2 @ w[wn] + w[bn]).to(dt)

    def heads(t):
        return t.float().reshape(B, S, num_heads, hd)

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    scores = torch.einsum("bqhd,bkhd->bhqk", heads(q), heads(k))
    scores = scores * (1.0 / math.sqrt(hd)) + mask_bias.float()[:, None, None, :]
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), heads(v))
    ctx = ctx.reshape(B * S, H).to(dt)
    attn = ctx.float() @ w["wo"] + w["bo"]
    y = _layernorm_f32(attn + x2, w["ln1_g"], w["ln1_b"], eps).to(dt)
    inter = _gelu_erf(y.float() @ w["w1"] + w["b1"]).to(dt)
    ffn = inter.float() @ w["w2"] + w["b2"]
    out = _layernorm_f32(ffn + y.float(), w["ln2_g"], w["ln2_b"], eps)
    return out.to(dt).reshape(B, S, H)


def _qkv_operands(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The kernel's operands: ``wqkv`` = [wq | wk | wv] (H, 3H) and its bias
    ``bqkv`` (1, 3H), taken from the dict when ``layer_weights_from_module``
    cached them, else concatenated here; the other weights as they are."""
    if "wqkv" not in weights:
        weights = dict(weights,
                       wqkv=torch.cat([weights["wq"], weights["wk"], weights["wv"]], 1),
                       bqkv=torch.cat([weights["bq"], weights["bk"], weights["bv"]], 1))
    return {n: weights[n] for n in _KERNEL_OPERANDS}


def _check_cuda_args(x, mask_bias, operands, num_heads) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused layer kernel takes float32/bfloat16, got {x.dtype}")
    B, S, H = x.shape
    F = operands["w1"].shape[1]
    hd = H // num_heads
    if S > MAX_SEQ:
        raise NotImplementedError(f"fused layer kernel needs S <= {MAX_SEQ}, got {S}")
    if H % num_heads or hd not in HEAD_DIMS:
        raise NotImplementedError(f"fused layer kernel needs head_dim in {HEAD_DIMS}")
    if H % 64 or F % 64 or H > 1024:
        raise ValueError(f"fused layer kernel needs H, F % 64 == 0 and H <= 1024, got {H}, {F}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if (mask_bias.shape != (B, S) or mask_bias.dtype != torch.float32
            or not mask_bias.is_contiguous() or mask_bias.device != x.device):
        raise ValueError("mask_bias must be a contiguous (B, S) float32 tensor on x's device")
    shapes = {"wqkv": (H, 3 * H), "bqkv": (1, 3 * H), "wo": (H, H), "w1": (H, F),
              "w2": (F, H), "b1": (1, F)}
    for n, t in operands.items():
        want_dt = x.dtype if n in _MATRICES else torch.float32
        want_shape = shapes.get(n, (1, H))
        if (t.dtype != want_dt or tuple(t.shape) != want_shape
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(
                f"weight {n}: need contiguous {want_shape} {want_dt} on {x.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}")


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 20
             + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])


def fused_bert_layer(x: torch.Tensor, mask_bias: torch.Tensor,
                     weights: Dict[str, torch.Tensor], *, num_heads: int,
                     rel_bias: torch.Tensor | None = None, eps: float = 1e-12,
                     attn_dropout: float = 0.0, hidden_dropout: float = 0.0,
                     seed: torch.Tensor | None = None) -> torch.Tensor:
    """One full BERT encoder layer (attention + FFN + layernorms).

    x: (B, S, H); mask_bias: (B, S) f32 (0 attended / -1e9 pad); weights in
    the TPU kernel layout (``WEIGHT_NAMES``): (H, H), (H, F), (F, H)
    matrices in (in, out) order and x's dtype, (1, ·) f32 biases and
    LayerNorm parameters; optionally also ``wqkv``/``bqkv``, the Q, K and V
    weights concatenated as ``layer_weights_from_module`` caches them, so
    the kernel's single QKV product needs no concatenation per call.
    → (B, S, H) in x.dtype.

    A CPU tensor takes ``fused_bert_layer_plain``; a CUDA tensor launches
    K1 or raises on what it does not take."""
    if rel_bias is not None or attn_dropout > 0.0 or hidden_dropout > 0.0 or seed is not None:
        raise NotImplementedError(
            "the fused layer port covers the deterministic BERT layer only "
            "(MPNet relative bias and in-kernel dropout are not ported)")
    if x.device.type == "cpu":
        return fused_bert_layer_plain(x, mask_bias, weights, num_heads=num_heads, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused layer runs on cpu or cuda tensors, got {x.device}")
    operands = _qkv_operands(weights)
    _check_cuda_args(x, mask_bias, operands, num_heads)
    from qst_tpu_torch.kernels import build

    B, S, H = x.shape
    F = weights["w1"].shape[1]
    M = B * S
    dt = x.dtype
    qkv = torch.empty((M, 3 * H), dtype=dt, device=x.device)
    ctx = torch.empty((M, H), dtype=dt, device=x.device)
    tmp = torch.empty((M, H), dtype=torch.float32, device=x.device)
    y = torch.empty((M, H), dtype=dt, device=x.device)
    inter = torch.empty((M, F), dtype=dt, device=x.device)
    out = torch.empty((B, S, H), dtype=dt, device=x.device)
    fn = build.function("qst_fused_layer_forward", _ARGTYPES)
    with torch.cuda.device(x.device):   # launch into the tensors' device context
        code = fn(build.DTYPE_CODES[str(dt).removeprefix("torch.")], x.data_ptr(),
                  mask_bias.data_ptr(), *[operands[n].data_ptr() for n in _KERNEL_OPERANDS],
                  qkv.data_ptr(), ctx.data_ptr(), tmp.data_ptr(), y.data_ptr(),
                  inter.data_ptr(), out.data_ptr(), B, S, H, F, num_heads, eps,
                  torch.cuda.current_stream(x.device).cuda_stream)
    fused_bert_layer.launches += 1
    build.check(code, "fused_bert_layer")
    return out


fused_bert_layer.launches = 0


def layer_weights_from_module(layer: torch.nn.Module,
                              dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One ``models.bert.BertLayer``'s weights in the kernel layout, made
    once and cached on the layer (counterpart of
    ``layer_weights_from_params``, ``fused_layer_pallas.py:658``).

    HF ``Linear`` weights are (out, in); the kernel takes (in, out), in the
    compute dtype. The dict also holds ``wqkv`` (H, 3H) and ``bqkv``
    (1, 3H), the operands of the kernel's one QKV product. The cache is
    keyed by the dtype and every parameter's storage and in-place version,
    so loading new weights, moving the module or casting invalidates it; a
    batch never transposes or concatenates again."""
    params = list(layer.parameters())
    key = (dtype, tuple((p.data_ptr(), p._version) for p in params))
    cached = layer.__dict__.get("_kernel_weights")
    if cached is not None and cached[0] == key:
        return cached[1]
    att, ffn_in, ffn_out = layer.attention, layer.intermediate, layer.output
    with torch.no_grad():
        def mat(lin):
            return lin.weight.detach().t().contiguous().to(dtype)

        def vec(t):
            return t.detach().reshape(1, -1).float().contiguous()

        w = dict(
            wq=mat(att.self.query), bq=vec(att.self.query.bias),
            wk=mat(att.self.key), bk=vec(att.self.key.bias),
            wv=mat(att.self.value), bv=vec(att.self.value.bias),
            wo=mat(att.output.dense), bo=vec(att.output.dense.bias),
            ln1_g=vec(att.output.LayerNorm.weight), ln1_b=vec(att.output.LayerNorm.bias),
            w1=mat(ffn_in.dense), b1=vec(ffn_in.dense.bias),
            w2=mat(ffn_out.dense), b2=vec(ffn_out.dense.bias),
            ln2_g=vec(ffn_out.LayerNorm.weight), ln2_b=vec(ffn_out.LayerNorm.bias),
        )
        w.update(wqkv=torch.cat([w["wq"], w["wk"], w["wv"]], 1),
                 bqkv=torch.cat([w["bq"], w["bk"], w["bv"]], 1))
    layer.__dict__["_kernel_weights"] = (key, w)
    return w


def fused_encoder_forward(cfg: EncoderConfig, model: torch.nn.Module,
                          input_ids: torch.Tensor,
                          attention_mask: torch.Tensor) -> torch.Tensor:
    """ids/mask → last hidden state (B, S, H) through ``fused_bert_layer``.

    Numerically the ``models.bert.BertEncoder`` forward (deterministic): the
    embeddings (a gather plus LayerNorm) stay plain torch, as they stay XLA
    in the TPU version (``fused_layer_pallas.py:750-762``); each transformer
    layer is one ``fused_bert_layer`` call. The GPU needs no batch padding
    to a block multiple."""
    if cfg.arch != "bert":
        raise NotImplementedError(f"fused layer port covers arch='bert', got {cfg.arch}")
    dt = getattr(torch, cfg.dtype)
    emb = model.embeddings
    S = input_ids.shape[1]
    word = emb.word_embeddings.weight[input_ids.long()].to(dt)
    pos = emb.position_embeddings.weight[:S].to(dt)[None]
    typ = emb.token_type_embeddings.weight[0].to(dt)[None, None]
    x = _layernorm_f32((word + pos + typ).float(), emb.LayerNorm.weight.float(),
                       emb.LayerNorm.bias.float(), cfg.layer_norm_eps).to(dt)
    mask_bias = torch.where(attention_mask > 0, 0.0, MASK_BIAS).float().contiguous()
    x = x.contiguous()
    for layer in model.encoder.layer:
        w = layer_weights_from_module(layer, dt)
        x = fused_bert_layer(x, mask_bias, w, num_heads=cfg.num_heads,
                             eps=cfg.layer_norm_eps)
    return x


def fused_embed_fn(cfg: EncoderConfig) -> Callable:
    """The fused-path forward: (model, ids, mask) → (B, D) embeddings.
    Drop-in for ``models.sentence_encoder.embed_fn`` on the encode path."""
    from qst_tpu_torch.ops.distances import l2_normalize
    from qst_tpu_torch.ops.pooling import POOLERS

    def fwd(model, input_ids, attention_mask):
        with torch.no_grad():
            hidden = fused_encoder_forward(cfg, model, input_ids, attention_mask)
            pooled = POOLERS[cfg.pooling](hidden, attention_mask)
            if cfg.normalize:
                pooled = l2_normalize(pooled)
        return pooled

    return fwd
