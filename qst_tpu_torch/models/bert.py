"""BERT encoder as ``nn.Module``s — counterpart of ``qst_tpu/models/bert.py``.

Module and parameter names follow HF ``BertModel`` (``embeddings.*``,
``encoder.layer.N.attention.self.query.*``, ...), so a checkpoint's state
dict loads as it is. The forward keeps the Flax path's semantics:

- params stay f32; every projection runs in ``cfg.dtype`` (inputs, weight
  and bias cast to it, as Flax's ``Dense(dtype=...)`` does);
- attention logits and probabilities·V accumulate in f32 (operands upcast
  before the product), the softmax is f32, with a −1e9 additive pad bias;
- both LayerNorms take f32 statistics; the GELU is exact-erf;
- casts to ``cfg.dtype`` at the same points as the Flax modules;
- dropout at the Flax sites — the embeddings after their LayerNorm, the
  attention probabilities, the attention output and the FFN output — only
  in ``train()`` mode and only when the forward is given a
  ``dropout_generator`` (Flax's ``where(keep, x / keep_prob, 0)``; the bits
  are not JAX's). It is either a :class:`DeviceDropout` — every mask a
  pure function of a key tensor on the device, the global layer, the site
  and the element, drawn by device integer ops alone, so a captured graph
  replays the same draws (the training path's) — or a ``torch.Generator``
  from which every mask is drawn in turn.

``TensorParallelLayer`` is a layer's tensor-parallel form over a mesh's
model axis (``parallel/sharding.py``'s rules): shard j holds heads
[j·nh/m, (j+1)·nh/m) of Q, K and V with their columns of the attention
output, and FFN columns [j·I/m, (j+1)·I/m) with their rows of the FFN
output; each computes its partial of the two row-parallel products, and the
partials are summed in shard order, in f32, before the bias, dropout,
residual and LayerNorm, which are replicated.

``use_flash_attention`` routes the self-attention as qst_tpu's gate does
(``_flash_attention_available``: S ≥ 128, a multiple of 128, and no active
attention dropout) through ``ops/flash_attention.py``'s ``FlashAttention``
(K7 forward, K8 backward; their plain versions on the CPU), with the
library's segment-id semantics: seg = the attention mask, so a padded query
row attends to the padded keys only (its ``token_embeddings`` row differs
from the einsum path's; the pooled embedding does not). ``remat``
recomputes each layer in the backward instead of keeping its activations
(Flax's ``nn.remat``): the same values and gradients for less memory.
MPNet is ``models/mpnet.py``. RoBERTa (``arch="roberta"``) is this trunk
with BERT's state-dict layout and two changes, as in the source: its
positions are the padding-aware (B, S) ids of ``padding_aware_position_ids``
(counted from ``pad_token_id`` + 1 over the non-pad tokens), and its one
token-type row takes every segment (the ids are clamped to
``type_vocab_size - 1``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from qst_tpu_torch.core.config import EncoderConfig

MASK_BIAS = -1e9


def compute_dtype(cfg: EncoderConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _flash_attention_available(cfg: EncoderConfig, seq_len: int,
                               deterministic: bool) -> bool:
    """qst_tpu/models/bert.py:59-70: the flash path applies when S fits the
    kernel's 128-key tiling and attention dropout (not in the kernel) is
    inactive."""
    if not cfg.use_flash_attention:
        return False
    if seq_len < 128 or seq_len % 128 != 0:
        return False
    if not deterministic and cfg.attention_dropout > 0.0:
        return False
    return True


class _Linear(nn.Linear):
    """``nn.Linear`` with f32 parameters that runs in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


# dropout sites of a layer (and of the embeddings, at layer num_layers)
SITE_EMBEDDINGS, SITE_PROBS, SITE_ATTENTION_OUT, SITE_FFN_OUT = 0, 1, 2, 3


class DeviceDropout:
    """Dropout drawn on the device from ``key`` = (seed, step), an int64
    tensor of two on the model's device (``train_step.dropout_key``, folded
    with a data-shard or microbatch index by ``ops.fused_layer.fold_key``
    where a mesh or the pipeline adds one). The mask of (layer, site) keeps
    element i when the 31-bit hash of i under ``module_seed(key, layer,
    site)`` falls under the rate's threshold — the fused layer's hash: no
    host value, no generator state. ``at_layer`` names the global layer
    (the embeddings use ``num_layers``, as the JAX pipeline's streams do)."""

    def __init__(self, key: torch.Tensor, layer: int = 0):
        self.key = key
        self.layer = layer

    def at_layer(self, layer: int) -> "DeviceDropout":
        return DeviceDropout(self.key, layer)

    def keep(self, shape, site: int, rate: float, device,
             heads: Optional[tuple] = None) -> torch.Tensor:
        """The bool keep-mask of a tensor of ``shape`` (``heads`` as in
        ``ops.fused_layer.module_keep_mask``, which draws it: one kernel
        launch on a card)."""
        from qst_tpu_torch.ops.fused_layer import module_keep_mask

        return module_keep_mask(self.key, self.layer, site, shape, rate, device, heads)


def at_layer(gen, layer: int):
    """``gen`` for the layer ``layer``: a :class:`DeviceDropout` names it, a
    generator (or None) is passed on as it is."""
    return gen.at_layer(layer) if isinstance(gen, DeviceDropout) else gen


def _dropout(module: nn.Module, x: torch.Tensor, rate: float, gen, site: int = 0,
             heads: Optional[tuple] = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability 1 − rate and scale the kept
    values by 1/(1 − rate) in x's dtype; active in train() mode with a
    ``DeviceDropout`` (the mask of ``site``; ``heads`` as in
    ``DeviceDropout.keep``) or a generator (drawn on the generator's
    device)."""
    if not module.training or gen is None or rate == 0.0:
        return x
    if isinstance(gen, DeviceDropout):
        keep = gen.keep(x.shape, site, rate, x.device, heads)
    else:
        keep = torch.rand(x.shape, generator=gen, device=gen.device).to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, H)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, H)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, H)
        self.LayerNorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                position_ids: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``position_ids`` (B or 1, S). The position and token-type rows
        are read so that BERT's gradients come back the same on every run:
        positions shared by the batch as one (1, S) lookup, whose backward
        sums the batch in a fixed order, and the few token types by a
        selection, not a lookup — on the card ``F.embedding``'s backward
        adds a row repeated across the batch in no fixed order (a captured
        train step must repeat its eager steps bit for bit). The values are
        the lookups'. RoBERTa's (B, S) positions are a lookup, as MPNet's
        are."""
        dt = compute_dtype(self.cfg)
        word = self.word_embeddings(input_ids).to(dt)
        pos = self.position_embeddings(position_ids).to(dt)
        types = torch.clamp(token_type_ids, max=self.cfg.type_vocab_size - 1)[..., None]
        table = self.token_type_embeddings.weight
        typ = table[0]
        for t in range(1, self.cfg.type_vocab_size):
            typ = torch.where(types == t, table[t], typ)
        x = _layer_norm_f32(self.LayerNorm, word + pos + typ.to(dt))
        return _dropout(self, x, self.cfg.hidden_dropout, dropout_generator,
                        SITE_EMBEDDINGS).to(dt)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.rate = cfg.attention_dropout
        H = cfg.hidden_size
        self.query = _Linear(H, H)
        self.key = _Linear(H, H)
        self.value = _Linear(H, H)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, H = hidden.shape
        nh = self.num_heads
        hd = H // nh
        deterministic = not self.training or dropout_generator is None
        if attention_mask is not None and _flash_attention_available(self.cfg, S, deterministic):
            from qst_tpu_torch.ops.flash_attention import FlashAttention

            def heads_t(t):   # (B, nh, S, hd) in the compute dtype, as it lies
                return t.reshape(B, S, nh, hd).transpose(1, 2)

            seg = attention_mask.to(torch.int32)
            ctx = FlashAttention.apply(heads_t(self.query(hidden)), heads_t(self.key(hidden)),
                                       heads_t(self.value(hidden)), seg, seg, float(hd) ** -0.5)
            return ctx.transpose(1, 2).reshape(B, S, H).to(hidden.dtype)

        def heads(t):
            return t.reshape(B, S, nh, hd).float()

        q, k, v = heads(self.query(hidden)), heads(self.key(hidden)), heads(self.value(hidden))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(logits + bias, dim=-1).to(hidden.dtype)
        probs = _dropout(self, probs, self.rate, dropout_generator, SITE_PROBS)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v)
        return ctx.reshape(B, S, H).to(hidden.dtype)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.dense = _Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.rate = cfg.hidden_dropout

    def forward(self, ctx: torch.Tensor, hidden: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = _dropout(self, self.dense(ctx), self.rate, dropout_generator, SITE_ATTENTION_OUT)
        return _layer_norm_f32(self.LayerNorm, out + hidden).to(hidden.dtype)


class BertAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.output(self.self(hidden, bias, dropout_generator, attention_mask), hidden,
                           dropout_generator)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.dense = _Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(hidden).float(), approximate="none").to(hidden.dtype)


class BertOutput(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.dense = _Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.rate = cfg.hidden_dropout

    def forward(self, inter: torch.Tensor, hidden: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = _dropout(self, self.dense(inter), self.rate, dropout_generator, SITE_FFN_OUT)
        return _layer_norm_f32(self.LayerNorm, out + hidden).to(hidden.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``attention_mask`` (B, S): the segment ids of the flash path."""
        hidden = self.attention(hidden, bias, dropout_generator, attention_mask)
        return self.output(self.intermediate(hidden), hidden, dropout_generator)


class _LayerStack(nn.Module):
    """HF's ``BertEncoder``: the ``encoder.layer`` list."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


class BertEncoder(nn.Module):
    """Token-level encoder: ids/mask → last hidden state (B, S, H), the
    counterpart of qst_tpu's Flax ``BertEncoder`` (HF ``BertModel`` without
    its pooler)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.arch not in ("bert", "roberta"):
            raise ValueError(f"BertEncoder runs arch 'bert' and 'roberta', got {cfg.arch!r}")
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = _LayerStack(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``dropout_generator``: in train() mode, apply the config's dropout
        with masks drawn from it (Flax's ``deterministic=False``)."""
        S = input_ids.shape[1]
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if self.cfg.arch == "roberta":
            # fairseq-style padding-aware positions offset by pad_token_id
            # (HF RobertaEmbeddings.create_position_ids_from_input_ids)
            from qst_tpu_torch.models.mpnet import padding_aware_position_ids

            position_ids = padding_aware_position_ids(input_ids, self.cfg.pad_token_id)
        else:
            position_ids = torch.arange(S, device=input_ids.device)[None, :]
        hidden = self.embeddings(input_ids, token_type_ids.long(), position_ids,
                                 at_layer(dropout_generator, self.cfg.num_layers))
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, MASK_BIAS).float()
        remat = self.cfg.remat and torch.is_grad_enabled() and hidden.requires_grad
        for i, layer in enumerate(self.encoder.layer):
            gen = at_layer(dropout_generator, i)
            if remat:
                hidden = _remat_layer(layer, hidden, bias, gen, attention_mask)
            else:
                hidden = layer(hidden, bias, gen, attention_mask)
        return hidden


def _remat_layer(layer: nn.Module, hidden: torch.Tensor, bias: torch.Tensor,
                 gen, *extra: torch.Tensor) -> torch.Tensor:
    """One layer under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward. A generator's masks come from its state,
    which checkpoint does not keep: the recomputation starts from the state
    the forward started from (and puts back the one it found), so it draws
    the same masks. ``extra``: the layer's arguments after the generator
    (BERT's attention mask). A ``DeviceDropout`` draws the same masks on
    every call, so the recomputation needs nothing kept."""
    if gen is None or isinstance(gen, DeviceDropout):
        return checkpoint(layer, hidden, bias, gen, *extra, use_reentrant=False)
    start = gen.get_state()
    first = [True]

    def run(h, b, *e):
        if first[0]:
            first[0] = False
            return layer(h, b, gen, *e)
        now = gen.get_state()
        gen.set_state(start)
        try:
            return layer(h, b, gen, *e)
        finally:
            gen.set_state(now)

    return checkpoint(run, hidden, bias, *extra, use_reentrant=False)


# ---------------------------------------------------------------------------
# The tensor-parallel layer form
# ---------------------------------------------------------------------------
# Where a layer's tensors sit in its HF state dict, by part: BERT's names
# (MPNet's: models/mpnet.py MPNET_LAYER_PARTS)
BERT_LAYER_PARTS = {"q": "attention.self.query", "k": "attention.self.key",
                    "v": "attention.self.value", "o": "attention.output.dense",
                    "ln1": "attention.output.LayerNorm", "i": "intermediate.dense",
                    "out": "output.dense", "ln2": "output.LayerNorm"}

# (the tensor-parallel layer's name, its layer part and tensor); "{j}" is the
# shard. Which dimension a tensor splits over the model shards, if any, is
# ``parallel/sharding.py``'s rule (``tp_split_dim``).
TP_LAYER_NAMES = (
    ("shards.{j}.query.weight", "q", "weight"), ("shards.{j}.query.bias", "q", "bias"),
    ("shards.{j}.key.weight", "k", "weight"), ("shards.{j}.key.bias", "k", "bias"),
    ("shards.{j}.value.weight", "v", "weight"), ("shards.{j}.value.bias", "v", "bias"),
    ("shards.{j}.o.weight", "o", "weight"), ("o_bias", "o", "bias"),
    ("ln1.weight", "ln1", "weight"), ("ln1.bias", "ln1", "bias"),
    ("shards.{j}.intermediate.weight", "i", "weight"),
    ("shards.{j}.intermediate.bias", "i", "bias"),
    ("shards.{j}.output.weight", "out", "weight"), ("out_bias", "out", "bias"),
    ("ln2.weight", "ln2", "weight"), ("ln2.bias", "ln2", "bias"),
)


def tp_split_dim(hf_name: str, ndim: int, name: str) -> Optional[int]:
    """The dimension the layer tensor ``hf_name`` (relative to its layer)
    splits over the model shards by ``parallel/sharding.py``'s rule, or
    None when the rule replicates it; the tensor-parallel layer's ``name``
    must hold a shard ("{j}") exactly when the rule splits."""
    from qst_tpu_torch.parallel.sharding import spec_for_param, split_dim

    dim = split_dim(spec_for_param(f"encoder.layer.0.{hf_name}", ndim))
    if (dim is None) == ("{j}" in name):
        raise ValueError(f"the sharding rule for {hf_name} ({dim}) does not fit the "
                         f"tensor-parallel layer's {name}")
    return dim


class _LayerShard(nn.Module):
    """One model shard of a layer: its heads of Q, K, V and their columns of
    the attention output; its FFN columns and their rows of the FFN output."""

    def __init__(self, H: int, part_h: int, part_i: int):
        super().__init__()
        self.query, self.key, self.value = (_Linear(H, part_h) for _ in range(3))
        self.o = nn.Linear(part_h, H, bias=False)
        self.intermediate = _Linear(H, part_i)
        self.output = nn.Linear(part_i, H, bias=False)


class TensorParallelLayer(nn.Module):
    """A BERT or MPNet layer split over ``n_shards`` model shards
    (``qst_tpu/parallel/sharding.py``'s rules over HF names). Its forward
    takes a ``BertLayer``'s arguments; shard j computes on the device of its
    own tensors, and the partials come back to the input's device, summed in
    shard order. ``parts``: the HF part names (``BERT_LAYER_PARTS`` or
    ``MPNET_LAYER_PARTS``), so that ``full_state`` / ``from_full`` map to
    and from the layer's HF tensors.

    On a mesh row split across processes (``mesh`` given, the row from
    ``core/meshes.py:current_row``) this process holds and computes only
    the shards of the columns it owns (``held``; the others are empty
    modules): the partials cross the row's processes through
    ``row_sum`` and the replicated input's gradient through ``row_scatter``,
    the same calls as in one process, so the bits are one process's."""

    def __init__(self, cfg: EncoderConfig, n_shards: int, parts: dict,
                 held: Optional[Sequence[int]] = None):
        super().__init__()
        H, nh, inter = cfg.hidden_size, cfg.num_heads, cfg.intermediate_size
        if nh % n_shards or inter % n_shards:
            raise ValueError(f"{nh} heads and FFN width {inter} must divide into "
                             f"{n_shards} model shards")
        self.cfg, self.parts, self.n_shards = cfg, dict(parts), n_shards
        held = range(n_shards) if held is None else held
        self.shards = nn.ModuleList(
            _LayerShard(H, H // n_shards, inter // n_shards) if j in held else nn.Module()
            for j in range(n_shards))
        self.o_bias = nn.Parameter(torch.zeros(H))
        self.out_bias = nn.Parameter(torch.zeros(H))
        self.ln1 = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.ln2 = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.mesh = None

    @classmethod
    def from_full(cls, cfg: EncoderConfig, full: dict, parts: dict, devices,
                  mesh=None, home=None) -> "TensorParallelLayer":
        """The layer made from its HF tensors ``full`` ({"attention.self.query.weight":
        ..., ...} relative to the layer): shard j's slices are copied to
        ``devices[j]``, the replicated tensors stay on ``home`` (default
        ``devices[0]``). With a ``mesh`` across processes only the shards of
        the columns this process owns a position of are made."""
        held = None if mesh is None else [
            j for j, r in enumerate(mesh.axis_ranks(mesh.axis_names[1])) if r == mesh.rank]
        with torch.device("meta"):
            layer = cls(cfg, len(devices), parts, held)
        layer = layer.to_empty(device=devices[0] if home is None else home)
        own = layer.state_dict().keys()
        layer.load_state_dict({k: v for k, v in split_layer_state(
            full, parts, len(devices)).items() if k in own})
        for j, dev in enumerate(devices):
            layer.shards[j].to(dev)
        layer.mesh = mesh
        return layer

    def _owners(self) -> List[int]:
        """The owning process of each column of the row this call runs."""
        if self.mesh is None:
            return [0] * self.n_shards
        from qst_tpu_torch.core.meshes import current_row

        return self.mesh.row_ranks(current_row(self.mesh))

    def _mine(self, owners: List[int]) -> List[int]:
        rank = 0 if self.mesh is None else self.mesh.rank
        return [j for j, r in enumerate(owners) if r == rank]

    def full_state(self) -> dict:
        """The layer's HF tensors (relative names), each gathered on the
        first shard's device — on a row split across processes, the other
        processes' slices handed over (``gather_columns``: no gradient
        flows back to them; their owners form their own)."""
        named = dict(self.named_parameters())
        owners = self._owners()
        mine = self._mine(owners)
        if len(mine) < len(owners):
            from qst_tpu_torch.core.meshes import gather_columns

            names = [n for n, _, _ in TP_LAYER_NAMES if "{j}" in n]
            shapes = [named[n.format(j=mine[0])].shape for n in names]
            packed = gather_columns({j: torch.cat([named[n.format(j=j)].reshape(-1)
                                                   for n in names]) for j in mine}, owners)
            for j, flat in enumerate(packed):
                if j not in mine:
                    for n, shape, piece in zip(names, shapes,
                                               flat.split([s.numel() for s in shapes])):
                        named[n.format(j=j)] = piece.view(shape)
        return gather_layer_state(named, self.parts, self.n_shards)

    def kernel_weights(self, dtype: torch.dtype) -> dict:
        """The fused layer's operands (``layer_weights_for_training``'s
        layout) with the shards gathered — the JAX package's ``P()`` in_specs
        of the fused path — so gradients flow back to each slice this
        process holds."""
        full = self.full_state()
        p = self.parts

        def mat(part):
            return full[f"{p[part]}.weight"].t().to(dtype).contiguous()

        def vec(part, t="bias"):
            return full[f"{p[part]}.{t}"].reshape(1, -1).float().contiguous()

        return dict(wq=mat("q"), bq=vec("q"), wk=mat("k"), bk=vec("k"), wv=mat("v"),
                    bv=vec("v"), wo=mat("o"), bo=vec("o"), ln1_g=vec("ln1", "weight"),
                    ln1_b=vec("ln1"), w1=mat("i"), b1=vec("i"), w2=mat("out"), b2=vec("out"),
                    ln2_g=vec("ln2", "weight"), ln2_b=vec("ln2"))

    def forward(self, hidden: torch.Tensor, bias: torch.Tensor, dropout_generator=None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``bias``: (B, 1, 1, S) or, with MPNet's relative bias, (B, nh, S,
        S), of which shard j takes its heads. ``attention_mask`` is accepted
        and unused (the shards run the einsum attention)."""
        from qst_tpu_torch.core.meshes import row_scatter, row_sum

        del attention_mask
        B, S, H = hidden.shape
        dt, home = hidden.dtype, hidden.device
        nh = self.cfg.num_heads
        nh_j, hd = nh // self.n_shards, H // nh
        owners = self._owners()
        mine = self._mine(owners)
        devs = [self.shards[j].query.weight.device for j in mine]
        # three uses a column (Q, K, V) and the residual: the input's gradient
        # is their sum in one process's order, on a row across processes too
        *xs, res = row_scatter(hidden, owners, devs, uses=3, residual=True)
        bs = row_scatter(bias, owners, devs, dim=1 if bias.shape[1] > 1 else None)
        parts = []
        for c, (j, b) in enumerate(zip(mine, bs)):
            sh, (xq, xk, xv) = self.shards[j], xs[3 * c:3 * c + 3]

            def heads(t):
                return t.reshape(B, S, nh_j, hd).float()

            q, k, v = heads(sh.query(xq)), heads(sh.key(xk)), heads(sh.value(xv))
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            probs = torch.softmax(logits + b, dim=-1).to(dt)
            probs = _dropout(self, probs, self.cfg.attention_dropout, dropout_generator,
                             SITE_PROBS, heads=(j * nh_j, nh))
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v).reshape(B, S, nh_j * hd)
            parts.append(F.linear(ctx.to(dt).float(), sh.o.weight.to(dt).float()))
        attn = row_sum(parts, owners, home)
        out = (attn + self.o_bias.to(dt).float()).to(dt)
        out = _dropout(self, out, self.cfg.hidden_dropout, dropout_generator, SITE_ATTENTION_OUT)
        hidden = _layer_norm_f32(self.ln1, out + res).to(dt)
        *xs, res = row_scatter(hidden, owners, devs, residual=True)
        parts = []
        for j, x in zip(mine, xs):
            sh = self.shards[j]
            inter = F.gelu(sh.intermediate(x).float(), approximate="none").to(dt)
            parts.append(F.linear(inter.float(), sh.output.weight.to(dt).float()))
        ffn = row_sum(parts, owners, home)
        out = (ffn + self.out_bias.to(dt).float()).to(dt)
        out = _dropout(self, out, self.cfg.hidden_dropout, dropout_generator, SITE_FFN_OUT)
        return _layer_norm_f32(self.ln2, out + res).to(dt)


def split_layer_state(full: dict, parts: dict, n_shards: int) -> dict:
    """A layer's HF tensors (relative names) → a ``TensorParallelLayer``'s
    state dict: each split tensor cut into ``n_shards`` equal blocks."""
    out = {}
    for name, part, kind in TP_LAYER_NAMES:
        t = full[f"{parts[part]}.{kind}"]
        dim = tp_split_dim(f"{parts[part]}.{kind}", t.ndim, name)
        if dim is None:
            out[name] = t
        else:
            for j, block in enumerate(t.chunk(n_shards, dim)):
                out[name.format(j=j)] = block
    return out


def gather_layer_state(named: dict, parts: dict, n_shards: int) -> dict:
    """Inverse of ``split_layer_state``: the shards' blocks concatenated in
    shard order on the first shard's device."""
    out = {}
    for name, part, kind in TP_LAYER_NAMES:
        key = f"{parts[part]}.{kind}"
        dim = tp_split_dim(key, named[name.format(j=0)].ndim, name)
        if dim is None:
            out[key] = named[name]
        else:
            blocks = [named[name.format(j=j)] for j in range(n_shards)]
            out[key] = torch.cat([b.to(blocks[0].device) for b in blocks], dim)
    return out
