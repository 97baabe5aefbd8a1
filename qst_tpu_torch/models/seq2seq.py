"""Marian seq2seq with greedy and beam decode — counterpart of
``qst_tpu/models/seq2seq.py``.

The architecture is HF ``MarianMTModel``'s, as in the source: a post-LN
encoder and decoder, sinusoidal positions, one embedding shared by both
stacks and the LM head, a scaled query and a final-logits bias. The
parameter names are HF's (``model.shared.weight``,
``model.encoder.layers.{i}.self_attn.q_proj.weight``, ...,
``final_logits_bias`` of shape (1, V)), so an HF state dict mapped by
``import_marian_params`` loads with ``load_state_dict``. Everything runs in
f32 through ``F.linear`` / ``torch.matmul``: the source computes Marian in
plain XLA, with no Pallas kernel, so the port has no CUDA kernel here.

The decoders run the source's ``lax.fori_loop`` as a Python loop over
positions on one device, with the same arguments, defaults and outputs. A
step reads no host value; every ``EXIT_CHECK_EVERY`` steps one host read
of "every row done" may end the loop early, which leaves the tokens as the
full ``max_length - 1`` steps make them (finished rows only append PAD at
zero cost). Known differences from the source:

- the cached decode's self-attention reads cache slots 0..t only (the
  source attends over all slots with -1e9 beyond t: the same probabilities
  up to summation order); caches are (B, heads, L, head_dim), written in
  place, and the beam search reorders all layers' self-attention caches
  with one ``index_select`` a step;
- ``_top_k`` (``core/meshes.py:top_k``) keeps ``lax.top_k``'s order (descending, the lower index
  first among equal values), which decides the beam slots that masked
  candidates at -1e9 fill;
- ``init_seq2seq`` draws the source's distribution from a
  ``torch.Generator``, not ``jax.random``'s bits;
- token arrays come back as int64 tensors on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qst_tpu_torch.core.device import resolve_device
from qst_tpu_torch.core.meshes import top_k as _top_k

NEG = -1e9
# the decoders read "every row done" once this many steps (0: never) and
# stop there; the tokens are those of the full loop
EXIT_CHECK_EVERY = 16


@dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int = 58101
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    max_position_embeddings: int = 512
    pad_token_id: int = 58100
    eos_token_id: int = 0
    decoder_start_token_id: int = 58100
    scale_embedding: bool = True
    activation: str = "swish"  # Helsinki-NLP checkpoints use swish (silu)
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny(**overrides: Any) -> "Seq2SeqConfig":
        base = dict(vocab_size=100, d_model=32, encoder_layers=2,
                    decoder_layers=2, num_heads=4, ffn_dim=64,
                    max_position_embeddings=64, pad_token_id=99,
                    eos_token_id=0, decoder_start_token_id=99,
                    scale_embedding=False, activation="gelu")
        base.update(overrides)
        return Seq2SeqConfig(**base)


def sinusoidal_positions(n_pos: int, dim: int) -> np.ndarray:
    """HF Marian sinusoidal table: sin block then cos block."""
    pos_enc = np.array(
        [[p / np.power(10000, 2 * (j // 2) / dim) for j in range(dim)]
         for p in range(n_pos)], dtype=np.float32)
    out = np.zeros((n_pos, dim), np.float32)
    sentinel = dim // 2 + dim % 2
    out[:, :sentinel] = np.sin(pos_enc[:, 0::2])
    out[:, sentinel:] = np.cos(pos_enc[:, 1::2])
    return out


def _act(name: str):
    if name in ("swish", "silu"):
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name}")


class MarianAttention(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def _heads(self, x):  # (B, T, D) → (B, nh, T, hd)
        c = self.cfg
        return x.view(*x.shape[:2], c.num_heads, c.d_model // c.num_heads).transpose(1, 2)

    def _query(self, hidden):
        hd = self.cfg.d_model // self.cfg.num_heads
        return self._heads(self.q_proj(hidden) * (hd ** -0.5))

    def _attend(self, q, k, v, bias):
        logits = torch.matmul(q, k.transpose(-1, -2))
        if bias is not None:
            logits = logits + bias
        ctx = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out_proj(ctx.transpose(1, 2).reshape(q.shape[0], q.shape[2], -1))

    def forward(self, hidden, kv, bias):
        k, v = self.project_kv(kv)
        return self._attend(self._query(hidden), k, v, bias)

    def project_kv(self, kv):
        """Precompute (k, v) heads — cross-attention cache entries."""
        return self._heads(self.k_proj(kv)), self._heads(self.v_proj(kv))

    def step(self, hidden_t, k_cache, v_cache, bias):
        """Single-token attention against a cached (B, nh, L, hd) k/v."""
        return self._attend(self._query(hidden_t), k_cache, v_cache, bias)

    def append_kv(self, hidden_t, k_cache, v_cache, t: int):
        """Write this token's k/v into slot t of the caches (in place)."""
        k_new, v_new = self.project_kv(hidden_t)
        k_cache[:, :, t:t + 1] = k_new
        v_cache[:, :, t:t + 1] = v_new
        return k_cache, v_cache


class MarianEncoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attn = MarianAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)

    def forward(self, hidden, bias):
        attn = self.self_attn(hidden, hidden, bias)
        hidden = self.self_attn_layer_norm(hidden + attn)
        ff = self.fc2(_act(self.cfg.activation)(self.fc1(hidden)))
        return self.final_layer_norm(hidden + ff)


class MarianDecoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        self.self_attn = MarianAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.encoder_attn = MarianAttention(cfg)
        self.encoder_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)

    def _ffn(self, hidden):
        ff = self.fc2(_act(self.cfg.activation)(self.fc1(hidden)))
        return self.final_layer_norm(hidden + ff)

    def forward(self, hidden, enc_out, self_bias, cross_bias):
        attn = self.self_attn(hidden, hidden, self_bias)
        hidden = self.self_attn_layer_norm(hidden + attn)
        cross = self.encoder_attn(hidden, enc_out, cross_bias)
        hidden = self.encoder_attn_layer_norm(hidden + cross)
        return self._ffn(hidden)

    def step(self, hidden_t, self_kv, cross_kv, cross_bias, t: int):
        """Single-token step: ``self_kv`` (2, B, nh, L, hd) gets this
        token's k/v in slot t and is attended over slots 0..t;
        ``cross_kv`` (2, B, nh, S, hd) holds the encoder's. → hidden_t."""
        k_c, v_c = self.self_attn.append_kv(hidden_t, self_kv[0], self_kv[1], t)
        attn = self.self_attn.step(hidden_t, k_c[:, :, :t + 1], v_c[:, :, :t + 1], None)
        hidden_t = self.self_attn_layer_norm(hidden_t + attn)
        cross = self.encoder_attn.step(hidden_t, cross_kv[0], cross_kv[1], cross_bias)
        hidden_t = self.encoder_attn_layer_norm(hidden_t + cross)
        return self._ffn(hidden_t)

    def init_cross_cache(self, enc_out):
        return self.encoder_attn.project_kv(enc_out)


class _Stack(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig, layer, n: int):
        super().__init__()
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings, cfg.d_model)
        self.embed_positions.weight.requires_grad_(False)
        self.layers = nn.ModuleList(layer(cfg) for _ in range(n))


class _MarianModel(nn.Module):
    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg, MarianEncoderLayer, cfg.encoder_layers)
        self.decoder = _Stack(cfg, MarianDecoderLayer, cfg.decoder_layers)


def _mask_bias(mask):  # (B, T) → (B, 1, 1, T) additive
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG)


def _suppress_bias(vocab_size: int, suppress_tokens, device=None) -> torch.Tensor:
    """(V,) additive bias: -1e9 at suppressed ids, 0 elsewhere.

    Matches HF's ``bad_words_ids`` / ``NoBadWordsLogitsProcessor`` for
    single-token bad words (real Marian checkpoints ship
    ``bad_words_ids=[[pad_token_id]]``). HF applies the processor AFTER
    ``log_softmax`` in beam search, so the bias is added to log-probs
    without renormalization — as the source does.
    """
    bias = np.zeros((vocab_size,), np.float32)
    for t in suppress_tokens:
        bias[int(t)] = NEG
    return torch.from_numpy(bias).to(device)


def _forced_eos_mask(logp, t: int, max_length: int, eos_id: int):
    """HF ``ForcedEOSTokenLogitsProcessor``: at the final generated slot,
    every non-EOS continuation is -1e9 while EOS keeps its score (the
    source adds 0.0 elsewhere, which changes no value)."""
    if t != max_length - 2:
        return logp
    bias = torch.full((logp.shape[-1],), NEG, dtype=logp.dtype, device=logp.device)
    bias[eos_id] = 0.0
    return logp + bias


def _forced_eos_id(forced_eos, cfg) -> Optional[int]:
    """Resolve the HF ``forced_eos_token_id`` setting: ``False``/``None`` →
    off, ``True`` → ``cfg.eos_token_id`` (the common Marian case), an int →
    that token id — HF allows ``forced_eos_token_id != eos_token_id``, so
    the forced token must come from the checkpoint config, not ``cfg``."""
    if forced_eos is False or forced_eos is None:
        return None
    if forced_eos is True:
        return cfg.eos_token_id
    return int(forced_eos)


class MarianModule(nn.Module):
    """Full encoder-decoder; forward → decoder vocab logits (f32)."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        self.model = _MarianModel(cfg)
        self.register_buffer("final_logits_bias", torch.zeros(1, cfg.vocab_size))

    def _embed(self, ids, positions, start: int = 0):
        c = self.cfg
        scale = float(np.sqrt(c.d_model)) if c.scale_embedding else 1.0
        x = self.model.shared(ids) * scale
        return x + positions.weight[None, start:start + ids.shape[1], :]

    def _logits(self, hidden):  # the LM head, tied to model.shared
        return F.linear(hidden, self.model.shared.weight, self.final_logits_bias[0])

    def encode(self, input_ids, attention_mask):
        hidden = self._embed(input_ids, self.model.encoder.embed_positions)
        bias = _mask_bias(attention_mask)
        for layer in self.model.encoder.layers:
            hidden = layer(hidden, bias)
        return hidden

    def _decode_hidden(self, decoder_ids, decoder_mask, enc_out, enc_mask):
        """The decoder's last hidden state (B, T, D), before the LM head."""
        hidden = self._embed(decoder_ids, self.model.decoder.embed_positions)
        T = decoder_ids.shape[1]
        causal = torch.tril(torch.ones((T, T), device=hidden.device))[None, None]
        pad = decoder_mask[:, None, None, :].float()
        self_bias = torch.where((causal * pad) > 0, 0.0, NEG)
        cross_bias = _mask_bias(enc_mask)
        for layer in self.model.decoder.layers:
            hidden = layer(hidden, enc_out, self_bias, cross_bias)
        return hidden

    def decode(self, decoder_ids, decoder_mask, enc_out, enc_mask):
        return self._logits(self._decode_hidden(decoder_ids, decoder_mask, enc_out, enc_mask))

    def forward(self, input_ids, attention_mask, decoder_ids, decoder_mask):
        enc = self.encode(input_ids, attention_mask)
        return self.decode(decoder_ids, decoder_mask, enc, attention_mask)

    # -- KV-cached single-token decoding (O(L) generation) ------------------
    def init_decode_cache(self, enc_out, max_length: int) -> Dict[str, torch.Tensor]:
        """All layers' caches as two tensors: ``self_kv`` (layers, 2, B, nh,
        max_length, hd), empty, and ``cross_kv`` (layers, 2, B, nh, S, hd),
        the encoder output's projections."""
        c = self.cfg
        B = enc_out.shape[0]
        nh, hd = c.num_heads, c.d_model // c.num_heads
        cross = torch.stack([torch.stack(layer.init_cross_cache(enc_out))
                             for layer in self.model.decoder.layers])
        self_kv = torch.zeros((c.decoder_layers, 2, B, nh, max_length, hd),
                              dtype=enc_out.dtype, device=enc_out.device)
        return {"self_kv": self_kv, "cross_kv": cross}

    def decode_token(self, tok_t, t: int, enc_mask, caches):
        """One decoder step: tok_t (B, 1) at position t → (logits (B, V),
        caches with slot t written)."""
        hidden_t = self._embed(tok_t, self.model.decoder.embed_positions, start=t)
        cross_bias = _mask_bias(enc_mask)
        for i, layer in enumerate(self.model.decoder.layers):
            hidden_t = layer.step(hidden_t, caches["self_kv"][i], caches["cross_kv"][i],
                                  cross_bias, t)
        return self._logits(hidden_t)[:, 0, :], caches


def init_seq2seq(cfg: Seq2SeqConfig, generator: torch.Generator,
                 device: Any = None) -> Dict[str, torch.Tensor]:
    """Random weights of a ``MarianModule`` from ``generator`` (a CPU
    generator), on ``device`` (default: the GPU), from the distribution of
    the source's Flax init: the shared embedding normal(0, 1/√d_model),
    dense kernels lecun-normal (a normal cut at two standard deviations,
    variance 1/fan_in), zero biases and final-logits bias, unit LayerNorm
    scales, the sinusoidal position tables. Drawn in state-dict order."""
    from qst_tpu_torch.models.sentence_encoder import _TRUNCATED_STD

    device = resolve_device(device)
    with torch.device("meta"):
        model = MarianModule(cfg)
    positions = torch.from_numpy(sinusoidal_positions(cfg.max_position_embeddings, cfg.d_model))
    sd = {}
    for name, p in model.state_dict().items():
        if name.endswith("embed_positions.weight"):
            t = positions.clone()
        elif name.endswith("bias"):
            t = torch.zeros(p.shape)
        elif name.endswith("layer_norm.weight"):
            t = torch.ones(p.shape)
        elif name == "model.shared.weight":
            t = torch.normal(0.0, cfg.d_model ** -0.5, p.shape, generator=generator)
        else:          # an nn.Linear weight, (out, in)
            std = p.shape[1] ** -0.5 / _TRUNCATED_STD
            t = torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std, -2 * std, 2 * std,
                                            generator=generator)
        sd[name] = t.to(device)
    return sd


def marian_module(cfg: Seq2SeqConfig, params: Mapping[str, torch.Tensor]) -> MarianModule:
    """A ``MarianModule`` in eval mode that holds ``params``' tensors
    themselves (no copy), on their device."""
    with torch.device("meta"):
        model = MarianModule(cfg)
    model.load_state_dict(params, assign=True)
    return model.eval()


def _setup(params, input_ids, attention_mask, cfg):
    model = marian_module(cfg, params)
    dev = model.final_logits_bias.device
    ids = torch.as_tensor(input_ids).to(dev).long()
    mask = torch.as_tensor(attention_mask).to(dev).long()
    return model, ids, mask


def _stop(t: int, done) -> bool:
    """The loop's one host read, once every EXIT_CHECK_EVERY steps."""
    return bool(EXIT_CHECK_EVERY) and (t + 1) % EXIT_CHECK_EVERY == 0 and bool(done.all())


def _greedy(model, ids, mask, cfg, max_length, suppress_tokens, forced_eos, cached):
    B, dev = ids.shape[0], ids.device
    enc = model.encode(ids, mask)
    caches = model.init_decode_cache(enc, max_length) if cached else None
    sup = _suppress_bias(cfg.vocab_size, suppress_tokens, dev)
    feos = _forced_eos_id(forced_eos, cfg)
    tokens = torch.full((B, max_length), cfg.pad_token_id, dtype=torch.long, device=dev)
    tokens[:, 0] = cfg.decoder_start_token_id
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(max_length - 1):
        if cached:
            logits, caches = model.decode_token(tokens[:, t:t + 1], t, mask, caches)
        else:
            prefix = tokens[:, :t + 1]
            hidden = model._decode_hidden(prefix, torch.ones_like(prefix), enc, mask)
            logits = model._logits(hidden[:, t])
        step = logits + sup[None, :]
        if feos is not None:
            step = _forced_eos_mask(step, t, max_length, feos)
        nxt = torch.where(done, cfg.pad_token_id, step.argmax(dim=-1))
        tokens[:, t + 1] = nxt
        done = done | (nxt == cfg.eos_token_id)
        if _stop(t, done):
            break
    return tokens


def greedy_decode(params, input_ids, attention_mask, cfg: Seq2SeqConfig,
                  max_length: int = 64, suppress_tokens: tuple = (),
                  forced_eos: bool = False) -> torch.Tensor:
    """Greedy generation: → (B, max_length) token ids (decoder-start prefix
    included; pads after EOS), each step re-decoding the prefix.

    ``suppress_tokens`` / ``forced_eos`` mirror HF ``bad_words_ids`` (single
    tokens) and ``forced_eos_token_id`` — real Marian checkpoints use both.
    """
    model, ids, mask = _setup(params, input_ids, attention_mask, cfg)
    with torch.no_grad():
        return _greedy(model, ids, mask, cfg, max_length, suppress_tokens, forced_eos,
                       cached=False)


def greedy_decode_cached(params, input_ids, attention_mask,
                         cfg: Seq2SeqConfig,
                         max_length: int = 64, suppress_tokens: tuple = (),
                         forced_eos: bool = False) -> torch.Tensor:
    """KV-cached greedy generation: one O(1) decoder step per token instead
    of re-running the full prefix; token-identical to :func:`greedy_decode`
    up to summation order."""
    model, ids, mask = _setup(params, input_ids, attention_mask, cfg)
    with torch.no_grad():
        return _greedy(model, ids, mask, cfg, max_length, suppress_tokens, forced_eos,
                       cached=True)


def _beam(model, ids, mask, cfg, max_length, num_beams, length_penalty, suppress_tokens,
          forced_eos, cached):
    B, dev = ids.shape[0], ids.device
    V, K = cfg.vocab_size, num_beams
    enc = model.encode(ids, mask)
    # expand the encoder state per beam: (B*K, S, D)
    enc_k = enc.repeat_interleave(K, dim=0)
    mask_k = mask.repeat_interleave(K, dim=0)
    caches = model.init_decode_cache(enc_k, max_length) if cached else None
    sup = _suppress_bias(V, suppress_tokens, dev)
    feos = _forced_eos_id(forced_eos, cfg)
    # finished beams may only extend with PAD at zero cost
    pad_only = torch.full((V,), NEG, device=dev)
    pad_only[cfg.pad_token_id] = 0.0
    rows = torch.arange(B, device=dev)[:, None] * K

    tokens = torch.full((B, K, max_length), cfg.pad_token_id, dtype=torch.long, device=dev)
    tokens[:, :, 0] = cfg.decoder_start_token_id
    # beam 0 active, others start at -1e9 so step 1 fans out from beam 0
    scores = torch.tensor([0.0] + [NEG] * (K - 1), device=dev).repeat(B, 1)
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.ones((B, K), dtype=torch.long, device=dev)  # generated-token counts
    for t in range(max_length - 1):
        flat_tokens = tokens.view(B * K, max_length)
        if cached:
            logits, caches = model.decode_token(flat_tokens[:, t:t + 1], t, mask_k, caches)
        else:
            prefix = flat_tokens[:, :t + 1]
            hidden = model._decode_hidden(prefix, torch.ones_like(prefix), enc_k, mask_k)
            logits = model._logits(hidden[:, t])
        logp = torch.log_softmax(logits.float(), dim=-1) + sup[None, :]
        if feos is not None:
            logp = _forced_eos_mask(logp, t, max_length, feos)
        logp = torch.where(done[:, :, None], pad_only, logp.view(B, K, V))

        top_s, top_i = _top_k((scores[:, :, None] + logp).view(B, K * V), K)
        beam_idx = top_i // V
        tok_idx = top_i % V
        tokens = tokens.gather(1, beam_idx[:, :, None].expand(B, K, max_length))
        done = done.gather(1, beam_idx)
        lengths = lengths.gather(1, beam_idx)
        if cached:
            # the self-attention caches follow the surviving beams
            caches["self_kv"] = caches["self_kv"].index_select(2, (rows + beam_idx).view(-1))
        tokens[:, :, t + 1] = torch.where(done, cfg.pad_token_id, tok_idx)
        lengths = torch.where(done, lengths, lengths + 1)
        done = done | (tok_idx == cfg.eos_token_id)
        scores = top_s
        if _stop(t, done):
            break
    final = scores / lengths.float().pow(length_penalty)
    best = final.argmax(dim=1)
    return tokens[torch.arange(B, device=dev), best]


def beam_decode(params, input_ids, attention_mask, cfg: Seq2SeqConfig,
                max_length: int = 64, num_beams: int = 4,
                length_penalty: float = 1.0, suppress_tokens: tuple = (),
                forced_eos: bool = False) -> torch.Tensor:
    """Beam-search generation: → (B, max_length) best beam.

    Sequence beam search with the simple length penalty ``score /
    len^alpha`` applied at finalization; finished beams (emitted EOS) hold
    their score and emit only PAD afterwards. Each step re-decodes the
    prefix of every beam.
    """
    model, ids, mask = _setup(params, input_ids, attention_mask, cfg)
    with torch.no_grad():
        return _beam(model, ids, mask, cfg, max_length, num_beams, length_penalty,
                     suppress_tokens, forced_eos, cached=False)


def beam_decode_cached(params, input_ids, attention_mask, cfg: Seq2SeqConfig,
                       max_length: int = 64, num_beams: int = 4,
                       length_penalty: float = 1.0,
                       suppress_tokens: tuple = (),
                       forced_eos: bool = False) -> torch.Tensor:
    """KV-cached beam search: O(1) decoder work per (beam, token); beam
    reordering gathers the self-attention caches along the beam axis.
    Token-identical to :func:`beam_decode` up to summation order."""
    model, ids, mask = _setup(params, input_ids, attention_mask, cfg)
    with torch.no_grad():
        return _beam(model, ids, mask, cfg, max_length, num_beams, length_penalty,
                     suppress_tokens, forced_eos, cached=True)


# ---------------------------------------------------------------------------
# HF MarianMTModel import
# ---------------------------------------------------------------------------

def import_marian_params(state_dict: Mapping[str, Any],
                         cfg: Seq2SeqConfig) -> Dict[str, torch.Tensor]:
    """An HF ``MarianMTModel`` state dict (tensors or arrays) → the port's
    state dict, float32 on the CPU. The tied embedding may sit under any of
    its names, the position tables may be missing (deterministic sinusoids:
    recomputed) and so may ``final_logits_bias`` (zeros), as the source
    allows; both stacks get the one position table the source keeps."""
    def _t(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().float().clone()
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def first(*keys):
        for k in keys:
            if k in state_dict:
                return _t(state_dict[k])
        return None

    shared = first("model.shared.weight", "model.encoder.embed_tokens.weight",
                   "model.decoder.embed_tokens.weight", "lm_head.weight")
    if shared is None:
        raise KeyError("no shared-embedding weight in Marian state dict")
    positions = first("model.encoder.embed_positions.weight",
                      "model.decoder.embed_positions.weight")
    if positions is None:  # deterministic sinusoids — recompute
        positions = _t(sinusoidal_positions(cfg.max_position_embeddings, cfg.d_model))
    positions = positions[: cfg.max_position_embeddings]
    bias = first("final_logits_bias")
    if bias is None:
        bias = torch.zeros(cfg.vocab_size)
    sd = {"model.shared.weight": shared,
          "model.encoder.embed_positions.weight": positions,
          "model.decoder.embed_positions.weight": positions.clone(),
          "final_logits_bias": bias.reshape(1, -1)}
    with torch.device("meta"):
        names = MarianModule(cfg).state_dict()
    for name in names:
        if name not in sd:
            sd[name] = _t(state_dict[name])
    return sd


class JaxBacktranslator:
    """en→fr→en roundtrip on the port's seq2seq, by greedy cached decode
    (the source's name, kept).

    tokenizers must provide ``batch_encode(texts, max_length) -> (ids, mask)``
    and ``decode(ids) -> str``; models are (cfg, params) pairs, the params
    on the device to run on.
    """

    def __init__(self, fwd: Tuple[Seq2SeqConfig, Any], bwd, tok_fwd, tok_bwd,
                 max_length: int = 64):
        self.fwd_cfg, self.fwd_params = fwd
        self.bwd_cfg, self.bwd_params = bwd
        self.tok_fwd, self.tok_bwd = tok_fwd, tok_bwd
        self.max_length = max_length

    def _translate(self, texts, cfg, params, tok):
        ids, mask = tok.batch_encode(list(texts), max_length=self.max_length)
        out = greedy_decode_cached(params, np.asarray(ids), np.asarray(mask), cfg,
                                   self.max_length)
        out = out.cpu().numpy()
        results = []
        for row in out:
            toks = []
            for t in row[1:]:  # skip decoder-start
                if t == cfg.eos_token_id or t == cfg.pad_token_id:
                    break
                toks.append(int(t))
            results.append(tok.decode(toks))
        return results

    def backtranslate(self, texts):
        fr = self._translate(texts, self.fwd_cfg, self.fwd_params, self.tok_fwd)
        return self._translate(fr, self.bwd_cfg, self.bwd_params, self.tok_bwd)

