"""Pipeline parallelism (GPipe and the circular schedule) over a ``pipe``
mesh axis — counterpart of ``qst_tpu/parallel/pipeline.py``.

The encoder trunk's layers are split into stages, one a position of the
mesh's ``pipe`` axis; microbatches stream through the stages, each
microbatch's rows split over the ``data`` axis (``make_pipe_mesh``).

- ``PipelineEncoder``: the trainable model — BERT embeddings and ``n_stages``
  stages of ``nn.Module`` layers (``BertLayer``, as the JAX pipeline runs
  Flax's), stage p's on its pipe position's device. With ``n_rounds`` v > 1
  (the circular schedule) stage p holds its v chunks back to back: slot
  r·pc + i is layer (r·S + p)·pc + i, pc = L/(S·v) (``_chunk_layers``).
- ``stack_stage_params`` / ``unstack_stage_params``: an HF state dict's
  layers ⇄ the stacked layout, every layer tensor with leading
  (n_stages, L/n_stages) axes — what a pipeline checkpoint holds
  (``PipelineLayout``).
- ``make_pp_embed_fn``: the fill-drain schedule, kept exactly: at tick t
  stage p runs round (t − p) div M of microbatch (t − p) mod M; bubble
  ticks compute nothing; activations go stage to stage with ``.to`` the
  next stage's device; with v > 1 the last stage's output wraps back to
  stage 0 through a per-microbatch bank, read at its next-round slot (hence
  M ≥ S). Only the last stage's final-round outputs are real. Autograd
  through the schedule is the backward.
- Dropout: layer l of microbatch m on data shard d draws from the step's key
  folded with d, then m (``ops/fused_layer.py:fold_key``), at global layer
  l (``models/bert.py:DeviceDropout``); the embeddings from the unfolded
  key at layer ``num_layers`` — the JAX pipeline's streams, drawn on the
  device. ``key=None`` is the deterministic forward.
- ``make_pp_train_step``: the quadruplet step with the trunk pipelined; the
  loss through K3 with ``use_fused_kernel``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.core.meshes import DATA_AXIS, PIPE_AXIS, Mesh, make_pipe_mesh

__all__ = ["PIPE_AXIS", "make_pipe_mesh", "PipelineEncoder", "PipelineLayout",
           "stack_stage_params", "unstack_stage_params", "make_pp_embed_fn",
           "pp_params_from_encoder", "make_pp_train_step"]


def _chunk_layers(num_layers: int, n_stages: int, n_rounds: int) -> List[List[int]]:
    """Layer ids of chunk ``c`` (stage c % S, round c // S): the circular
    assignment [c·pc, (c+1)·pc) with pc = L/(S·v)."""
    if num_layers % (n_stages * n_rounds) != 0:
        raise ValueError(
            f"{num_layers} layers not divisible by {n_stages} stages × {n_rounds} rounds")
    pc = num_layers // (n_stages * n_rounds)
    return [list(range(c * pc, (c + 1) * pc)) for c in range(n_stages * n_rounds)]


def _stage_layers(num_layers: int, n_stages: int, n_rounds: int) -> List[List[int]]:
    """The global layer of each slot of each stage."""
    chunks = _chunk_layers(num_layers, n_stages, n_rounds)
    return [[li for r in range(n_rounds) for li in chunks[r * n_stages + s]]
            for s in range(n_stages)]


_LAYER = re.compile(r"^encoder\.layer\.(\d+)\.(.+)$")


def stack_stage_params(encoder_params: Mapping[str, torch.Tensor], num_layers: int,
                       n_stages: int, n_rounds: int = 1) -> Dict[str, torch.Tensor]:
    """{"encoder.layer.{l}.{name}": t} → {name: tensor with leading
    (n_stages, L/n_stages) axes}: stage p's row holds its slots (with v > 1
    its v chunks back to back), so the shapes are the same for every v."""
    rows = _stage_layers(num_layers, n_stages, n_rounds)
    names = sorted({m.group(2) for m in map(_LAYER.match, encoder_params) if m})
    return {n: torch.stack([torch.stack([encoder_params[f"encoder.layer.{li}.{n}"]
                                         for li in row]) for row in rows]) for n in names}


def unstack_stage_params(stage_params: Mapping[str, torch.Tensor], num_layers: int,
                         n_rounds: int = 1) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_stage_params`."""
    first = next(iter(stage_params.values()))
    n_stages, per = first.shape[0], first.shape[1]
    if n_stages * per != num_layers:
        raise ValueError("stage stack does not match num_layers")
    rows = _stage_layers(num_layers, n_stages, n_rounds)
    return {f"encoder.layer.{li}.{n}": t[s, slot] for n, t in stage_params.items()
            for s, row in enumerate(rows) for slot, li in enumerate(row)}


class _Stage(nn.Module):
    def __init__(self, cfg: EncoderConfig, per: int):
        super().__init__()
        from qst_tpu_torch.models.bert import BertLayer

        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(per))


class PipelineEncoder(nn.Module):
    """BERT's embeddings and ``n_stages`` stages of ``BertLayer`` slots (the
    JAX package's {"embeddings", "stages"} params). Its state dict names
    are ``embeddings.*`` and ``stages.{p}.layer.{slot}.*``."""

    def __init__(self, cfg: EncoderConfig, n_stages: int, n_rounds: int = 1):
        super().__init__()
        if cfg.arch != "bert":
            raise ValueError(f"the pipeline runs BERT layers, as the JAX package's does; "
                             f"arch {cfg.arch!r} given")
        from qst_tpu_torch.models.bert import BertEmbeddings

        _chunk_layers(cfg.num_layers, n_stages, n_rounds)
        self.cfg, self.n_stages, self.n_rounds = cfg, n_stages, n_rounds
        self.embeddings = BertEmbeddings(cfg)
        self.stages = nn.ModuleList(_Stage(cfg, cfg.num_layers // n_stages)
                                    for _ in range(n_stages))


class PipelineLayout:
    """A ``PipelineEncoder``'s tensors against a checkpoint's: ``export``
    stacks {"stages.{p}.layer.{slot}.{name}"} into {"stages.{name}": (S,
    per, ...)} (``stack_stage_params``' layout; ``embeddings.*`` as they
    are), ``import_`` unstacks, ``flat`` gives a plain
    ``SentenceEncoderModule``'s names (``encoder.layer.{l}.*``)."""

    kind = "pipeline"

    def __init__(self, cfg: EncoderConfig, n_stages: int, n_rounds: int = 1):
        self.cfg, self.n_stages, self.n_rounds = cfg, n_stages, n_rounds
        self.rows = _stage_layers(cfg.num_layers, n_stages, n_rounds)

    _SLOT = re.compile(r"^stages\.(\d+)\.layer\.(\d+)\.(.+)$")

    def _split(self, named):
        other, slots = {}, {}
        for n, t in named.items():
            m = self._SLOT.match(n)
            if m is None:
                other[n] = t
            else:
                slots[(int(m.group(1)), int(m.group(2)), m.group(3))] = t
        return other, slots

    def flat(self, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        other, slots = self._split(named)
        return {**other, **{f"encoder.layer.{self.rows[p][s]}.{n}": t
                            for (p, s, n), t in slots.items()}}

    def export(self, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        other, slots = self._split(named)
        names = sorted({n for (_, _, n) in slots})
        per = len(self.rows[0])
        home = next(iter(named.values())).device if named else None
        return {**other, **{f"stages.{n}": torch.stack([torch.stack(
            [slots[(p, s, n)].to(home) for s in range(per)]) for p in range(self.n_stages)])
            for n in names}}

    def import_(self, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for n, t in sd.items():
            if not n.startswith("stages."):
                out[n] = t
                continue
            for p in range(t.shape[0]):
                for s in range(t.shape[1]):
                    out[f"stages.{p}.layer.{s}.{n[len('stages.'):]}"] = t[p, s]
        return out


def pp_params_from_encoder(encoder_params: Mapping[str, torch.Tensor], cfg: EncoderConfig,
                           n_stages: int, mesh: Optional[Mesh] = None,
                           n_rounds: int = 1) -> PipelineEncoder:
    """A flat ``SentenceEncoderModule`` state dict → the ``PipelineEncoder``
    holding copies of its tensors (never views of the caller's), stage p on
    the mesh's p-th pipe device and the embeddings on the first (without a
    mesh: all on the tensors' own device)."""
    rows = _stage_layers(cfg.num_layers, n_stages, n_rounds)
    if mesh is not None:
        devices = mesh.axis_devices(PIPE_AXIS)[:n_stages]
    else:
        devices = [next(iter(encoder_params.values())).device] * n_stages
    with torch.device("meta"):
        model = PipelineEncoder(cfg, n_stages, n_rounds)
    model = model.to_empty(device=devices[0])
    sd = {n: t for n, t in encoder_params.items() if n.startswith("embeddings.")}
    for p, row in enumerate(rows):
        for slot, li in enumerate(row):
            prefix = f"encoder.layer.{li}."
            sd.update({f"stages.{p}.layer.{slot}.{n[len(prefix):]}": t
                       for n, t in encoder_params.items() if n.startswith(prefix)})
    model.load_state_dict({n: t.detach() for n, t in sd.items()})
    for p, dev in enumerate(devices):
        model.stages[p].to(dev)
    return model


def make_pp_embed_fn(cfg: EncoderConfig, mesh: Mesh, n_stages: int, n_microbatches: int,
                     n_rounds: int = 1) -> Callable:
    """→ ``fn(model, input_ids, attention_mask, key=None) → (B, D)``: the
    ``PipelineEncoder``'s embeddings with its trunk run through the
    schedule over the mesh's pipe axis and each microbatch's rows split
    over its data axis. B must divide by ``n_microbatches`` and each
    microbatch by the data axis. ``key`` (seed, step): the configured
    dropout, drawn on the device; None: the deterministic forward."""
    from qst_tpu_torch.models.bert import MASK_BIAS, DeviceDropout
    from qst_tpu_torch.ops.distances import l2_normalize
    from qst_tpu_torch.ops.fused_layer import fold_key
    from qst_tpu_torch.ops.pooling import POOLERS
    from qst_tpu_torch.parallel.sharding import (
        device_context,
        replicas,
        run_with,
    )

    if PIPE_AXIS not in mesh.shape:
        raise ValueError("mesh needs a 'pipe' axis")
    if mesh.shape[PIPE_AXIS] != n_stages:
        raise ValueError(f"mesh pipe={mesh.shape[PIPE_AXIS]} != n_stages={n_stages}")
    rows = _stage_layers(cfg.num_layers, n_stages, n_rounds)   # divisibility
    if n_rounds > 1 and n_microbatches < n_stages:
        raise ValueError(
            f"the circular schedule needs n_microbatches >= n_stages (wrapped activations "
            f"must arrive before their next-round slot), got {n_microbatches} < {n_stages}")
    stochastic = cfg.hidden_dropout > 0 or cfg.attention_dropout > 0
    M, Pn, V = n_microbatches, n_stages, n_rounds
    pc = cfg.num_layers // (Pn * V)
    n_data = mesh.shape.get(DATA_AXIS, 1)

    def trunk(model, d, hidden, bias, mask, key):
        """Data shard ``d``'s M microbatches (lists) through the schedule →
        the last stage's final-round outputs, in microbatch order."""
        devs = [mesh.device_at(**{PIPE_AXIS: p, DATA_AXIS: d}) for p in range(Pn)]
        keys = [None if key is None else fold_key(key, m) for m in range(M)]

        def apply_chunk(p, rr, x, m):
            x = x.to(devs[p])
            with device_context(devs[p]):
                for i in range(pc):
                    layer = model.stages[p].layer[rr * pc + i]
                    gen = None if keys[m] is None else DeviceDropout(
                        keys[m].to(devs[p]), rows[p][rr * pc + i])
                    x = layer(x, bias[m].to(devs[p]), gen, mask[m].to(devs[p]))
            return x

        buf: List[Optional[torch.Tensor]] = [None] * Pn
        wrap: List[Optional[torch.Tensor]] = [None] * M
        outs: List[Optional[torch.Tensor]] = [None] * M
        for t in range(V * M + Pn - 1):
            sent: List[Optional[torch.Tensor]] = [None] * Pn
            for p in range(Pn):
                tp = t - p                      # this stage's schedule position
                if not 0 <= tp < V * M:
                    continue                    # a bubble tick computes nothing
                rr, mc = divmod(tp, M)
                x = (hidden[mc] if rr == 0 else wrap[mc]) if p == 0 else buf[p]
                y = apply_chunk(p, rr, x, mc)
                if p < Pn - 1:
                    sent[p + 1] = y.to(devs[p + 1])
                elif rr == V - 1:
                    outs[mc] = y
                else:                           # the wrap: banked until round rr + 1
                    wrap[mc] = y.to(devs[0])
            buf = sent
        return outs

    def fn(model, input_ids, attention_mask, key=None):
        B, S = input_ids.shape
        if B % M != 0:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mb = B // M
        if mb % n_data != 0:
            raise ValueError(f"a microbatch of {mb} rows does not split over {n_data} "
                             "data shards")
        stoch = key is not None and stochastic
        home = model.embeddings.word_embeddings.weight.device
        ids, mask = input_ids.to(home).long(), attention_mask.to(home)
        key = key.to(home) if stoch else None
        positions = torch.arange(S, device=home)[None, :]
        hidden = model.embeddings(ids, torch.zeros_like(ids), positions,
                                  None if key is None else DeviceDropout(key, cfg.num_layers))
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, MASK_BIAS).float()
        local = mb // n_data

        def shard_rows(t, d):           # data shard d's rows of each microbatch
            return [t[m * mb + d * local:m * mb + (d + 1) * local] for m in range(M)]

        if n_data == 1:
            outs = [trunk(model, 0, shard_rows(hidden, 0), shard_rows(bias, 0),
                          shard_rows(mask, 0), None if key is None else fold_key(key, 0))]
        else:
            # each data shard's stage weights: copies whose gradients are
            # summed in data-index order (parallel/sharding.py Replicate)
            def device_of(name, d):
                m = re.match(r"stages\.(\d+)\.", name)
                return mesh.device_at(**{PIPE_AXIS: int(m.group(1)) if m else 0, DATA_AXIS: d})

            copies = replicas(model, mesh, n_data, device_of)
            outs = [run_with(model, trunk, copies[d], d, shard_rows(hidden, d),
                             shard_rows(bias, d), shard_rows(mask, d),
                             None if key is None else fold_key(key, d))
                    for d in range(n_data)]
        last = torch.cat([outs[d][m].to(home) for m in range(M) for d in range(n_data)])
        pooled = POOLERS[cfg.pooling](last, mask)
        return l2_normalize(pooled) if cfg.normalize else pooled

    return fn


def make_pp_train_step(cfg: EncoderConfig, loss_cfg, optimizer, mesh: Mesh, n_stages: int,
                       n_microbatches: int, n_rounds: int = 1) -> Callable:
    """→ ``step(state, input_ids (4, B, S), attention_mask, key=None) →
    (state, loss)`` with ``state.model`` a ``PipelineEncoder``: forward
    through the schedule, the loss (``loss_from_config``: K3 with
    ``use_fused_kernel``), backward and one optimizer call (``optimizer``,
    default the state's). With dropout in the config, ``key`` draws it."""
    from qst_tpu_torch.train.train_step import loss_from_config

    fwd = make_pp_embed_fn(cfg, mesh, n_stages, n_microbatches, n_rounds)
    loss_fn = loss_from_config(loss_cfg)

    def step(state, input_ids, attention_mask, key=None):
        opt = optimizer if optimizer is not None else state.optimizer
        home = state.model.embeddings.word_embeddings.weight.device
        ids = torch.as_tensor(input_ids).to(device=home, dtype=torch.int64)
        mask = torch.as_tensor(attention_mask).to(device=home, dtype=torch.int64)
        four, B, S = ids.shape
        state.model.train()
        emb = fwd(state.model, ids.reshape(four * B, S), mask.reshape(four * B, S),
                  key).reshape(four, B, -1)
        loss = loss_fn(*emb.unbind(0))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.apply_row(torch.tensor(opt.next_row(), dtype=torch.float32).to(home))
        state.step += 1
        return state, loss.detach()

    return step
