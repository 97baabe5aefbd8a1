"""The quadruplet train step — counterpart of ``qst_tpu/train/train_step.py``.

- The collator stacks the four roles into one (4·B, S) batch and the step
  runs ONE encoder forward: through the fused layer (K1 forward, K2
  backward, in-kernel dropout) with ``EncoderConfig.use_fused_layer``, else
  through the ``nn.Module`` path with its dropout.
- ``loss_from_config`` routes the loss: the γ loss through K3 with
  ``LossConfig.use_fused_kernel``, else the plain losses of ``ops/losses.py``.
- ``ClippedAdamW`` is the JAX package's optax chain written out:
  ``clip_by_global_norm`` → ``adamw`` on the schedule → ``MultiSteps`` for
  gradient accumulation, with optax's order of operations (see its
  docstring). ``TrainState`` holds step, model, optimizer and the pair
  discriminator of the d-regularized loss.
- A step's dropout is drawn from its key (seed, step), as JAX folds the step
  into its key, on the device: on the fused path by
  ``ops/fused_layer.py:step_draws``, on the ``nn.Module`` path by
  ``models/bert.py:DeviceDropout`` — no host value, no generator state.
- ``make_multi_step`` runs ``n_steps`` steps per call, as the JAX package's
  ``lax.scan`` does. On the GPU the K steps are one CUDA graph — forward,
  loss, backward, clip and AdamW, captured once and replayed with one launch
  per call — which takes the host's launch time out of the step; on the
  CPU they run one after another.
- ``mesh`` (a ``core/meshes.py`` (data, model) mesh): each data shard runs
  the encoder on its block of rows (K1 forward and K2 backward on the fused
  path), its dropout key folded with its data index, and the parameters'
  gradients come back summed in data-index order
  (``parallel/sharding.py:data_parallel``); the loss (K3 with
  ``use_fused_kernel``) runs once on the gathered embeddings, as in the
  JAX package, where ``shard_map`` wraps only the encoder. A model axis > 1
  takes ``create_train_state_sharded``'s tensor-parallel state; the global
  norm of the clip then counts each slice and each replicated tensor once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from qst_tpu_torch.core.config import EncoderConfig, LossConfig, TrainConfig
from qst_tpu_torch.core.device import resolve_device
from qst_tpu_torch.core.meshes import DATA_AXIS, sharded
from qst_tpu_torch.kernels import build
from qst_tpu_torch.models.discriminator import PairDiscriminator, init_discriminator
from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule, init_params
from qst_tpu_torch.ops.losses import (
    d_regularized_quadruplet_loss,
    gamma_quadruplet_loss,
    triplet_margin_loss,
)
from qst_tpu_torch.train.schedules import Schedule, get_schedule


def dropout_key(seed: int, step: int) -> torch.Tensor:
    """The dropout key of train step ``step`` (1-based, as JAX's
    ``fold_in(rng, global_step + 1)``) of a run seeded ``seed``: (seed,
    step) as an int64 tensor on the CPU."""
    return torch.tensor([seed, step], dtype=torch.int64)


def encoder_apply_fn(encoder_cfg: EncoderConfig, mesh: Any = None) -> Callable:
    """→ ``fn(model, flat_ids, flat_mask, dropout_key) → (N, D)`` — the
    trainable 4-role encoder forward; ``dropout_key`` is None (no dropout)
    or (seed, step) (``dropout_key()``). With ``use_fused_layer`` the trunk
    runs through ``FusedBertLayer`` (K1 forward with in-kernel dropout, K2
    backward), its draws derived from the key on the device; otherwise
    through the modules, whose dropout is active in train() mode and drawn
    on the device from the key (``DeviceDropout``).

    ``mesh`` with a data axis > 1: the forward runs data-parallel
    (``parallel/sharding.py:data_parallel``): each data shard's rows on its
    devices, its key folded with its data index (JAX ``fold_in``, dropout
    iid across shards), the gradients summed in data-index order."""
    from qst_tpu_torch.models.bert import DeviceDropout

    if encoder_cfg.use_fused_layer:
        from qst_tpu_torch.ops.fused_layer import fused_embed_fn

        fwd = fused_embed_fn(encoder_cfg, differentiable=True, with_dropout=True)

        def base(model, ids, mask, key):
            return fwd(model, ids, mask, key)
    else:
        def base(model, ids, mask, key):
            return model(ids, mask, dropout_generator=None if key is None
                         else DeviceDropout(key.to(ids.device)))["sentence_embedding"]
    mesh = sharded(mesh)
    if mesh is None or mesh.shape.get(DATA_AXIS, 1) == 1:
        return base
    from qst_tpu_torch.parallel.sharding import data_parallel

    return data_parallel(base, mesh)


def loss_from_config(loss_cfg: LossConfig,
                     discr_apply: Optional[Callable] = None) -> Callable:
    """→ ``loss(a, pos, part, neg) -> scalar`` for the configured kind:
    "gamma", "d_regularized" (needs ``discr_apply``) or "triplet" (the
    (anchor, pos, neg) hinge that ignores the part-positive role)."""
    if loss_cfg.kind == "d_regularized":
        if discr_apply is None:
            raise ValueError("d_regularized loss needs discr_apply")

        def loss(a, pos, part, neg):
            return d_regularized_quadruplet_loss(
                a, pos, part, neg, margin_pos_neg=loss_cfg.margin_pos_neg,
                margin_part_neg=loss_cfg.margin_part_neg, lmbd=loss_cfg.lmbd,
                discr=discr_apply, p=loss_cfg.p, swap=loss_cfg.swap, reduction="mean")
    elif loss_cfg.kind == "triplet":
        def loss(a, pos, part, neg):
            del part
            return triplet_margin_loss(a, pos, neg, margin=loss_cfg.margin_pos_neg,
                                       p=loss_cfg.p, swap=loss_cfg.swap).mean()
    elif loss_cfg.use_fused_kernel:
        from qst_tpu_torch.ops.quadruplet import fused_gamma_quadruplet_loss

        def loss(a, pos, part, neg):
            return fused_gamma_quadruplet_loss(
                a, pos, part, neg, loss_cfg.gamma, loss_cfg.margin_pos_neg,
                loss_cfg.margin_pos_part, loss_cfg.margin_part_neg, "mean")
    else:
        def loss(a, pos, part, neg):
            return gamma_quadruplet_loss(
                a, pos, part, neg, gamma=loss_cfg.gamma,
                margin_pos_neg=loss_cfg.margin_pos_neg,
                margin_pos_part=loss_cfg.margin_pos_part,
                margin_part_neg=loss_cfg.margin_part_neg,
                p=loss_cfg.p, swap=loss_cfg.swap, reduction="mean")
    return loss


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: g · max_norm/‖g‖ over the global norm
    of all ``grads``, only when ‖g‖ ≥ max_norm (torch's ``clip_grad_norm_``
    scales by max_norm/(‖g‖ + 1e-6) whenever that is below 1). No host
    synchronisation: the choice is made on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(grads, factor)


class ClippedAdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    weight_decay, b1, b2, eps))``, inside ``optax.MultiSteps`` when
    ``accumulation_steps`` > 1 (``make_optimizer``, train_step.py:155-170),
    in optax's order:

    - accumulation: the running mean acc + (g − acc)/(n + 1) of the
      micro-batch gradients; only every ``accumulation_steps``-th call
      updates, with the mean — clipped after averaging, not per micro-batch;
    - clipping: ``clip_by_global_norm``, over every parameter;
    - AdamW: m, v moments, bias-corrected; the update
      m̂/(√v̂ + eps) + weight_decay·p is scaled by −lr(count) with the
      schedule read at the count before this update, and weight decay acts
      on every parameter, biases and LayerNorm included.

    A parameter without a gradient counts as a zero gradient (JAX always
    has one). Counters live in the param group, so ``state_dict`` carries
    them across a checkpoint.

    The host keeps the counters; the device reads nothing else of the
    host's. ``next_row`` advances them by one micro-batch and gives its row
    (lr, the two f32 bias corrections, n + 1, update or not); ``apply_row``
    applies a row that lies on the device, so a captured step replays with
    new rows written into its buffer. With accumulation both branches are
    computed and the device selects, as ``optax.MultiSteps`` does, so any
    number of steps per call works with any ``accumulation_steps``.
    ``step()`` is the two in one."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule, *,
                 max_grad_norm: float, weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, accumulation_steps: int = 1):
        if accumulation_steps < 1:
            raise ValueError(f"accumulation_steps must be >= 1, {accumulation_steps} given")
        defaults = dict(max_grad_norm=max_grad_norm, weight_decay=weight_decay, b1=b1, b2=b2,
                        eps=eps, accumulation_steps=accumulation_steps, count=0,
                        mini_step=0)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("ClippedAdamW takes one parameter group")
        self.schedule = schedule

    def _state(self, p: torch.Tensor, name: str) -> torch.Tensor:
        st = self.state[p]
        if name not in st:
            st[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return st[name]

    def init_state(self) -> None:
        """Allocate the moments (and the accumulator) now, not at the first
        update: a captured step must find them."""
        group = self.param_groups[0]
        for p in group["params"]:
            self._state(p, "mu")
            self._state(p, "nu")
            if group["accumulation_steps"] > 1:
                self._state(p, "acc")

    def state_tensors(self) -> List[torch.Tensor]:
        """The parameters and every state tensor, in a fixed order."""
        return [t for p in self.param_groups[0]["params"]
                for t in (p, *(self.state[p][n] for n in ("mu", "nu", "acc")
                               if n in self.state[p]))]

    def next_row(self) -> Tuple[float, float, float, float, float]:
        """Advance the counters by one micro-batch → its row (lr, bc1, bc2,
        n + 1, 1.0 if the parameters move else 0.0): lr read at the count
        before the update, the bias corrections 1 − b**count in float32 as
        optax computes them, n the micro-batch's place in its accumulation."""
        group = self.param_groups[0]
        k, n, count = group["accumulation_steps"], group["mini_step"], group["count"]
        group["mini_step"] = (n + 1) % k
        moves = n + 1 == k
        if moves:
            group["count"] = count + 1
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(count + 1))
                    for b in (group["b1"], group["b2"]))
        return (float(self.schedule(count)), bc1, bc2, float(n + 1), float(moves))

    @torch.no_grad()
    def apply_row(self, row: torch.Tensor) -> None:
        """One micro-batch's update given its row (``next_row``) as a (5,)
        float32 tensor on the parameters' device; reads no host value."""
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        moves = None          # without accumulation every micro-batch moves
        if group["accumulation_steps"] > 1:
            accs = [self._state(p, "acc") for p in params]
            torch._foreach_add_(accs, torch._foreach_div(torch._foreach_sub(grads, accs), row[3]))
            grads, moves = accs, row[4] > 0
        grads = clip_by_global_norm(grads, group["max_grad_norm"])
        b1, b2 = group["b1"], group["b2"]
        mus = [self._state(p, "mu") for p in params]
        nus = [self._state(p, "nu") for p in params]
        if moves is None:
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            new_mus, new_nus = mus, nus
        else:                 # both branches, selected below
            new_mus = torch._foreach_add(torch._foreach_mul(mus, b1), grads, alpha=1 - b1)
            new_nus = torch._foreach_addcmul(torch._foreach_mul(nus, b2), grads, grads,
                                             value=1 - b2)
        mu_hat = torch._foreach_div(new_mus, row[1])
        nu_hat = torch._foreach_div(new_nus, row[2])
        update = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat),
                                                               group["eps"]))
        if group["weight_decay"]:
            torch._foreach_add_(update, params, alpha=group["weight_decay"])
        torch._foreach_mul_(update, torch.neg(row[0]))
        if moves is None:
            torch._foreach_add_(params, update)
            return
        new_params = torch._foreach_add(params, update)
        for old, new in zip(mus + nus + params, new_mus + new_nus + new_params):
            old.copy_(torch.where(moves, new, old))
        for a in accs:
            a.masked_fill_(moves, 0.0)

    @torch.no_grad()
    def step(self, closure=None) -> bool:
        """One call per micro-batch; → True when the parameters moved."""
        if closure is not None:
            raise ValueError("ClippedAdamW takes no closure")
        row = self.next_row()
        device = self.param_groups[0]["params"][0].device
        self.apply_row(torch.tensor(row, dtype=torch.float32).to(device))
        return bool(row[4])


def make_optimizer(train_cfg: TrainConfig, total_steps: int,
                   params: Iterable[torch.Tensor]) -> ClippedAdamW:
    schedule = get_schedule(train_cfg.scheduler, train_cfg.learning_rate,
                            train_cfg.warmup_steps, total_steps)
    return ClippedAdamW(params, schedule, max_grad_norm=train_cfg.max_grad_norm,
                        weight_decay=train_cfg.weight_decay, b1=0.9, b2=0.999, eps=1e-8,
                        accumulation_steps=getattr(train_cfg, "gradient_accumulation_steps", 1))


@dataclass
class TrainState:
    """``layout``: None for a plain model; for a tensor-parallel or a
    pipeline model (``parallel/sharding.py:TensorParallelLayout``,
    ``parallel/pipeline.py:PipelineLayout``) it maps the model's tensors
    to what a checkpoint holds — gathered HF names, or the stacked stage
    layout — and back, moments included."""

    step: int
    model: torch.nn.Module
    optimizer: ClippedAdamW
    discriminator: Optional[PairDiscriminator] = None  # d-regularized loss only
    layout: Any = None

    def _named_params(self) -> Dict[str, torch.Tensor]:
        named = dict(self.model.named_parameters())
        if self.discriminator is not None:
            named.update({f"discriminator.{n}": p
                          for n, p in self.discriminator.named_parameters()})
        return named

    def flat_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model as a plain ``SentenceEncoderModule``'s state dict."""
        sd = self.model.state_dict()
        return sd if self.layout is None else self.layout.flat(sd)

    def state_dict(self) -> Dict[str, Any]:
        disc = None if self.discriminator is None else self.discriminator.state_dict()
        if self.layout is None:
            return {"step": self.step, "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(), "discriminator": disc}
        group = self.optimizer.param_groups[0]
        moments = {}
        for m in ("mu", "nu", "acc"):
            named = {n: self.optimizer.state[p][m] for n, p in self._named_params().items()
                     if m in self.optimizer.state[p]}
            if named:
                moments[m] = self.layout.export(named)
        return {"step": self.step, "layout": self.layout.kind,
                "model": self.layout.export(self.model.state_dict()),
                "optimizer": {"counters": {k: v for k, v in group.items() if k != "params"},
                              "moments": moments},
                "discriminator": disc}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        kind = None if self.layout is None else self.layout.kind
        if sd.get("layout") != kind:
            raise ValueError(f"a {sd.get('layout') or 'plain'} checkpoint does not load into "
                             f"a {kind or 'plain'} state: resume with the same flags")
        self.step = int(sd["step"])
        if self.discriminator is not None:
            self.discriminator.load_state_dict(sd["discriminator"])
        if self.layout is None:
            self.model.load_state_dict(sd["model"])
            self.optimizer.load_state_dict(sd["optimizer"])
            return
        self.model.load_state_dict(self.layout.import_(sd["model"]))
        self.optimizer.param_groups[0].update(sd["optimizer"]["counters"])
        named = self._named_params()
        for m, tensors in sd["optimizer"]["moments"].items():
            for n, t in self.layout.import_(tensors).items():
                p = named[n]
                self.optimizer.state[p][m] = t.to(device=p.device, dtype=p.dtype).clone()


def create_train_state(
    encoder_cfg: EncoderConfig,
    train_cfg: TrainConfig,
    generator: torch.Generator,
    total_steps: int,
    loss_cfg: Optional[LossConfig] = None,
    initial_params: Optional[Dict[str, torch.Tensor]] = None,
    device: Any = None,
) -> Tuple[TrainState, ClippedAdamW]:
    """→ (state, optimizer), on ``device`` (default: the GPU).
    ``initial_params``: a state dict to start from (e.g. an imported
    checkpoint) instead of random weights from ``generator``, copied, never
    aliased."""
    device = resolve_device(device)
    model = SentenceEncoderModule(encoder_cfg).to(device)
    params = initial_params if initial_params is not None else init_params(
        encoder_cfg, generator, device=device)
    model.load_state_dict({k: v.detach().clone() for k, v in params.items()})
    discriminator = None
    trainable = list(model.parameters())
    if loss_cfg is not None and loss_cfg.kind == "d_regularized":
        discriminator = init_discriminator(encoder_cfg.hidden_size, generator, device=device)
        trainable += list(discriminator.parameters())
    optimizer = make_optimizer(train_cfg, total_steps, trainable)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      discriminator=discriminator), optimizer


def create_train_state_sharded(
    encoder_cfg: EncoderConfig,
    train_cfg: TrainConfig,
    generator: torch.Generator,
    total_steps: int,
    mesh: Any,
    loss_cfg: Optional[LossConfig] = None,
    initial_params: Optional[Dict[str, torch.Tensor]] = None,
):
    """The tensor-parallel state (``qst_tpu/train/train_step.py:204``):
    parameters laid out by ``parallel/sharding.py``'s rules — each layer a
    ``TensorParallelLayer`` whose heads and FFN columns are split over the
    mesh's model axis, the replicated tensors on the mesh's first device —
    the Adam moments alongside each tensor. ``initial_params`` (a state
    dict) or random weights from ``generator``. → (state, optimizer)."""
    from qst_tpu_torch.parallel.sharding import TensorParallelLayout, tensor_parallel_model

    home = mesh.devices[0]
    params = initial_params if initial_params is not None else init_params(
        encoder_cfg, generator, device=home)
    model = tensor_parallel_model(encoder_cfg, params, mesh)
    discriminator = None
    trainable = list(model.parameters())
    if loss_cfg is not None and loss_cfg.kind == "d_regularized":
        discriminator = init_discriminator(encoder_cfg.hidden_size, generator, device=home)
        trainable += list(discriminator.parameters())
    optimizer = make_optimizer(train_cfg, total_steps, trainable)
    layout = TensorParallelLayout(encoder_cfg, mesh.shape["model"])
    state = TrainState(step=0, model=model, optimizer=optimizer, discriminator=discriminator,
                       layout=layout)
    return state, optimizer


def _device_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.int64)


def _micro_step(encode: Callable, loss_cfg: LossConfig) -> Callable:
    """→ ``micro(state, opt, ids, mask, key, row) → loss``: forward, loss,
    backward and one optimizer update from ``row`` (a device tensor), all on
    device tensors. It reads and moves no host value — ``state.step`` and
    the optimizer's counters are the caller's — so it can be captured."""
    d_reg = loss_cfg.kind == "d_regularized"

    def micro(state: TrainState, opt: ClippedAdamW, ids, mask, key, row):
        four, B, S = ids.shape
        state.model.train()
        emb = encode(state.model, ids.reshape(four * B, S), mask.reshape(four * B, S),
                     key).reshape(four, B, -1)
        # unbind, not four slices: its backward is one stack of the four
        # gradients, where each slice's would be padded out and the four added
        loss = loss_from_config(loss_cfg, state.discriminator if d_reg else None)(
            *emb.unbind(0))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.apply_row(row)
        return loss.detach()

    return micro


def _row_tensor(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.float32).to(device)


def make_train_step(encoder_cfg: EncoderConfig, loss_cfg: LossConfig,
                    optimizer: Optional[ClippedAdamW] = None, mesh: Any = None) -> Callable:
    """→ ``step(state, input_ids, attention_mask, dropout_key=None)
    → (state, loss)``: forward, loss, backward and one optimizer call, the
    state updated in place. ``input_ids``/``attention_mask``: (4, B, S)
    stacked role batches (numpy or torch); ``dropout_key``: (seed, step)
    (``dropout_key()``), or None for no dropout. ``optimizer`` defaults to
    the state's. ``mesh``: the encoder runs data-parallel over its data
    axis (``encoder_apply_fn``); B must divide by the axis."""
    micro = _micro_step(encoder_apply_fn(encoder_cfg, mesh), loss_cfg)

    def step(state: TrainState, input_ids, attention_mask,
             dropout_key: Optional[torch.Tensor] = None):
        opt = optimizer if optimizer is not None else state.optimizer
        device = next(state.model.parameters()).device
        loss = micro(state, opt, _device_tensor(input_ids, device),
                     _device_tensor(attention_mask, device),
                     None if dropout_key is None else dropout_key.to(device),
                     _row_tensor(opt.next_row(), device))
        state.step += 1
        return state, loss

    return step


def _fill(dst: torch.Tensor, src) -> None:
    """Copy host values (numpy or torch) or a device tensor into the static
    device buffer ``dst``; from the host through pinned memory, so the host
    does not wait for the device."""
    src = torch.as_tensor(src)
    if src.device.type == "cpu":
        dst.copy_(src.to(dst.dtype).pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class MultiStep:
    """``n_steps`` train steps per call (``make_multi_step``).

    On the CPU the steps run one after another. On the GPU the first call of
    a (state, shape) runs its K steps eagerly on a side stream — they are
    the capture's warm-up and count as trained steps — and then captures K
    steps into one ``torch.cuda.CUDAGraph``: forward through K1 (its dropout
    drawn on the device from the static keys), loss through K3, backward
    through K2 and K3, clip and AdamW from the static rows. Every later call
    copies its inputs, keys and rows into the graph's static buffers and is
    one replay. Parameters, moments and accumulators are updated in place
    and every temporary lives in the graph's private pool, so nothing a
    replay reads is freed or replaced; a new state (or a reloaded optimizer)
    is captured anew. The capture runs in ``thread_local`` mode: a data
    thread (the negative miner) may launch on other streams meanwhile.

    The host's counters move as K eager steps move them: ``state.step`` and
    the optimizer's by K a call, and each kernel wrapper's ``launches`` by
    what the capture recorded, once per replay (the capture launches
    nothing). A failed capture or replay raises; nothing falls back to eager
    steps."""

    def __init__(self, encoder_cfg: EncoderConfig, loss_cfg: LossConfig,
                 optimizer: Optional[ClippedAdamW], n_steps: int, mesh: Any = None):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, {n_steps} given")
        self.encoder_cfg = encoder_cfg
        self.optimizer = optimizer
        self.n_steps = n_steps
        self._micro = _micro_step(encoder_apply_fn(encoder_cfg, mesh), loss_cfg)
        self._graph = None
        self._signature = None

    def __call__(self, state: TrainState, input_ids, attention_mask, keys):
        """``input_ids``/``attention_mask``: (n_steps, 4, B, S); ``keys``:
        (n_steps, 2) dropout keys, or None for no dropout. → (state, the
        (n_steps,) losses)."""
        opt = self.optimizer if self.optimizer is not None else state.optimizer
        device = next(state.model.parameters()).device
        K = self.n_steps
        ids = torch.as_tensor(input_ids)
        mask = torch.as_tensor(attention_mask)
        if ids.dim() != 4 or ids.shape[0] != K or mask.shape != ids.shape:
            raise ValueError(f"multi_step takes ({K}, 4, B, S) ids and mask, got "
                             f"{tuple(ids.shape)} and {tuple(mask.shape)}")
        rows = [opt.next_row() for _ in range(K)]
        if device.type != "cuda":
            losses = [self._micro(state, opt, _device_tensor(ids[j], device),
                                  _device_tensor(mask[j], device),
                                  None if keys is None else torch.as_tensor(keys[j]),
                                  _row_tensor(rows[j], device)) for j in range(K)]
            state.step += K
            return state, torch.stack(losses)
        signature = (tuple(ids.shape), keys is None, id(state.model), id(opt),
                     tuple(t.data_ptr() for t in opt.state_tensors()))
        if self._graph is not None and signature == self._signature:
            st = self._static
            _fill(st["ids"], ids)
            _fill(st["mask"], mask)
            if keys is not None:
                _fill(st["keys"], keys)
            _fill(st["rows"], torch.tensor(rows, dtype=torch.float32))
            self._graph.replay()
            build.add_launches(self._launches)
            state.step += K
            return state, self._losses.clone()
        return self._warm_up_and_capture(state, opt, ids, mask, keys, rows, device, signature)

    def _warm_up_and_capture(self, state, opt, ids, mask, keys, rows, device, signature):
        K = self.n_steps
        opt.init_state()
        st = {"ids": torch.empty(ids.shape, dtype=torch.int64, device=device),
              "mask": torch.empty(ids.shape, dtype=torch.int64, device=device),
              "keys": None if keys is None else torch.empty((K, 2), dtype=torch.int64,
                                                            device=device),
              "rows": torch.empty((K, len(rows[0])), dtype=torch.float32, device=device)}
        for name, value in (("ids", ids), ("mask", mask), ("keys", keys),
                            ("rows", torch.tensor(rows, dtype=torch.float32))):
            if value is not None:
                _fill(st[name], value)

        def steps():
            return torch.stack([self._micro(state, opt, st["ids"][j], st["mask"][j],
                                            None if keys is None else st["keys"][j],
                                            st["rows"][j]) for j in range(K)])

        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):          # this call's K steps: the warm-up
            losses = steps()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with build.capturing_launches() as recorded:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._losses = steps()
        self._graph, self._signature, self._static = graph, signature, st
        self._launches = dict(recorded)
        state.step += K
        return state, losses


def make_multi_step(encoder_cfg: EncoderConfig, loss_cfg: LossConfig,
                    optimizer: Optional[ClippedAdamW], n_steps: int,
                    mesh: Any = None) -> MultiStep:
    """→ ``multi_step(state, input_ids, attention_mask, keys) → (state,
    losses)``: ``n_steps`` optimizer steps per call, as the JAX package's
    ``make_multi_step`` (``lax.scan``) — one CUDA graph replay a call on the
    GPU (``MultiStep``). ``input_ids``/``attention_mask`` are (n_steps, 4, B,
    S) stacks and ``keys`` the (n_steps, 2) per-step dropout keys;
    ``losses`` is (n_steps,). ``optimizer`` defaults to the state's;
    ``mesh`` as ``make_train_step``'s (each shard's temporaries live in the
    graph's pool)."""
    return MultiStep(encoder_cfg, loss_cfg, optimizer, n_steps, mesh)


def make_eval_loss_fn(encoder_cfg: EncoderConfig, loss_cfg: LossConfig) -> Callable:
    """Deterministic (no-dropout) batch loss — the validation loss behind the
    loss evaluator: ``eval_loss(model, input_ids, attention_mask,
    discriminator=None)``."""
    from qst_tpu_torch.models.sentence_encoder import embed_fn

    fwd = embed_fn(encoder_cfg)   # the fused path when flagged

    def eval_loss(model, input_ids, attention_mask, discriminator=None):
        device = next(model.parameters()).device
        ids = _device_tensor(input_ids, device)
        mask = _device_tensor(attention_mask, device)
        four, B, S = ids.shape
        with torch.no_grad():
            emb = fwd(model, ids.reshape(four * B, S),
                      mask.reshape(four * B, S)).reshape(four, B, -1)
            return loss_from_config(loss_cfg, discriminator)(emb[0], emb[1], emb[2], emb[3])

    return eval_loss
