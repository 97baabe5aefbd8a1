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
  ticks compute nothing; activations go stage to stage at the end of each
  tick (``.to`` the next stage's device within a process, a hand-off
  between processes: ``core/meshes.py:exchange``); with v > 1 the last
  stage's output wraps back to stage 0 through a per-microbatch bank, read
  at its next-round slot (hence M ≥ S). Only the last stage's final-round
  outputs are real. The backward is the schedule in reverse tick order
  (``_Schedule.backward``), the same code for one process and many.
- Across processes (a pipe mesh whose stages lie on different processes):
  each process makes and updates only the stages it runs (JAX's ``P(pipe)``
  stage params), computes the embeddings itself, gets the last stage's
  outputs from their processes (JAX's ``psum`` over ``pipe``) and computes
  the loss; stage 0's processes hand every process the embeddings' input
  gradient, so every process's embedding update is the same bits.
  ``PipelineLayout`` gathers the other processes' stages for a checkpoint
  and the evaluator's flat model, and a resume lays each process's stages
  back out.
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
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn

from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.core.meshes import (
    DATA_AXIS,
    PIPE_AXIS,
    Mesh,
    exchange,
    gather_named,
    gather_ordered,
    make_pipe_mesh,
)

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

    def forward(self, x, bias, mask, slots, gens):
        """Slots ``slots`` of this stage in turn, slot k's dropout from
        ``gens[k]``."""
        for slot, gen in zip(slots, gens):
            x = self.layer[slot](x, bias, gen, mask)
        return x


def stage_owners(mesh: Mesh, n_stages: int) -> List[List[int]]:
    """``owners[p][d]``: the process that runs stage p of data shard d."""
    n_data = mesh.shape.get(DATA_AXIS, 1)
    return [[mesh.ranks[mesh.flat_shard_index(p, d)] for d in range(n_data)]
            for p in range(n_stages)]


def held_stages(mesh: Optional[Mesh], n_stages: int) -> List[int]:
    """The stages this process holds the weights of: those it runs for some
    data shard (every stage without a mesh)."""
    if mesh is None:
        return list(range(n_stages))
    return [p for p, row in enumerate(stage_owners(mesh, n_stages)) if mesh.rank in row]


class PipelineEncoder(nn.Module):
    """BERT's embeddings and ``n_stages`` stages of ``BertLayer`` slots (the
    JAX package's {"embeddings", "stages"} params). Its state dict names
    are ``embeddings.*`` and ``stages.{p}.layer.{slot}.*``. ``held``: the
    stages this process makes (default all); the others are empty modules,
    as another process holds them."""

    def __init__(self, cfg: EncoderConfig, n_stages: int, n_rounds: int = 1,
                 held: Optional[Sequence[int]] = None):
        super().__init__()
        if cfg.arch != "bert":
            raise ValueError(f"the pipeline runs BERT layers, as the JAX package's does; "
                             f"arch {cfg.arch!r} given")
        from qst_tpu_torch.models.bert import BertEmbeddings

        _chunk_layers(cfg.num_layers, n_stages, n_rounds)
        self.cfg, self.n_stages, self.n_rounds = cfg, n_stages, n_rounds
        held = range(n_stages) if held is None else held
        self.embeddings = BertEmbeddings(cfg)
        self.stages = nn.ModuleList(_Stage(cfg, cfg.num_layers // n_stages) if p in held
                                    else nn.Module() for p in range(n_stages))


_STAGE = re.compile(r"^stages\.(\d+)\.")


def _stage_of(name: str) -> Optional[int]:
    m = _STAGE.match(name)
    return None if m is None else int(m.group(1))


class PipelineLayout:
    """A ``PipelineEncoder``'s tensors against a checkpoint's: ``export``
    stacks {"stages.{p}.layer.{slot}.{name}"} into {"stages.{name}": (S,
    per, ...)} (``stack_stage_params``' layout; ``embeddings.*`` as they
    are), ``import_`` unstacks, ``flat`` gives a plain
    ``SentenceEncoderModule``'s names (``encoder.layer.{l}.*``).

    With a ``mesh`` across processes every process calls ``export`` and
    ``flat`` together: the stages another process holds come from the first
    process that holds them (``core/meshes.py:gather_named``); ``import_``
    keeps the stages this process holds, so a resume lays a checkpoint back
    out."""

    kind = "pipeline"

    def __init__(self, cfg: EncoderConfig, n_stages: int, n_rounds: int = 1,
                 mesh: Optional[Mesh] = None):
        self.cfg, self.n_stages, self.n_rounds = cfg, n_stages, n_rounds
        self.rows = _stage_layers(cfg.num_layers, n_stages, n_rounds)
        self.mesh = mesh if mesh is not None and mesh.spans_processes else None
        # some process lacks some stage: gathers cross the processes
        self.spread = self.mesh is not None

    _SLOT = re.compile(r"^stages\.(\d+)\.layer\.(\d+)\.(.+)$")

    def _holders(self, stage: Optional[int]) -> List[int]:
        if stage is None:
            return sorted(set(self.mesh.ranks))
        return sorted(set(stage_owners(self.mesh, self.n_stages)[stage]))

    def first_holder(self, name: str) -> bool:
        """Whether this process gives ``name`` to a gather (the lowest rank
        that holds it)."""
        return self.mesh is None or self._holders(_stage_of(name))[0] == self.mesh.rank

    def _whole(self, named: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
        """``named`` with the other processes' stages added (a mesh across
        processes; every process calls this together)."""
        if self.mesh is None:
            return named
        home = next(iter(named.values())).device
        return {**gather_named({n: t for n, t in named.items()
                                if _stage_of(n) is not None and self.first_holder(n)}, home),
                **named}

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
        other, slots = self._split(self._whole(named))
        return {**other, **{f"encoder.layer.{self.rows[p][s]}.{n}": t
                            for (p, s, n), t in slots.items()}}

    def export(self, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        other, slots = self._split(self._whole(named))
        names = sorted({n for (_, _, n) in slots})
        per = len(self.rows[0])
        home = next(iter(named.values())).device if named else None
        return {**other, **{f"stages.{n}": torch.stack([torch.stack(
            [slots[(p, s, n)].to(home) for s in range(per)]) for p in range(self.n_stages)])
            for n in names}}

    def import_(self, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        held = held_stages(self.mesh, self.n_stages)
        out = {}
        for n, t in sd.items():
            if not n.startswith("stages."):
                out[n] = t
                continue
            for p in held:
                for s in range(t.shape[1]):
                    out[f"stages.{p}.layer.{s}.{n[len('stages.'):]}"] = t[p, s]
        return out

    def param_names(self) -> List[str]:
        """The pipeline model's parameter names in one process's order
        (every stage's): the order its optimizer sees them."""
        with torch.device("meta"):
            model = PipelineEncoder(self.cfg, self.n_stages, self.n_rounds)
        return [n for n, _ in model.named_parameters()]


def pp_params_from_encoder(encoder_params: Mapping[str, torch.Tensor], cfg: EncoderConfig,
                           n_stages: int, mesh: Optional[Mesh] = None,
                           n_rounds: int = 1) -> PipelineEncoder:
    """A flat ``SentenceEncoderModule`` state dict → the ``PipelineEncoder``
    holding copies of its tensors (never views of the caller's), stage p on
    this process's first position of the mesh's row p and the embeddings on
    the mesh's home device (without a mesh: all on the tensors' own
    device). On a mesh across processes only the stages this process runs
    are made (``held_stages``)."""
    rows = _stage_layers(cfg.num_layers, n_stages, n_rounds)
    held = held_stages(mesh, n_stages)
    if mesh is not None:
        home = mesh.home
        devices = {p: mesh.row_home(p) for p in held}
    else:
        home = next(iter(encoder_params.values())).device
        devices = {p: home for p in held}
    with torch.device("meta"):
        model = PipelineEncoder(cfg, n_stages, n_rounds, held)
    model = model.to_empty(device=home)
    sd = {n: t for n, t in encoder_params.items() if n.startswith("embeddings.")}
    for p in held:
        for slot, li in enumerate(rows[p]):
            prefix = f"encoder.layer.{li}."
            sd.update({f"stages.{p}.layer.{slot}.{n[len(prefix):]}": t
                       for n, t in encoder_params.items() if n.startswith(prefix)})
    model.load_state_dict({n: t.detach() for n, t in sd.items()})
    for p, dev in devices.items():
        model.stages[p].to(dev)
    return model


class _Schedule:
    """One call of the fill-drain (or circular) schedule over a pipe mesh,
    which this process runs its positions of: ``run`` the forward, tick by
    tick, data shard by data shard, with the hand-offs of a tick exchanged
    at its end (``core/meshes.py:exchange``: ``.to`` between two positions
    of this process, a hand-off between processes); ``backward`` the
    schedule in reverse tick order, each chunk's ``torch.autograd.backward``
    on its own graph and the input gradients handed back at the tick
    boundaries along the forward's pairs. The graph is cut at every chunk
    input and every weight copy (a leaf a (stage, data shard)), so no
    autograd call ever waits for another process; each copy's gradient goes
    back to ``_stage_copies``' ``Replicate`` / ``ReplicateAcross``, which sum
    a weight's copies in data-index order."""

    def __init__(self, cfg, mesh, model, M, V, hidden, bias, mask, keys, copies):
        self.cfg, self.mesh, self.model, self.M, self.V = cfg, mesh, model, M, V
        self.Pn = model.n_stages
        self.owners = stage_owners(mesh, self.Pn)
        self.n_data = len(self.owners[0])
        self.devs = [[mesh.device_at(**{PIPE_AXIS: p, DATA_AXIS: d}) for d in range(self.n_data)]
                     for p in range(self.Pn)]
        self.rows = _stage_layers(cfg.num_layers, self.Pn, V)
        self.pc = cfg.num_layers // (self.Pn * V)
        self.T = V * M + self.Pn - 1
        self.rank = mesh.rank
        self.spans = mesh.spans_processes
        self.hidden, self.bias, self.mask, self.keys = hidden, bias, mask, keys
        self.mb = hidden.shape[0] // M
        self.local = self.mb // self.n_data
        self.copies = copies                  # [(stage, data shard, name, copy)]

    def _rows(self, t, d, m):
        return t[m * self.mb + d * self.local:m * self.mb + (d + 1) * self.local]

    def _like(self, p, d):
        S, H = self.hidden.shape[1:]
        return torch.empty((self.local, S, H), dtype=self.hidden.dtype, device=self.devs[p][d])

    def _chunk(self, p, d, rr, m, x):
        from qst_tpu_torch.models.bert import DeviceDropout
        from qst_tpu_torch.parallel.sharding import device_context

        dev = self.devs[p][d]
        slots = list(range(rr * self.pc, (rr + 1) * self.pc))
        key = self.keys[d][m]
        gens = [None if key is None else DeviceDropout(key.to(dev), self.rows[p][s])
                for s in slots]
        with device_context(dev):
            return torch.func.functional_call(self.model.stages[p], self.weights[(p, d)], (
                x, self._rows(self.bias, d, m).to(dev), self._rows(self.mask, d, m).to(dev),
                slots, gens))

    def _sends(self, t):
        """The forward's hand-offs at the end of tick ``t``, in stage order:
        (producer stage, consumer stage, microbatch, "buf" or "wrap")."""
        out = []
        for p in range(self.Pn):
            tp = t - p
            if not 0 <= tp < self.V * self.M:
                continue
            rr, m = divmod(tp, self.M)
            if p < self.Pn - 1:
                out.append((p, p + 1, m, "buf"))
            elif rr < self.V - 1:          # the wrap: banked until round rr + 1
                out.append((p, 0, m, "wrap"))
        return out

    def run(self, graph: bool) -> torch.Tensor:
        """The forward → the last stage's final-round outputs of every data
        shard and microbatch, gathered on every process, rows in batch
        order on the home device. ``graph``: keep each chunk's graph for
        ``backward``."""
        me, Pn, M, V = self.rank, self.Pn, self.M, self.V
        self.weights = {}
        for p, d, n, w in self.copies:
            self.weights.setdefault((p, d), {})[n] = (
                w.detach().requires_grad_(w.requires_grad) if graph else w)
        self.record, outs = {}, {}
        for d in range(self.n_data):
            buf: List[Optional[torch.Tensor]] = [None] * Pn
            wrap: List[Optional[torch.Tensor]] = [None] * M
            for t in range(self.T):
                ys = {}
                for p in range(Pn):
                    tp = t - p                  # this stage's schedule position
                    if not 0 <= tp < V * M or self.owners[p][d] != me:
                        continue                # a bubble tick, or another process's
                    rr, m = divmod(tp, M)
                    if p == 0:
                        x = (self._rows(self.hidden, d, m) if rr == 0 else wrap[m]).to(
                            self.devs[0][d])
                    else:
                        x = buf[p]
                    if graph:
                        x = x.detach().requires_grad_()
                    with torch.set_grad_enabled(graph):
                        y = self._chunk(p, d, rr, m, x)
                    if graph:
                        self.record[(d, t, p)] = (x, y)
                    ys[p] = y
                    if p == Pn - 1 and rr == V - 1:
                        outs[(d, m)] = y.detach()
                sends = [s for s in self._sends(t)
                         if me in (self.owners[s[0]][d], self.owners[s[1]][d])]
                got = exchange([(ys[src] if self.owners[src][d] == me else self._like(dst, d),
                                 self.owners[src][d], self.owners[dst][d])
                                for src, dst, _, _ in sends])
                buf = [None] * Pn
                for (src, dst, m, kind), y in zip(sends, got):
                    if self.owners[dst][d] == me:
                        if kind == "buf":
                            buf[dst] = y.to(self.devs[dst][d])
                        else:
                            wrap[m] = y.to(self.devs[0][d])
        self.out_owner = {(d, m): self.owners[Pn - 1][d]
                          for d in range(self.n_data) for m in range(M)}
        home = self.hidden.device
        pieces = self._gather(outs, self.out_owner)
        return torch.cat([pieces[(d, m)].to(home) for m in range(M) for d in range(self.n_data)])

    def _gather(self, mine: Dict, owner: Dict) -> Dict:
        """{(d, m): tensor} of this process → every process's, each from its
        ``owner`` (one ``gather_ordered`` of the stacked pieces in (d, m)
        order; nothing to gather in one process)."""
        if not self.spans:
            return mine
        keys = sorted(owner)
        own = [mine[k] for k in keys if owner[k] == self.rank]
        local = (torch.stack(own) if own else self._like(0, 0)[None][:0]).to(self.hidden.device)
        every = gather_ordered(local)
        out, taken = {}, {r: 0 for r in range(len(every))}
        for k in keys:
            r = owner[k]
            out[k] = every[r][taken[r]]
            taken[r] += 1
        return out

    def backward(self, grad_last: torch.Tensor):
        """The schedule in reverse → (the hidden states' gradient on every
        process, each weight copy's gradient, in ``copies``' order)."""
        me, Pn, M, V = self.rank, self.Pn, self.M, self.V
        pending = {}
        for d in range(self.n_data):
            for m in range(M):
                if self.out_owner[(d, m)] == me:
                    key = (d, (V - 1) * M + m + Pn - 1, Pn - 1)
                    pending[key] = self._rows(grad_last, d, m).to(self.record[key][1].device)
        into_hidden = {}
        for d in reversed(range(self.n_data)):
            for t in reversed(range(self.T)):
                for p in range(Pn):
                    if (d, t, p) in self.record:
                        x, y = self.record.pop((d, t, p))
                        torch.autograd.backward(y, pending.pop((d, t, p)))
                        rr, m = divmod(t - p, M)
                        if p == 0 and rr == 0:
                            into_hidden[(d, m)] = x.grad
                        self.record[(d, t, p)] = (x, None)
                # each chunk input's gradient back to its producer: the reverse
                # of the forward's hand-offs into tick t
                backs = []
                for p in range(Pn):
                    tp = t - p
                    if not 0 <= tp < V * M:
                        continue
                    rr, m = divmod(tp, M)
                    if p > 0:
                        backs.append((p, p - 1, t - 1))
                    elif rr > 0:
                        backs.append((0, Pn - 1, (rr - 1) * M + m + Pn - 1))
                backs = [b for b in backs if me in (self.owners[b[0]][d], self.owners[b[1]][d])]
                got = exchange([(self.record[(d, t, c)][0].grad if self.owners[c][d] == me
                                 else self._like(q, d), self.owners[c][d], self.owners[q][d])
                                for c, q, _ in backs])
                for (c, q, tq), g in zip(backs, got):
                    if self.owners[q][d] == me:
                        pending[(d, tq, q)] = g.to(self.devs[q][d])
        self.record = {}
        owner0 = {(d, m): self.owners[0][d] for d in range(self.n_data) for m in range(M)}
        pieces = self._gather(into_hidden, owner0)
        home = self.hidden.device
        g_hidden = torch.cat([pieces[(d, m)].to(home) for m in range(M)
                              for d in range(self.n_data)])
        return g_hidden, [self.weights[(p, d)][n].grad for p, d, n, _ in self.copies]


class _Trunk(torch.autograd.Function):
    """The schedule as one autograd node: ``apply(schedule, hidden,
    *copies)`` → the last stage's outputs; its backward runs the schedule
    in reverse (``_Schedule.backward``) and gives each (stage, data shard)
    copy of a weight its gradient."""

    @staticmethod
    def forward(ctx, sched, hidden, *copies):
        ctx.sched = sched
        return sched.run(graph=True)

    @staticmethod
    def backward(ctx, grad):
        g_hidden, g_copies = ctx.sched.backward(grad)
        return (None, g_hidden, *g_copies)


def _stage_copies(mesh: Mesh, model: "PipelineEncoder") -> List[tuple]:
    """[(stage, data shard, name, copy)] of each weight of the stages this
    process holds, one copy a data shard it runs, on its position's device:
    one process's through ``Replicate`` (the master itself with one data
    shard), a mesh across processes' through one ``ReplicateAcross`` whose
    gradients cross the processes only for a stage row split across them —
    either way each weight's copies' gradients summed in data-index order."""
    from qst_tpu_torch.parallel.sharding import CopyPlan, Replicate, ReplicateAcross, _Copies

    owners = stage_owners(mesh, model.n_stages)
    n_data = len(owners[0])
    rank = mesh.rank

    def dev(p, d):
        return mesh.device_at(**{PIPE_AXIS: p, DATA_AXIS: d})

    masters = [(p, n, w) for p in held_stages(mesh, model.n_stages)
               for n, w in model.stages[p].named_parameters()]
    out = []
    if not mesh.spans_processes:
        for p, n, w in masters:
            if n_data == 1:
                out.append((p, 0, n, w))
                continue
            devs = tuple(dev(p, d) for d in range(n_data))
            copies = Replicate.apply(devs, w) if w.requires_grad else [w.to(x) for x in devs]
            out += [(p, d, n, c) for d, c in enumerate(copies)]
        return out
    split = [len(set(row)) > 1 for row in owners]
    plan, trainable = [], []
    for p, n, w in masters:
        mine = [d for d in range(n_data) if owners[p][d] == rank]
        if not w.requires_grad:
            out += [(p, d, n, w.to(dev(p, d))) for d in mine]
            continue
        plan.append(_Copies(f"stages.{p}.{n}", n_data, tuple((d, dev(p, d), True) for d in mine),
                            shared=split[p]))
        trainable.append((p, n, mine))
    copies = iter(ReplicateAcross.apply(CopyPlan(tuple(plan), gather=any(split)),
                                        *[w for p, n, w in masters if w.requires_grad]))
    for p, n, mine in trainable:
        out += [(p, d, n, next(copies)) for d in mine]
    return out


def make_pp_embed_fn(cfg: EncoderConfig, mesh: Mesh, n_stages: int, n_microbatches: int,
                     n_rounds: int = 1) -> Callable:
    """→ ``fn(model, input_ids, attention_mask, key=None) → (B, D)``: the
    ``PipelineEncoder``'s embeddings with its trunk run through the
    schedule over the mesh's pipe axis and each microbatch's rows split
    over its data axis. B must divide by ``n_microbatches`` and each
    microbatch by the data axis. ``key`` (seed, step): the configured
    dropout, drawn on the device; None: the deterministic forward.

    On a mesh across processes every process passes the whole batch,
    computes the embeddings and runs its stages; the last stage's outputs
    are gathered to every process (JAX's ``psum`` over ``pipe``), and the
    backward gathers the embeddings' input gradient to every process from
    the processes of stage 0, so every process's embedding update is the
    same."""
    from qst_tpu_torch.models.bert import MASK_BIAS, DeviceDropout
    from qst_tpu_torch.ops.distances import l2_normalize
    from qst_tpu_torch.ops.fused_layer import fold_key
    from qst_tpu_torch.ops.pooling import POOLERS

    if PIPE_AXIS not in mesh.shape:
        raise ValueError("mesh needs a 'pipe' axis")
    if mesh.shape[PIPE_AXIS] != n_stages:
        raise ValueError(f"mesh pipe={mesh.shape[PIPE_AXIS]} != n_stages={n_stages}")
    _stage_layers(cfg.num_layers, n_stages, n_rounds)   # divisibility
    if n_rounds > 1 and n_microbatches < n_stages:
        raise ValueError(
            f"the circular schedule needs n_microbatches >= n_stages (wrapped activations "
            f"must arrive before their next-round slot), got {n_microbatches} < {n_stages}")
    stochastic = cfg.hidden_dropout > 0 or cfg.attention_dropout > 0
    M = n_microbatches
    n_data = mesh.shape.get(DATA_AXIS, 1)

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
        keys = [[None if key is None else fold_key(fold_key(key, d), m) for m in range(M)]
                for d in range(n_data)]
        grads = torch.is_grad_enabled() and (hidden.requires_grad or any(
            w.requires_grad for w in model.stages.parameters()))
        with torch.set_grad_enabled(grads):
            copies = _stage_copies(mesh, model)
        sched = _Schedule(cfg, mesh, model, M, n_rounds, hidden, bias, mask, keys, copies)
        if grads:
            last = _Trunk.apply(sched, hidden, *[c for _, _, _, c in copies])
        else:
            last = sched.run(graph=False)
        pooled = POOLERS[cfg.pooling](last, mask)
        return l2_normalize(pooled) if cfg.normalize else pooled

    return fn


def make_pp_train_step(cfg: EncoderConfig, loss_cfg, optimizer, mesh: Mesh, n_stages: int,
                       n_microbatches: int, n_rounds: int = 1) -> Callable:
    """→ ``step(state, input_ids (4, B, S), attention_mask, key=None) →
    (state, loss)`` with ``state.model`` a ``PipelineEncoder``: forward
    through the schedule, the loss (``loss_from_config``: K3 with
    ``use_fused_kernel``), backward and one optimizer call (``optimizer``,
    default the state's). With dropout in the config, ``key`` draws it. On
    a mesh across processes every process computes the loss, and the clip's
    global norm gathers the norms of the stages others hold
    (``train_step.py:norm_across_processes``)."""
    from qst_tpu_torch.train.train_step import loss_from_config, norm_across_processes

    fwd = make_pp_embed_fn(cfg, mesh, n_stages, n_microbatches, n_rounds)
    loss_fn = loss_from_config(loss_cfg)
    layout = PipelineLayout(cfg, n_stages, n_rounds, mesh)

    def step(state, input_ids, attention_mask, key=None):
        opt = optimizer if optimizer is not None else state.optimizer
        if layout.spread and opt.global_norm is None:
            names = {id(w): n for n, w in state.model.named_parameters()}
            opt.global_norm = norm_across_processes(
                [names[id(w)] for w in opt.param_groups[0]["params"]], layout.param_names(),
                layout.first_holder)
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
