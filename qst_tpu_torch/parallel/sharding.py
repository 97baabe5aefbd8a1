"""Parameter sharding rules and data-parallel replicas — counterpart of
``qst_tpu/parallel/sharding.py``.

The JAX package annotates its parameter tree with ``PartitionSpec`` rules
and lets XLA derive the collectives. The port keeps the rules, over the HF
names and ``nn.Linear`` shapes of its state dicts, and carries out what XLA
derives by hand:

- ``spec_for_param(name, ndim)``: a tuple naming, per dimension, the mesh
  axis that splits it (``("model", None)``), or ``()`` when replicated.
  HF ``Linear`` weights are (out, in), so where JAX splits the heads axis
  of a (H, heads, hd) Q/K/V kernel the port splits the weight's output
  rows; the attention output's and the FFN output's input columns; the FFN
  input's output rows and its bias. Embeddings, LayerNorms and the biases
  of the row-parallel products are replicated. BERT's names and MPNet's
  ``q/k/v/o`` both match. An optimizer moment's name embeds its parameter's
  (``mu/encoder.layer.0...``), so the same rule fires. The tensor-parallel
  layer (``models/bert.py``'s ``tp_split_dim``) splits each of its tensors
  by this rule.
- ``tree_param_specs`` / ``tree_shardings`` / ``state_shardings`` /
  ``create_sharded``: the rules over a whole state dict; ``create_sharded``
  lays a created state dict out (each split tensor as its blocks, block j on
  the model axis' j-th device).
- ``tensor_parallel_model(cfg, params, mesh)``: a ``SentenceEncoderModule``
  whose layers are ``models/bert.py``'s ``TensorParallelLayer`` over the
  mesh's model axis — the tensor-parallel training state's model — and
  ``TensorParallelLayout``, which maps its tensors (parameters, moments) to
  the gathered HF names and back (checkpoints, the evaluator's flat model).
- ``data_parallel(fn, mesh)``: ``fn(model, ids, mask, key)`` run on each
  data shard's rows with the model's parameters replicated to the shard's
  devices; each replica's gradient comes back to the parameter summed in
  data-index order (``Replicate``), the JAX package's gradient ``psum``,
  so a step gives the same bits on every call. A shard's dropout key is
  the step's folded with its data index (JAX ``fold_in``).
- On a mesh that spans processes each process runs the data shards whose
  mesh row it owns a position of. A row split across processes (a data
  shard's tensor-parallel positions on more than one process) is run by
  each of its processes: each holds and computes the model columns it owns
  (``models/bert.py:TensorParallelLayer``), the partial sums and the
  replicated input's gradient cross the row's processes inside each layer
  (``core/meshes.py:row_sum``, ``row_scatter``), and the fused path gathers
  the row's slices for K1/K2. The shards' embeddings are gathered in
  data-index order, each from its row's first process (``_GatherShards``,
  whose backward gives every process of a row its rows' gradient), so the
  loss runs on every process on the same rows; ``ReplicateAcross`` sums
  every data shard's gradient copy in data-index order, each copy from the
  process that owns its position — a replicated tensor's from its row's
  first process, not once a process. The parameters after a step are the
  same bits on every process that holds them and equal to the one-process
  mesh's.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from qst_tpu_torch.core.meshes import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    gather_named,
    gather_ordered,
    running_row,
)

# (name regex, spec by rank) — the first match wins
_RULES: Tuple[Tuple[str, dict], ...] = (
    # attention projections — BERT (self.query/key/value, output.dense) and
    # MPNet (attn.q/k/v/o)
    (r"attention\.(self\.(query|key|value)|attn\.(q|k|v))\.weight$", {2: (MODEL_AXIS, None)}),
    (r"attention\.(self\.(query|key|value)|attn\.(q|k|v))\.bias$", {1: (MODEL_AXIS,)}),
    (r"attention\.(output\.dense|attn\.o)\.weight$", {2: (None, MODEL_AXIS)}),
    (r"attention\.(output\.dense|attn\.o)\.bias$", {1: ()}),
    # the FFN, column then row parallel
    (r"intermediate\.dense\.weight$", {2: (MODEL_AXIS, None)}),
    (r"intermediate\.dense\.bias$", {1: (MODEL_AXIS,)}),
    (r"layer\.\d+\.output\.dense\.weight$", {2: (None, MODEL_AXIS)}),
    (r"layer\.\d+\.output\.dense\.bias$", {1: ()}),
)


def spec_for_param(name: str, ndim: int) -> Tuple:
    """The spec of the tensor ``name`` of rank ``ndim``: per dimension the
    mesh axis that splits it or None; ``()`` when it is replicated."""
    for pattern, by_rank in _RULES:
        if re.search(pattern, name) and ndim in by_rank:
            return by_rank[ndim]
    return ()


def split_dim(spec: Tuple) -> Optional[int]:
    """The dimension a spec splits over the model axis, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def tree_param_specs(tree: Mapping[str, Any]) -> Dict[str, Tuple]:
    """→ {name: spec} for a state dict (parameters, gradients or moments)."""
    return {n: spec_for_param(n, getattr(t, "ndim", 0)) for n, t in tree.items()}


@dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on a mesh: ``spec`` as ``spec_for_param`` gives it."""

    mesh: Mesh
    spec: Tuple = ()

    def shard_devices(self):
        """The device of each block along the split dimension, in order
        (one entry, the mesh's home device, when replicated)."""
        if split_dim(self.spec) is None:
            return [self.mesh.home]
        return self.mesh.axis_devices(MODEL_AXIS)


def tree_shardings(mesh: Mesh, tree: Mapping[str, Any]) -> Dict[str, NamedSharding]:
    return {n: NamedSharding(mesh, s) for n, s in tree_param_specs(tree).items()}


def state_shardings(mesh: Mesh, create_fn: Callable, *args, **kwargs) -> Dict[str, NamedSharding]:
    """The layout of ``create_fn``'s state dict, found without making it:
    ``create_fn`` runs on the meta device (shapes only), then the rules map
    over every tensor."""
    with torch.device("meta"):
        shapes = create_fn(*args, **kwargs)
    if isinstance(shapes, nn.Module):
        shapes = shapes.state_dict()
    return tree_shardings(mesh, shapes)


def shard_tensor(t: torch.Tensor, sharding: NamedSharding):
    """``t`` laid out by ``sharding``: a replicated tensor on the mesh's
    first device, or the list of its blocks, block j copied to the model
    axis' j-th device."""
    dim, devices = split_dim(sharding.spec), sharding.shard_devices()
    if dim is None:
        return t.to(devices[0])
    return [b.to(d).clone() for b, d in zip(t.chunk(len(devices), dim), devices)]


def create_sharded(mesh: Mesh, create_fn: Callable, *args, **kwargs):
    """Run ``create_fn`` (→ a state dict) and lay its tensors out by the
    rules → (the laid-out dict: a tensor or a list of blocks a name, the
    shardings)."""
    sd = create_fn(*args, **kwargs)
    if isinstance(sd, nn.Module):
        sd = sd.state_dict()
    shardings = tree_shardings(mesh, sd)
    return {n: shard_tensor(t, shardings[n]) for n, t in sd.items()}, shardings


# ---------------------------------------------------------------------------
# The tensor-parallel model
# ---------------------------------------------------------------------------
_LAYER = re.compile(r"^encoder\.layer\.(\d+)\.(.+)$")


def _layer_parts(cfg):
    if cfg.arch == "mpnet":
        from qst_tpu_torch.models.mpnet import MPNET_LAYER_PARTS

        return MPNET_LAYER_PARTS
    from qst_tpu_torch.models.bert import BERT_LAYER_PARTS

    return BERT_LAYER_PARTS


def tensor_parallel_model(cfg, params: Mapping[str, torch.Tensor], mesh: Mesh) -> nn.Module:
    """A ``SentenceEncoderModule`` holding ``params`` (its HF state dict),
    each layer a ``TensorParallelLayer`` over the mesh's model axis: shard
    j's slices copied to ``mesh.axis_devices("model")[j]`` (this process's
    first position in column j), every replicated tensor on the mesh's home
    device (no slice is a view of another tensor, so an optimizer's in-place
    update reaches each through one path). On a mesh across processes a
    process holds the shards of the columns it owns a position of only."""
    from qst_tpu_torch.models.bert import TensorParallelLayer
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule

    devices = mesh.axis_devices(MODEL_AXIS)
    with torch.device("meta"):
        model = SentenceEncoderModule(cfg)
    model = model.to_empty(device=mesh.home)
    model.load_state_dict({k: v.detach() for k, v in params.items()})
    parts = _layer_parts(cfg)
    spans = mesh.spans_processes
    for i in range(cfg.num_layers):
        prefix = f"encoder.layer.{i}."
        full = {k[len(prefix):]: v for k, v in model.state_dict().items() if k.startswith(prefix)}
        model.encoder.layer[i] = TensorParallelLayer.from_full(
            cfg, full, parts, devices, mesh=mesh if spans else None, home=mesh.home)
    return model


_SHARD = re.compile(r"\.shards\.(\d+)\.")


def column_of(name: str) -> Optional[int]:
    """The model column a tensor-parallel tensor ``name`` belongs to (its
    ``shards.{j}``), or None for a replicated one."""
    m = _SHARD.search(name)
    return None if m is None else int(m.group(1))


class TensorParallelLayout:
    """The names of a tensor-parallel model's tensors against the gathered
    HF names: ``export`` gathers {model name: tensor} (parameters or
    optimizer moments) into HF names, ``import_`` splits them back; ``flat``
    is ``export`` (the evaluator's and the best artifact's state dict).

    With a ``mesh`` across processes on which some process lacks some
    column (``spread``: a row split across processes) every process calls
    ``export`` together: the slices of the columns another process holds
    come from the first process that holds them
    (``core/meshes.py:gather_named``). ``import_`` keeps the slices this
    process holds."""

    kind = "tensor_parallel"

    def __init__(self, cfg, n_shards: int, mesh: Optional[Mesh] = None):
        self.cfg, self.n_shards, self.parts = cfg, n_shards, _layer_parts(cfg)
        self.mesh = mesh if mesh is not None and mesh.spans_processes else None
        # some process lacks some column: gathers (exports, the clip's norm)
        # cross the processes; whole rows keep every tensor in every process
        if self.mesh is not None and all(self._holders(j) == self._holders(None)
                                         for j in range(n_shards)):
            self.mesh = None
        self.spread = self.mesh is not None

    def _holders(self, column: Optional[int]) -> list:
        """The processes that hold a tensor of ``column`` (None: replicated)."""
        mesh = self.mesh
        cols = mesh.shape[MODEL_AXIS]
        if column is None:
            return sorted(set(mesh.ranks))
        return sorted({mesh.ranks[r * cols + column] for r in range(mesh.shape[DATA_AXIS])})

    def first_holder(self, name: str) -> bool:
        """Whether this process gives ``name`` to a gather (the lowest rank
        that holds it)."""
        return self.mesh is None or self._holders(column_of(name))[0] == self.mesh.rank

    def _by_layer(self, named: Mapping[str, torch.Tensor], convert: Callable):
        """``convert(a layer's tensors under relative names, parts, n_shards)``
        applied layer by layer; other names pass as they are."""
        out, layers = {}, {}
        for n, t in named.items():
            m = _LAYER.match(n)
            if m is None:
                out[n] = t
            else:
                layers.setdefault(int(m.group(1)), {})[m.group(2)] = t
        for i, rel in sorted(layers.items()):
            out.update({f"encoder.layer.{i}.{k}": v
                        for k, v in convert(rel, self.parts, self.n_shards).items()})
        return out

    def export(self, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        from qst_tpu_torch.models.bert import gather_layer_state

        if self.mesh is not None:
            home = next(iter(named.values())).device
            named = {**gather_named({n: t for n, t in named.items()
                                     if column_of(n) is not None and self.first_holder(n)},
                                    home), **named}
        return self._by_layer(named, gather_layer_state)

    flat = export

    def import_(self, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        from qst_tpu_torch.models.bert import split_layer_state

        out = self._by_layer(sd, split_layer_state)
        if self.mesh is None:
            return out
        return {n: t for n, t in out.items()
                if self.mesh.rank in self._holders(column_of(n))}

    def param_names(self) -> list:
        """The tensor-parallel model's parameter names in one process's
        order (every column's): the order its optimizer sees them."""
        from qst_tpu_torch.models.bert import TensorParallelLayer
        from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule

        with torch.device("meta"):
            model = SentenceEncoderModule(self.cfg)
            for i in range(self.cfg.num_layers):
                model.encoder.layer[i] = TensorParallelLayer(self.cfg, self.n_shards, self.parts)
        return [n for n, _ in model.named_parameters()]


# ---------------------------------------------------------------------------
# Data parallelism: replicas whose gradients are summed in shard order
# ---------------------------------------------------------------------------
class Replicate(torch.autograd.Function):
    """``apply(devices, x)`` → one copy of ``x`` a device (a view where the
    device is x's own). The backward sums the copies' gradients on x's
    device in device order — a fixed order, unlike autograd's accumulation
    of one leaf's uses."""

    @staticmethod
    def forward(ctx, devices, x):
        ctx.home = x.device
        outs = []
        for d in devices:
            y = x.to(d)
            outs.append(y.view_as(y) if y is x else y)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        g = grads[0].to(ctx.home)
        for gi in grads[1:]:
            g = g + gi.to(ctx.home)
        return None, g


class ReplicateAcross(torch.autograd.Function):
    """``apply(plan, *params)`` on a mesh that spans processes:
    ``plan.entries[k]`` lists, for ``params[k]`` (named ``.name``), the
    copies this process makes — ``(data index, device, gives)`` — → the
    copies, parameter-major (a view where the device is the parameter's
    own). The backward sums each parameter's copies in data-index order on
    its device — the sum ``Replicate`` forms in one process, so the bits are
    the same. A ``shared`` parameter (another process holds it too) takes
    every copy's gradient whose ``gives`` is set, keyed by (data index,
    name), from every process (``core/meshes.py:gather_named``, called when
    ``plan.gather`` is set, alike on every process); each (data index, name)
    is given by one process, the owner of the copy's position. A process
    that runs a row it does not lead computes the row's replicated tensors'
    gradients too, and gives none of them. A parameter no other process
    holds sums its own copies."""

    @staticmethod
    def forward(ctx, plan, *params):
        ctx.plan = plan
        ctx.homes = [p.device for p in params]
        outs = []
        for p, entry in zip(params, plan.entries):
            for _, dev, _ in entry.copies:
                y = p.to(dev)
                outs.append(y.view_as(y) if y is p else y)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        local, given, k = {}, {}, 0
        for entry in ctx.plan.entries:
            for i, _, gives in entry.copies:
                local[(i, entry.name)] = grads[k]
                if gives and entry.shared:
                    given[(i, entry.name)] = grads[k]
                k += 1
        every = gather_named(given, ctx.homes[0]) if ctx.plan.gather else {}
        out = []
        for entry, dev in zip(ctx.plan.entries, ctx.homes):
            src = every if entry.shared else local
            g = src[(0, entry.name)].to(dev)
            for i in range(1, entry.n_data):
                g = g + src[(i, entry.name)].to(dev)
            out.append(g)
        return (None, *out)


@dataclass(frozen=True)
class _Copies:
    """One parameter's copies for ``ReplicateAcross``: its name, the data
    axis' size, (data index, device, gives) a copy, and whether another
    process holds the parameter too."""

    name: str
    n_data: int
    copies: Tuple
    shared: bool = True


@dataclass(frozen=True)
class CopyPlan:
    """``ReplicateAcross``'s plan: one ``_Copies`` a parameter, and whether
    the gradients cross processes at all (the same on every process)."""

    entries: Tuple
    gather: bool = True


def param_device(mesh: Mesh, name: str, data_index: int) -> torch.device:
    """Where data shard ``data_index`` keeps its copy of parameter ``name``:
    a tensor-parallel slice of column j at (data_index, j), anything else at
    this process's first position of the row (its first device)."""
    j = column_of(name)
    if j is not None and MODEL_AXIS in mesh.shape:
        return mesh.device_at(**{DATA_AXIS: data_index, MODEL_AXIS: j})
    return mesh.row_home(data_index)


class _Call(nn.Module):
    """``fn(model, *args)`` as a module's forward, so that
    ``torch.func.functional_call`` can run it with the model's parameters
    replaced."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def device_context(dev: torch.device):
    """``torch.cuda.device(dev)`` for a card, nothing for the host."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def replicas(model: nn.Module, n: int, device_of: Callable) -> list:
    """→ for each of ``n`` shards, {"model." + name: its copy} of the
    model's parameters, copy i of ``name`` on ``device_of(name, i)``; a
    trainable parameter's copies are one ``Replicate``."""
    per_shard = [dict() for _ in range(n)]
    for name, p in model.named_parameters():
        devs = tuple(device_of(name, i) for i in range(n))
        copies = Replicate.apply(devs, p) if p.requires_grad else tuple(p.to(d) for d in devs)
        for i, c in enumerate(copies):
            per_shard[i][f"model.{name}"] = c
    return per_shard


def replicas_across(model: nn.Module, mesh: Mesh) -> list:
    """``replicas`` on a mesh that spans processes: copies for the data
    shards whose row this process owns a position of (None for the
    others) — a replicated tensor in each, a tensor-parallel slice where
    this process owns its column of the row — the trainable ones through
    one ``ReplicateAcross``."""
    n = mesh.shape[DATA_AXIS]
    rows = [i for i in range(n) if mesh.in_row(i)]

    def needs(name, i):
        j = column_of(name)
        return j is None or mesh.owns(mesh.flat_shard_index(i, j))

    def gives(name, i):
        j = column_of(name)
        return j is not None or mesh.row_ranks(i)[0] == mesh.rank

    per_shard = [dict() if i in rows else None for i in range(n)]
    plan, trainable = [], []
    for name, p in model.named_parameters():
        where = [(i, param_device(mesh, name, i)) for i in rows if needs(name, i)]
        if not p.requires_grad:
            for i, dev in where:
                per_shard[i][f"model.{name}"] = p.to(dev)
            continue
        plan.append(_Copies(name, n, tuple((i, dev, gives(name, i)) for i, dev in where)))
        trainable.append(p)
    copies = iter(ReplicateAcross.apply(CopyPlan(tuple(plan)), *trainable))
    for entry in plan:
        for i, _, _ in entry.copies:
            per_shard[i][f"model.{entry.name}"] = next(copies)
    return per_shard


def run_with(model: nn.Module, fn: Callable, params: Mapping[str, torch.Tensor], *args):
    """``fn(model, *args)`` with the model's parameters replaced by
    ``params`` (``replicas``' names)."""
    return torch.func.functional_call(_Call(model, fn), dict(params), args)


class _GatherShards(torch.autograd.Function):
    """``apply(rows, leads, *outs)``: this process's data shards' outputs
    (``outs[k]`` of data shard ``rows[k]``, one size each) → every data
    shard's, in data-index order, on every process — each led by its row's
    first process (``leads[k]``), gathered in rank order. The backward gives
    each of this process's shards its rows of the incoming gradient, led or
    not: every process of a split row continues its own backward."""

    @staticmethod
    def forward(ctx, rows, leads, *outs):
        ctx.rows, ctx.size = rows, outs[0].shape[0]
        ctx.devices = [o.device for o in outs]
        led = [o for o, lead in zip(outs, leads) if lead]
        local = torch.cat(led) if led else outs[0][:0]
        return torch.cat(gather_ordered(local))

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *[grad[i * ctx.size:(i + 1) * ctx.size].to(d)
                              for i, d in zip(ctx.rows, ctx.devices)])


def data_parallel(fn: Callable, mesh: Mesh) -> Callable:
    """``fn(model, ids, mask, key) → (rows, D)`` made data-parallel over the
    mesh's data axis: the rows split into one contiguous block a data shard
    (a multiple of the axis' size, as the JAX package's ``P(DATA_AXIS)``),
    block i run by ``fn`` on the shard's devices with the parameters
    replicated there and the key folded with i (inside
    ``core/meshes.py:running_row(i)``, so that a tensor-parallel layer knows
    the row); the outputs concatenated in row order on the rows' device. On
    a mesh that spans processes each process runs the data shards of the
    rows it owns a position of and the rows of every shard are gathered in
    order (every process passes the whole batch)."""
    from qst_tpu_torch.ops.fused_layer import fold_key

    n = mesh.shape[DATA_AXIS]
    spans = mesh.spans_processes

    def run(model, ids, mask, key=None):
        if ids.shape[0] % n:
            raise ValueError(f"{ids.shape[0]} rows do not split over {n} data shards")
        ids_s, mask_s = ids.chunk(n), mask.chunk(n)
        if not spans:
            copies = replicas(model, n, lambda name, i: param_device(mesh, name, i))
        else:
            copies = replicas_across(model, mesh)
        outs = []
        for i in range(n):
            if copies[i] is None:
                continue
            dev = mesh.row_home(i)
            with running_row(i), device_context(dev):
                outs.append((i, run_with(model, fn, copies[i], ids_s[i].to(dev), mask_s[i].to(dev),
                                         None if key is None else fold_key(key.to(dev), i))))
        if not spans:
            return torch.cat([o.to(ids.device) for _, o in outs])
        rows = [i for i, _ in outs]
        return _GatherShards.apply(rows, [mesh.row_ranks(i)[0] == mesh.rank for i in rows],
                                   *[o.to(ids.device) for _, o in outs])

    return run
