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
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from qst_tpu_torch.core.meshes import DATA_AXIS, MODEL_AXIS, Mesh, shard_loop

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
        (one entry, the mesh's first device, when replicated)."""
        if split_dim(self.spec) is None:
            return self.mesh.devices[:1]
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
    j's slices copied to the axis' j-th device, every replicated tensor on
    the mesh's first device (no slice is a view of another tensor, so an
    optimizer's in-place update reaches each through one path)."""
    from qst_tpu_torch.models.bert import TensorParallelLayer
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule

    devices = mesh.axis_devices(MODEL_AXIS)
    with torch.device("meta"):
        model = SentenceEncoderModule(cfg)
    model = model.to_empty(device=mesh.devices[0])
    model.load_state_dict({k: v.detach() for k, v in params.items()})
    parts = _layer_parts(cfg)
    for i in range(cfg.num_layers):
        prefix = f"encoder.layer.{i}."
        full = {k[len(prefix):]: v for k, v in model.state_dict().items() if k.startswith(prefix)}
        model.encoder.layer[i] = TensorParallelLayer.from_full(cfg, full, parts, devices)
    return model


class TensorParallelLayout:
    """The names of a tensor-parallel model's tensors against the gathered
    HF names: ``export`` gathers {model name: tensor} (parameters or
    optimizer moments) into HF names, ``import_`` splits them back; ``flat``
    is ``export`` (the evaluator's and the best artifact's state dict)."""

    kind = "tensor_parallel"

    def __init__(self, cfg, n_shards: int):
        self.cfg, self.n_shards, self.parts = cfg, n_shards, _layer_parts(cfg)

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

        return self._by_layer(named, gather_layer_state)

    flat = export

    def import_(self, sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        from qst_tpu_torch.models.bert import split_layer_state

        return self._by_layer(sd, split_layer_state)


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


_SHARD = re.compile(r"\.shards\.(\d+)\.")


def param_device(mesh: Mesh, name: str, data_index: int) -> torch.device:
    """Where data shard ``data_index`` keeps its copy of parameter ``name``:
    a tensor-parallel slice of shard j at (data_index, j), anything else at
    (data_index, 0)."""
    m = _SHARD.search(name)
    if m is not None and MODEL_AXIS in mesh.shape:
        return mesh.device_at(**{DATA_AXIS: data_index, MODEL_AXIS: int(m.group(1))})
    return mesh.device_at(**{DATA_AXIS: data_index})


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


def replicas(model: nn.Module, mesh: Mesh, n: int, device_of: Callable) -> list:
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


def run_with(model: nn.Module, fn: Callable, params: Mapping[str, torch.Tensor], *args):
    """``fn(model, *args)`` with the model's parameters replaced by
    ``params`` (``replicas``' names)."""
    return torch.func.functional_call(_Call(model, fn), dict(params), args)


def data_parallel(fn: Callable, mesh: Mesh) -> Callable:
    """``fn(model, ids, mask, key) → (rows, D)`` made data-parallel over the
    mesh's data axis: the rows split into one contiguous block a data shard
    (a multiple of the axis' size, as the JAX package's ``P(DATA_AXIS)``),
    block i run by ``fn`` on the shard's devices with the parameters
    replicated there and the key folded with i; the outputs concatenated
    in row order on the rows' device."""
    from qst_tpu_torch.ops.fused_layer import fold_key

    n = mesh.shape[DATA_AXIS]

    def run(model, ids, mask, key=None):
        if ids.shape[0] % n:
            raise ValueError(f"{ids.shape[0]} rows do not split over {n} data shards")
        copies = replicas(model, mesh, n, lambda name, i: param_device(mesh, name, i))
        ids_s, mask_s = ids.chunk(n), mask.chunk(n)
        outs = shard_loop(mesh, lambda i, dev: run_with(
            model, fn, copies[i], ids_s[i].to(dev), mask_s[i].to(dev),
            None if key is None else fold_key(key.to(dev), i)), axis=DATA_AXIS)
        return torch.cat([o.to(ids.device) for o in outs])

    return run
