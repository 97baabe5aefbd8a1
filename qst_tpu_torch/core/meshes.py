"""Device meshes, the shard loop and the dtype policy — counterpart of
``qst_tpu/core/meshes.py``.

In the JAX package one process drives a ``jax.sharding.Mesh`` through
``shard_map``, or several processes each drive their own devices of one
global mesh. The port keeps that shape: a :class:`Mesh` is a (data, model)
grid of ``torch.device`` s, and a sharded computation is one Python loop
over the shards (:func:`shard_loop`), each shard's tensors on its own
device, the candidates merged on the mesh's home device
(:func:`merge_topk`). A mesh may name one device more than once, as the JAX
tests' eight virtual CPU devices share one host: the CPU tests and one GPU
then run the sharded code itself, and a host with several cards places the
shards on distinct ones.

Across processes (a ``torch.distributed`` group from
``initialize_distributed``), ``make_mesh`` without ``devices`` lays out
every process's positions, gathered in rank order as ``jax.devices()``
orders devices by process, and the mesh keeps each position's owning rank
(``Mesh.ranks``; a ``torch.device`` cannot carry it, a JAX device carries
``process_index``). Each process then runs the positions it owns
(``shard_loop`` gives None for the others), and the three places where one
position needs another's values gather in rank order, which is shard order:
``merge_topk`` (the candidates), ``gather_rows`` (embedding rows, with a
backward that keeps this rank's rows) and ``parallel/sharding.py``'s
gradient sum. Every collective is a ``broadcast`` from each rank in turn
(``gather_ordered``), so its order is the ranks', never the backend's. The
group's backend is ``nccl`` for cards by default and ``gloo`` for the CPU;
``backend="gloo"`` runs several processes on one card (NCCL refuses two
ranks on one GPU) with the CUDA tensors sent through gloo.

- A :class:`Mesh` has two named axes: ``("data", "model")`` by default, or
  ``("pipe", "data")`` from ``make_pipe_mesh`` (the pipeline's stages over
  ``pipe``, each microbatch's rows over ``data``).
- ``make_mesh(data=-1, model=1, devices=None, ranks=None)``:
  ``devices=None`` takes :func:`global_devices` — every CUDA card of every
  process, and an error without one.
  ``$QST_TORCH_VIRTUAL_DEVICES=n`` (read here only) makes that list n long,
  round-robin over the cards: the counterpart of XLA's
  ``--xla_force_host_platform_device_count``.
- ``batch_sharding`` / ``replicated`` / ``corpus_sharding``: (mesh, spec)
  descriptors that ``SentenceEncoder(out_sharding=)`` and the indexes read.
- The shard order is ``flat_shard_index``: row-major over (data, model);
  shard i holds rows [i·shard_rows, (i+1)·shard_rows), which is how
  ``P((DATA_AXIS, MODEL_AXIS))`` lays out a corpus.
- ``initialize_distributed`` is the multi-host hook behind the JAX
  package's environment gate (``torch.distributed.init_process_group``);
  ``global_array_from_local`` places this process's rows on the positions
  it owns.

Not carried: ``enable_compilation_cache`` (there is no XLA compilation).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"

VIRTUAL_DEVICES_ENV = "QST_TORCH_VIRTUAL_DEVICES"

COORDINATOR_ENV = "QST_COORDINATOR_ADDRESS"
NUM_PROCESSES_ENV = "QST_NUM_PROCESSES"
PROCESS_ID_ENV = "QST_PROCESS_ID"


class Mesh:
    """A 2-D grid of devices with two named axes, ``("data", "model")``
    unless ``axis_names`` says otherwise (``make_pipe_mesh``: ``("pipe",
    "data")``).

    ``devices`` is row-major: position i = row·columns + column
    (``flat_shard_index``). ``shape`` maps each axis name to its size, as
    the JAX mesh's does. ``ranks`` (row-major, the same length) holds the
    process that owns each position, ascending; by default this process
    owns them all. ``rank`` is this process's."""

    def __init__(self, grid: Sequence[Sequence[Any]],
                 axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
                 ranks: Optional[Sequence[int]] = None):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
            raise ValueError(f"a mesh has two distinct axis names, got {axis_names}")
        self.grid = rows
        self.devices: List[torch.device] = [d for row in rows for d in row]
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: len(rows), self.axis_names[1]: len(rows[0])}
        self.rank = _group()[0]
        self.ranks = [self.rank] * len(self.devices) if ranks is None else [int(r) for r in ranks]
        if len(self.ranks) != len(self.devices) or self.ranks != sorted(self.ranks):
            raise ValueError(f"ranks {self.ranks} must be ascending, one a position")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        return len(set(self.ranks)) > 1

    def owns(self, position: int) -> bool:
        """Whether this process runs flat position ``position``."""
        return self.ranks[position] == self.rank

    @property
    def home(self) -> torch.device:
        """This process's first position's device: where its replicated
        tensors and merged results live (the mesh's first device in one
        process)."""
        if self.rank not in self.ranks:
            raise ValueError(f"process {self.rank} owns no position of {self}")
        return self.devices[self.ranks.index(self.rank)]

    def require_whole_rows(self, what: str) -> None:
        """Raise ``NotImplementedError`` for ``what`` when a row of the mesh
        (one data shard's positions along the second axis) is split across
        processes: only the first axis crosses processes."""
        cols = len(self.grid[0])
        split = [r for r in range(len(self.grid))
                 if len(set(self.ranks[r * cols:(r + 1) * cols])) > 1]
        if split:
            raise NotImplementedError(
                f"{what} on a mesh whose rows {split} are split across processes "
                f"(ranks {self.ranks}, shape {self.shape}) is not ported: give the "
                f"{self.axis_names[1]!r} axis a size that divides each process's "
                f"device count, so that every row lies in one process")

    def refuse_across_processes(self, what: str) -> None:
        """Raise ``NotImplementedError`` naming ``what`` on a mesh that spans
        processes."""
        if self.spans_processes:
            raise NotImplementedError(
                f"{what} on a mesh that spans processes (ranks {self.ranks}) is not "
                f"ported: its stage-to-stage transfers would need point-to-point "
                f"sends, which gloo lacks for CUDA tensors")

    def flat_shard_index(self, row_index: int, column_index: int) -> int:
        return row_index * len(self.grid[0]) + column_index

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The device of each shard along one axis: along the first, each
        row's first position (a batch shard is replicated over the second
        axis); along the second, the positions of this process's first row."""
        if axis == self.axis_names[0]:
            return [row[0] for row in self.grid]
        if axis == self.axis_names[1]:
            return list(self.grid[self.ranks.index(self.rank) // len(self.grid[0])
                                  if self.rank in self.ranks else 0])
        raise ValueError(f"unknown mesh axis {axis!r}; axes {self.axis_names}")

    def axis_ranks(self, axis: str) -> List[int]:
        """The owning process of each shard along one axis (``axis_devices``'
        positions)."""
        cols = len(self.grid[0])
        if axis == self.axis_names[0]:
            return [self.ranks[r * cols] for r in range(len(self.grid))]
        if axis == self.axis_names[1]:
            return [self.rank] * cols if self.rank in self.ranks else self.ranks[:cols]
        raise ValueError(f"unknown mesh axis {axis!r}; axes {self.axis_names}")

    def device_at(self, **index: int) -> torch.device:
        """The device at one position, by axis name (an axis left out: its
        first position): ``mesh.device_at(data=i, model=j)``."""
        if any(a not in self.shape for a in index):
            raise ValueError(f"unknown mesh axis in {sorted(index)}; axes {self.axis_names}")
        return self.grid[index.get(self.axis_names[0], 0)][index.get(self.axis_names[1], 0)]

    def distinct_devices(self) -> List[torch.device]:
        """The devices of this process's positions without repeats, in
        first-appearance order."""
        return list(dict.fromkeys(d for i, d in enumerate(self.devices) if self.owns(i)))

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and other.grid == self.grid
                and other.axis_names == self.axis_names and other.ranks == self.ranks)

    def __repr__(self) -> str:
        ranks = f", ranks={self.ranks}" if self.spans_processes else ""
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}{ranks})"


def as_mesh(mesh: Any) -> Optional[Mesh]:
    """``mesh`` if it is a :class:`Mesh`, None for None; anything else
    raises ``TypeError`` (the sharded paths take only a port mesh)."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    raise TypeError(f"mesh must be a qst_tpu_torch.core.meshes.Mesh (make_mesh), "
                    f"got {type(mesh).__name__}")


def sharded(mesh: Any) -> Optional[Mesh]:
    """The mesh a sharded path runs on: None when there is no mesh or it has
    one position (a 1x1 mesh runs the unsharded path, as in the JAX
    package)."""
    mesh = as_mesh(mesh)
    return mesh if mesh is not None and mesh.size > 1 else None


def visible_devices(device: Any = None) -> List[torch.device]:
    """The device list a mesh is made from. ``device=None`` or ``"cuda"``:
    every CUDA card (an error without one); ``"cuda:i"``: that card;
    ``"cpu"``: the host. ``$QST_TORCH_VIRTUAL_DEVICES=n`` makes the list n
    long, round-robin over those devices."""
    dev = None if device is None else torch.device(device)
    if dev is not None and (dev.type != "cuda" or dev.index is not None):
        base = [dev]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: qst_tpu_torch runs on the GPU by default — pass "
                "device='cpu' (or --device cpu) to run on the host")
        base = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = os.environ.get(VIRTUAL_DEVICES_ENV)
    if not n:
        return base
    if int(n) < 1:
        raise ValueError(f"${VIRTUAL_DEVICES_ENV} must be >= 1, got {n}")
    return [base[i % len(base)] for i in range(int(n))]


def global_devices(device: Any = None) -> Tuple[List[torch.device], List[int]]:
    """→ (devices, ranks): every process's :func:`visible_devices` gathered
    in rank order, each with its owning rank — ``jax.devices()`` of a
    multi-process runtime. One process: its own list, rank 0 throughout.
    A device is named as its own process names it."""
    local = visible_devices(device)
    rank, world = _group()
    if world == 1:
        return local, [rank] * len(local)
    import torch.distributed as dist

    names: List[Any] = [None] * world
    dist.all_gather_object(names, [str(d) for d in local])
    return ([torch.device(n) for ns in names for n in ns],
            [r for r, ns in enumerate(names) for _ in ns])


def _layout(devices: Optional[Sequence[Any]], ranks: Optional[Sequence[int]]
            ) -> Tuple[List[torch.device], Optional[List[int]]]:
    if devices is None:
        return global_devices()
    return [torch.device(d) for d in devices], None if ranks is None else list(ranks)


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence[Any]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A 2-D (data, model) mesh over the devices (default
    :func:`global_devices`: in a group of processes, every process's cards
    with their ranks; ``*global_devices("cpu")`` for the host's). ``data=-1``
    takes every device ``model`` leaves; a smaller-than-world mesh takes a
    device prefix. ``devices`` given without ``ranks``: this process owns
    them all."""
    devs, owners = _layout(devices, ranks)
    n = len(devs)
    if model <= 0:
        raise ValueError(f"model axis must be >= 1, got {model}")
    if data <= 0:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    return Mesh([devs[r * model:(r + 1) * model] for r in range(data)],
                ranks=None if owners is None else owners[:data * model])


def make_pipe_mesh(pipe: int, data: int = 1,
                   devices: Optional[Sequence[Any]] = None,
                   ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A 2-D ("pipe", "data") mesh (``qst_tpu/parallel/pipeline.py:59``):
    stage p's row holds the devices of its ``data`` shards."""
    devs, owners = _layout(devices, ranks)
    if pipe < 1 or data < 1:
        raise ValueError(f"mesh {pipe}x{data}: both axes must be >= 1")
    if pipe * data > len(devs):
        raise ValueError(f"mesh {pipe}x{data} needs more than {len(devs)} devices")
    return Mesh([devs[p * data:(p + 1) * data] for p in range(pipe)], (PIPE_AXIS, DATA_AXIS),
                ranks=None if owners is None else owners[:pipe * data])


def single_device_mesh(device: Any = None) -> Mesh:
    return make_mesh(data=1, model=1, devices=visible_devices(device)[:1])


@dataclass(frozen=True)
class Sharding:
    """How a tensor's leading dimension is laid over a mesh: ``spec`` is
    ``()`` (replicated), ``("data",)`` (batch) or ``(("data", "model"),)``
    (corpus) — the ``NamedSharding`` specs the JAX package uses."""

    mesh: Mesh
    spec: Tuple = ()

    def shard_devices(self) -> List[torch.device]:
        """The device of each block of the leading dimension, in order
        (one entry for a replicated tensor: the mesh's home device)."""
        if not self.spec:
            return [self.mesh.home]
        if self.spec[0] == DATA_AXIS:
            return self.mesh.axis_devices(DATA_AXIS)
        if tuple(self.spec[0]) == (DATA_AXIS, MODEL_AXIS):
            return list(self.mesh.devices)
        raise ValueError(f"unsupported spec {self.spec}")


def batch_sharding(mesh: Mesh) -> Sharding:
    """Split the leading (batch) dimension over the data axis."""
    return Sharding(as_mesh(mesh), (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(as_mesh(mesh), ())


def corpus_sharding(mesh: Mesh) -> Sharding:
    """Split a (num_docs, dim) corpus over all the mesh's devices on the
    doc axis — the layout of the sharded exact search."""
    return Sharding(as_mesh(mesh), ((DATA_AXIS, MODEL_AXIS),))


def _group() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_shard_bounds(n: int, process_index: Optional[int] = None,
                         process_count: Optional[int] = None) -> Tuple[int, int]:
    """This process's contiguous slice [start, stop) of n items; uneven
    remainders go to the leading processes. The defaults are the rank and
    world size of an initialized ``torch.distributed`` group, else (0, 1)."""
    rank, world = _group()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} outside [0, {pc})")
    base, rem = divmod(n, pc)
    start = pi * base + min(pi, rem)
    return start, start + base + (1 if pi < rem else 0)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: Any = None, backend: Optional[str] = None) -> bool:
    """Multi-process hook, gated as in the JAX package: it acts when the
    coordinator is given or ``$QST_COORDINATOR_ADDRESS`` is set (with
    ``$QST_NUM_PROCESSES`` and ``$QST_PROCESS_ID``); ``auto`` takes
    ``torch.distributed``'s ``env://`` variables. ``backend`` defaults to
    ``gloo`` for a CPU ``device``, else ``nccl``; processes that share one
    card pass ``backend="gloo"``. → True when a group was created, False
    when the gate is closed (one process: the default)."""
    coordinator_address = coordinator_address or os.environ.get(COORDINATOR_ENV)
    if not coordinator_address:
        return False
    import torch.distributed as dist

    dev = None if device is None else torch.device(device)
    if backend is None:
        backend = "gloo" if dev is not None and dev.type == "cpu" else "nccl"
    if coordinator_address == "auto":
        dist.init_process_group(backend, init_method="env://")
        return True
    if num_processes is None:
        if NUM_PROCESSES_ENV not in os.environ:
            raise ValueError(
                f"{COORDINATOR_ENV} is set but {NUM_PROCESSES_ENV} is not; "
                f"set {NUM_PROCESSES_ENV} and {PROCESS_ID_ENV} too (or use "
                f"{COORDINATOR_ENV}=auto for env:// discovery)")
        num_processes = int(os.environ[NUM_PROCESSES_ENV])
    if process_id is None:
        if PROCESS_ID_ENV not in os.environ:
            raise ValueError(
                f"{COORDINATOR_ENV} is set but {PROCESS_ID_ENV} is not; "
                f"set {NUM_PROCESSES_ENV} and {PROCESS_ID_ENV} too")
        process_id = int(os.environ[PROCESS_ID_ENV])
    address = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)
    return True


def is_primary() -> bool:
    """Whether this is process 0 of the group (or the only process): the
    one that writes what every process would write alike."""
    return _group()[0] == 0


def barrier() -> None:
    """Wait for every process of the group (nothing in one process)."""
    if _group()[1] > 1:
        import torch.distributed as dist

        dist.barrier()


# ----------------------------------------------------------------------------
# collectives in rank order
# ----------------------------------------------------------------------------

def _comm_device() -> torch.device:
    """Where the group's small host-side tensors live: the host for gloo,
    this process's card for nccl."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_ordered(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (equal dtype and rank, any shape), in rank
    order, on every process: one ``broadcast`` from each rank in turn — its
    shape, then its values into a tensor on ``t``'s device. One process:
    ``[t]``."""
    rank, world = _group()
    if world == 1:
        return [t]
    import torch.distributed as dist

    t = t.contiguous()
    shape = torch.tensor(t.shape, dtype=torch.int64, device=_comm_device())
    out = []
    for r in range(world):
        dims = shape.clone() if r == rank else torch.empty_like(shape)
        dist.broadcast(dims, src=r)
        buf = t if r == rank else torch.empty(tuple(dims.tolist()), dtype=t.dtype,
                                                device=t.device)
        dist.broadcast(buf, src=r)
        out.append(buf)
    return out


class _GatherRows(torch.autograd.Function):
    """Rows of every process, concatenated in rank order; the backward
    keeps this process's rows of the incoming gradient."""

    @staticmethod
    def forward(ctx, local):
        parts = gather_ordered(local)
        rank = _group()[0]
        ctx.start = sum(p.shape[0] for p in parts[:rank])
        ctx.stop = ctx.start + local.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.start:ctx.stop]


def gather_rows(local: torch.Tensor) -> torch.Tensor:
    """This process's rows and every other process's, in rank order, on
    every process (differentiable: the gradient of this process's rows is
    its slice). One process: ``local`` itself."""
    return local if _group()[1] == 1 else _GatherRows.apply(local)


class GlobalArray(list):
    """A tensor laid out over a mesh (``global_array_from_local``): one
    entry a block of the split dimension (a replicated spec: one a mesh
    position), the block on its position's device where this process owns
    it and None where another does. ``shape`` is the global shape, ``dim``
    the split dimension (None: replicated)."""

    def __init__(self, blocks, shape, dim: Optional[int]):
        super().__init__(blocks)
        self.shape = tuple(shape)
        self.dim = dim

    def full(self) -> torch.Tensor:
        """The whole tensor on this process's first block's device: the
        blocks of every process gathered in order."""
        own = [b for b in self if b is not None]
        if self.dim is None:
            return own[0]
        local = torch.cat(own, dim=self.dim)
        if len(own) == len(self):
            return local
        return torch.cat(gather_ordered(local.movedim(self.dim, 0)), 0).movedim(0, self.dim)


def _split_spec(spec: Tuple) -> Tuple[Optional[int], Tuple[str, ...]]:
    """→ (the split dimension or None, the mesh axes that split it)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            return dim, (entry,) if isinstance(entry, str) else tuple(entry)
    return None, ()


def global_array_from_local(local, mesh: Mesh, spec: Tuple = ()) -> GlobalArray:
    """Place this process's rows on the mesh as ``Sharding(mesh, spec)``
    lays them out — ``jax.make_array_from_process_local_data``. ``spec``
    names, per dimension, the mesh axes that split it: ``("data",)`` or
    ``(None, "data")`` (a data shard's block on the row's first position),
    ``(("data", "model"),)`` (one block a position), ``()`` (replicated:
    every process passes the whole value). Each process passes the rows of
    the blocks it owns, in order (``process_shard_bounds``); the global
    size is their sum over the group. → a :class:`GlobalArray`."""
    x = torch.as_tensor(local)
    mesh = as_mesh(mesh)
    dim, axes = _split_spec(tuple(spec))
    if dim is None:
        return GlobalArray([x.to(d) if mesh.owns(i) else None
                            for i, d in enumerate(mesh.devices)], x.shape, None)
    if axes == (DATA_AXIS,) and DATA_AXIS in mesh.shape:
        mesh.require_whole_rows("a data-sharded array")
        devs, owners = mesh.axis_devices(DATA_AXIS), mesh.axis_ranks(DATA_AXIS)
    elif set(axes) == set(mesh.axis_names) and len(axes) == 2:
        devs, owners = list(mesh.devices), list(mesh.ranks)
    else:
        raise ValueError(f"unsupported spec {spec}")
    counts = [int(c) for c in gather_ordered(torch.tensor([x.shape[dim]]))]
    total = sum(counts)
    if total % len(devs):
        raise ValueError(f"{total} rows do not split into {len(devs)} shards")
    size = total // len(devs)
    mine = [i for i, r in enumerate(owners) if r == mesh.rank]
    if x.shape[dim] != size * len(mine):
        raise ValueError(f"this process passed {x.shape[dim]} rows for {len(mine)} blocks "
                         f"of {size}")
    pieces = iter(x.split(size, dim=dim)) if mine else iter(())
    blocks = [next(pieces).to(devs[i]) if i in mine else None for i in range(len(devs))]
    shape = list(x.shape)
    shape[dim] = total
    return GlobalArray(blocks, shape, dim)


@dataclass(frozen=True)
class DTypePolicy:
    """Mixed precision: parameters in f32, compute in ``compute_dtype``,
    outputs in f32."""

    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype

    def cast_compute(self, x):
        """Floating tensors of a nested dict / list / tuple cast to the
        compute dtype; everything else as it was."""
        if isinstance(x, torch.Tensor):
            return x.to(self.compute_dtype) if x.is_floating_point() else x
        if isinstance(x, dict):
            return type(x)((k, self.cast_compute(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            out = [self.cast_compute(v) for v in x]
            return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
        return x


def dtype_policy(compute: str = "bfloat16") -> DTypePolicy:
    return DTypePolicy(param_dtype=torch.float32, compute_dtype=getattr(torch, compute),
                       output_dtype=torch.float32)


# ----------------------------------------------------------------------------
# the shard loop and the merge
# ----------------------------------------------------------------------------

def shard_rows_for(n: int, n_shards: int, quantum: int) -> int:
    """Rows a shard holds when n rows split over n_shards: the ceiling,
    rounded up to ``quantum``."""
    return -(-n // (n_shards * quantum)) * quantum


class RowShards:
    """A tensor's leading rows split into equal blocks, block i on
    ``mesh.devices[i]`` (``corpus_sharding``'s layout). ``full`` holds the
    padded rows (a multiple of ``rows`` plus ``extra``). Each block is
    rows [i·rows, (i+1)·rows + extra): ``extra`` trailing rows a shard may
    address past its own (a sentinel). When every shard's device is
    ``full``'s in one process, the blocks are views of it and nothing is
    copied; otherwise each block is a copy in storage of its own, so that
    ``full`` is released. On a mesh that spans processes a process keeps
    only the blocks it owns (None for the others)."""

    def __init__(self, full: torch.Tensor, mesh: Mesh, rows: int, extra: int = 0):
        if full.shape[0] != rows * mesh.size + extra:
            raise ValueError(f"{full.shape[0]} rows != {mesh.size} shards x {rows} + {extra}")
        self.mesh, self.rows, self.extra = mesh, rows, extra
        keep = not mesh.spans_processes and all(d == full.device for d in mesh.devices)
        self.blocks = [full[i * rows:(i + 1) * rows + extra].to(d, copy=not keep)
                       if mesh.owns(i) else None for i, d in enumerate(mesh.devices)]
        self.full = full if keep else None

    @property
    def local(self) -> torch.Tensor:
        """This process's first block."""
        return next(b for b in self.blocks if b is not None)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    def gather(self) -> torch.Tensor:
        """The padded rows as one tensor on the mesh's home device (a view
        when the blocks share one; a copy otherwise), every process's
        blocks gathered in order."""
        if self.full is not None:
            return self.full[:self.rows * self.mesh.size]
        dev = self.mesh.home
        local = torch.cat([b[:self.rows].to(dev) for b in self.blocks if b is not None])
        return torch.cat(gather_ordered(local)) if self.mesh.spans_processes else local


def gathered(x: Union[torch.Tensor, RowShards]) -> torch.Tensor:
    """An index's stored rows as one tensor: a tensor as it is, a
    :class:`RowShards` through :meth:`RowShards.gather` (padded rows)."""
    return x.gather() if isinstance(x, RowShards) else x


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``, asynchronously where that is safe: a copy to a
    card is queued behind the source's work (a copy to the host waits)."""
    return x.to(device, non_blocking=device.type == "cuda")


def replicate(x: torch.Tensor, mesh: Mesh) -> dict:
    """{device: x on it} for each distinct device of this process's
    positions — a replicated operand is sent once a device, not once a
    shard."""
    return {d: to_device(x, d) for d in mesh.distinct_devices()}


def shard_loop(mesh: Mesh, fn: Callable[[int, torch.device], Any],
               axis: Optional[str] = None) -> list:
    """Run ``fn(shard_index, device)`` for every shard in ``flat_shard_index``
    order, each on its device (``torch.cuda.device`` context for a card);
    with ``axis``, for each position along that axis only (its device:
    ``axis_devices``). A shard another process owns is not run: its entry
    is None. Nothing here waits for a device: a shard's work is queued
    behind the previous shard's without a host sync, so offsets and counts
    the body needs are host ints."""
    out = []
    devices = mesh.devices if axis is None else mesh.axis_devices(axis)
    owners = mesh.ranks if axis is None else mesh.axis_ranks(axis)
    for i, (dev, owner) in enumerate(zip(devices, owners)):
        if owner != mesh.rank:
            out.append(None)
        elif dev.type == "cuda":
            with torch.cuda.device(dev):
                out.append(fn(i, dev))
        else:
            out.append(fn(i, dev))
    return out


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, descending, the lower
    index first among equal values (``torch.topk`` promises no order among
    ties). Each f32 becomes an int64 key that orders by value, then by
    index: its bits made order-preserving (negative floats' magnitude bits
    flipped) times 2^32, plus 2^32 - 1 - index."""
    x = x.float()
    bits = x.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    index = torch.arange(x.shape[-1], device=x.device)
    key = ordered * (1 << 32) + (0xFFFFFFFF - index)
    top = key.topk(k, dim=-1).values
    top_i = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return x.gather(-1, top_i), top_i


def merge_topk(parts: Sequence[Optional[Tuple[torch.Tensor, torch.Tensor]]], k: int,
               device: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``all_gather`` + ``lax.top_k``: the per-shard
    (scores (Q, k_i), ids (Q, k_i)) concatenated in shard order on
    ``device``, then the top k with ``lax.top_k``'s order — among equal
    scores the earlier shard wins. A None part is a shard another process
    ran (``shard_loop``): every process's parts are then gathered in rank
    order, which is shard order, and each process gets the same answer.
    → (scores (Q, k') f32, ids (Q, k') int64), k' = min(k, Σ k_i)."""
    device = torch.device(device)
    own = [p for p in parts if p is not None]
    s = torch.cat([to_device(p[0], device).float() for p in own], dim=1)
    i = torch.cat([to_device(p[1], device).long() for p in own], dim=1)
    if len(own) < len(parts):
        s = torch.cat(gather_ordered(s), dim=1)
        i = torch.cat(gather_ordered(i), dim=1)
    s2, pos = top_k(s, min(k, s.shape[1]))
    return s2, torch.gather(i, 1, pos)
