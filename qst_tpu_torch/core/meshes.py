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
(``shard_loop`` gives None for the others), and where one position needs
another's values they are gathered in rank order, which is shard order:
``merge_topk`` (the candidates), ``gather_rows`` (embedding rows, with a
backward that keeps this rank's rows), ``gather_named`` (named tensors: a
split layout's checkpoint, the gradient copies of ``parallel/sharding.py``).
Every collective is a ``broadcast`` from each rank in turn
(``gather_ordered``), so its order is the ranks', never the backend's.
Between two processes a tensor goes by a hand-off (``exchange``:
point-to-point, see below): the pipeline's activations and gradients, the
ring's K/V blocks, and the partial sums of a mesh row split across
processes (``gather_columns``, ``row_scatter``, ``row_sum``; a row is one
data shard's positions along the second axis, and ``running_row`` says
which one a data-parallel loop runs). The
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

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

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
    owns them all. ``rank`` is this process's. A row may be split across
    processes (``row_ranks``): each process of it runs the row, computing
    the columns it owns."""

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

    def flat_shard_index(self, row_index: int, column_index: int) -> int:
        return row_index * len(self.grid[0]) + column_index

    def row_ranks(self, row: int) -> List[int]:
        """The owning process of each position of row ``row`` (one data
        shard's positions along the second axis), in column order."""
        cols = len(self.grid[0])
        return self.ranks[row * cols:(row + 1) * cols]

    def in_row(self, row: int) -> bool:
        """Whether this process owns a position of row ``row``: then it
        runs that row (a row split across processes is run by each of its
        processes, each computing the columns it owns)."""
        return self.rank in self.row_ranks(row)

    def row_home(self, row: int) -> torch.device:
        """This process's first position of row ``row``: where it keeps the
        row's replicated tensors (the row's first device when it owns the
        whole row)."""
        return self.grid[row][self.row_ranks(row).index(self.rank)]

    def _own_first_row(self) -> int:
        rows = [r for r in range(len(self.grid)) if self.in_row(r)]
        return rows[0] if rows else 0

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The device of each shard along one axis: along the first, each
        row's first position (a batch shard is replicated over the second
        axis); along the second, for each column this process's first
        position in it — the columns of this process's first row when it
        owns whole rows. A column it owns no position of: that column's
        position in its first row (``axis_ranks`` names the owner)."""
        if axis == self.axis_names[0]:
            return [row[0] for row in self.grid]
        if axis == self.axis_names[1]:
            first = self._own_first_row()
            out = []
            for j in range(len(self.grid[0])):
                mine = [r for r in range(len(self.grid)) if self.owns(self.flat_shard_index(r, j))]
                out.append(self.grid[mine[0] if mine else first][j])
            return out
        raise ValueError(f"unknown mesh axis {axis!r}; axes {self.axis_names}")

    def axis_ranks(self, axis: str) -> List[int]:
        """The owning process of each shard along one axis (``axis_devices``'
        positions): a row's first position's owner along the first axis;
        along the second, this process for every column it owns a position
        of."""
        cols = len(self.grid[0])
        if axis == self.axis_names[0]:
            return [self.ranks[r * cols] for r in range(len(self.grid))]
        if axis == self.axis_names[1]:
            first = self.row_ranks(self._own_first_row())
            return [self.rank if any(self.owns(self.flat_shard_index(r, j))
                                     for r in range(len(self.grid))) else first[j]
                    for j in range(cols)]
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


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor on its device (a view where
    ``t`` is contiguous): what a transfer carries, whatever the dtype."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(raw: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    return raw.view(dtype).reshape(shape)


# ----------------------------------------------------------------------------
# point-to-point hand-offs
# ----------------------------------------------------------------------------
# A hand-off carries a tensor from one process to another and nothing else:
# the pipeline's activations and their gradients from stage to stage, the
# ring's K/V blocks, a split mesh row's partial sums. How it rides:
#
# - under NCCL, the card's bytes go by ``isend``/``irecv``;
# - under gloo, ``isend``/``irecv`` take CPU tensors only, so a card's
#   tensor is staged through host memory: copied off the card on the
#   sender, received into host memory and copied onto the receiver's card.
#   Only the bytes pass through the host; nothing is computed there.
#
# Two rules keep a group of processes from hanging:
#
# - every transfer is posted without blocking and only then waited for
#   (``exchange``): two processes that each send to the other — the ring's
#   rotation, the circular schedule's wrap beside a forward hand-off —
#   would deadlock on two blocking sends;
# - two processes post their transfers to each other in one order, the
#   order of the list every process builds alike, since gloo and NCCL match
#   the messages between a pair in the order they were posted.
#
# No hand-off makes a process group: ``dist.new_group`` is collective over
# the whole world (every process, member or not, must call it, in the same
# order), so a pair group made lazily by the two processes that need it
# would hang the others; point-to-point calls on the default group need none.

class _Pending:
    """A transfer posted by ``exchange``: ``wait()`` → the received tensor
    (``like``'s shape, dtype and device) on the receiver, the sent tensor on
    the sender. ``buf`` (the bytes on the wire) lives until then."""

    def __init__(self, work, buf: torch.Tensor, like: Optional[torch.Tensor] = None,
                 sent: Optional[torch.Tensor] = None):
        self.work, self.buf, self.like, self.sent = work, buf, like, sent

    def wait(self) -> torch.Tensor:
        self.work.wait()
        if self.like is None:
            return self.sent
        return _from_bytes(self.buf, self.like.shape, self.like.dtype).to(self.like.device)


def exchange(transfers: Sequence[Tuple[Optional[torch.Tensor], int, int]]
             ) -> List[Optional[torch.Tensor]]:
    """Run a list of hand-offs ``(t, src, dst)``, every process of the
    group passing the same list (the same order: see above). On ``src``,
    ``t`` is the tensor to send; on ``dst``, a tensor of the shape, dtype
    and device to receive into (its values unused); elsewhere it may be
    None. Every send is posted, then every receive, then all are waited
    for. → per transfer: the received tensor on ``dst``, ``t`` itself where
    ``src == dst`` is this process, None elsewhere."""
    rank = _group()[0]
    posted: List[Optional[_Pending]] = [None] * len(transfers)
    if any(src != dst and rank in (src, dst) for _, src, dst in transfers):
        import torch.distributed as dist

        host = dist.get_backend() != "nccl"
        for i, (t, src, dst) in enumerate(transfers):
            if src == rank and dst != rank:
                raw = _bytes(t).cpu() if host else _bytes(t)
                posted[i] = _Pending(dist.isend(raw, dst), raw, sent=t)
        for i, (t, src, dst) in enumerate(transfers):
            if dst == rank and src != rank:
                raw = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                                  device="cpu" if host else t.device)
                posted[i] = _Pending(dist.irecv(raw, src), raw, like=t)
    return [t if src == dst == rank else posted[i].wait() if posted[i] is not None else None
            for i, (t, src, dst) in enumerate(transfers)]


def gather_columns(parts: Dict[int, torch.Tensor], owners: Sequence[int]
                   ) -> List[torch.Tensor]:
    """Every column's tensor of one mesh row, in column order, on every
    process that owns a position of the row: this process's columns from
    ``parts`` ({column: tensor}, one shape and dtype for all), each other
    process's handed off to it (each member sends its columns, stacked, to
    every other member; the members' transfers in rank order). A row that
    lies in this process: ``parts`` in order, nothing sent."""
    rank = _group()[0]
    members = sorted(set(owners))
    mine = [j for j, r in enumerate(owners) if r == rank]
    if members == [rank]:
        return [parts[j] for j in mine]
    like = parts[mine[0]]
    own = torch.stack([parts[j] for j in mine])
    transfers = []
    for src in members:
        n = sum(1 for r in owners if r == src)
        for dst in members:
            if dst != src:
                t = own if src == rank else like.new_empty((n, *like.shape))
                transfers.append((t, src, dst))
    got = exchange(transfers)
    stacks = {rank: own}
    for (_, src, dst), t in zip(transfers, got):
        if dst == rank:
            stacks[src] = t
    taken = {r: 0 for r in members}
    out = []
    for r in owners:
        out.append(stacks[r][taken[r]])
        taken[r] += 1
    return out


def gather_named(named: Dict[Any, torch.Tensor], device: Any = None) -> Dict[Any, torch.Tensor]:
    """Every process's ``named`` tensors, united on every process (keys may
    be any picklable value; a key more than one process gives: the lowest
    rank's): the names, shapes and dtypes by ``all_gather_object``, the
    bytes by one ``gather_ordered`` on ``device`` (default: the first
    tensor's, else the group's), unpacked bit for bit. One process:
    ``named``."""
    rank, world = _group()
    if world == 1:
        return dict(named)
    import torch.distributed as dist

    if device is None:
        device = next(iter(named.values())).device if named else _comm_device()
    meta = [(k, tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in named.items()]
    metas: List[Any] = [None] * world
    dist.all_gather_object(metas, meta)
    blob = (torch.cat([_bytes(t).to(device) for t in named.values()]) if named
            else torch.empty(0, dtype=torch.uint8, device=device))
    out: Dict[Any, torch.Tensor] = {}
    for r, raw in enumerate(gather_ordered(blob)):
        start = 0
        for k, shape, dtype in metas[r]:
            dt = getattr(torch, dtype)
            n = int(torch.Size(shape).numel()) * torch.empty((), dtype=dt).element_size()
            if k not in out:
                out[k] = named[k] if r == rank else _from_bytes(
                    raw[start:start + n].clone(), shape, dt)
            start += n
    return out


class _RowScatter(torch.autograd.Function):
    """``x`` to each column of a mesh row this process owns, ``uses``
    copies a column (with ``dim``: column j's chunk of it along ``dim``),
    each on its device, then with ``residual`` one more copy of ``x`` for
    the input's own use beside the row. The backward gathers every column's
    gradients over the row's processes (``gather_columns``) and forms the
    one gradient of ``x`` that one process forms: with ``dim`` the columns'
    concatenated; else the residual's first, then every use's added in
    reverse order of use, the last column's last use first — the order in
    which autograd accumulates the uses of one tensor in one process."""

    @staticmethod
    def forward(ctx, owners, devices, dim, uses, residual, x):
        ctx.owners, ctx.dim, ctx.uses, ctx.home = list(owners), dim, uses, x.device
        ctx.residual = residual
        rank = _group()[0]
        mine = [j for j, r in enumerate(owners) if r == rank]
        outs = []
        for j, dev in zip(mine, devices):
            y = (x if dim is None else x.chunk(len(owners), dim)[j]).to(dev)
            outs += [y.view_as(y) if y is x or uses > 1 else y for _ in range(uses)]
        if residual:
            outs.append(x.view_as(x))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        rank = _group()[0]
        mine = [j for j, r in enumerate(ctx.owners) if r == rank]
        u = ctx.uses
        full = gather_columns({j: torch.stack(grads[k * u:(k + 1) * u])
                               for k, j in enumerate(mine)}, ctx.owners)
        if ctx.dim is not None:
            return (None,) * 5 + (torch.cat([g[0].to(ctx.home) for g in full], ctx.dim),)
        uses = [g.to(ctx.home) for col in full for g in col.unbind(0)][::-1]
        g = grads[-1] if ctx.residual else uses.pop(0)
        for gi in uses:
            g = g + gi
        return (None,) * 5 + (g,)


def row_scatter(x: torch.Tensor, owners: Sequence[int], devices: Sequence[Any],
                dim: Optional[int] = None, uses: int = 1,
                residual: bool = False) -> Tuple[torch.Tensor, ...]:
    """``x`` for each column of a mesh row whose owner (``owners``, the
    row's ranks) is this process, on ``devices`` (one a column it owns):
    ``uses`` copies a column, column-major, then with ``residual`` a copy
    for ``x``'s own use beside the row (a residual connection); with ``dim``
    column j's chunk — a replicated operand of a tensor-parallel layer, or
    one split over its heads. Its gradient is the conjugate of
    :func:`row_sum`: every use's, over the row's processes, added in the
    order one process's autograd adds them (``_RowScatter``)."""
    return _RowScatter.apply(list(owners), list(devices), dim, uses, residual, x)


class _RowSum(torch.autograd.Function):
    """This process's columns' partial sums of a mesh row and every other
    process's (``gather_columns``), added in column order on ``home``. The
    backward gives each of this process's partials the incoming gradient."""

    @staticmethod
    def forward(ctx, owners, home, *parts):
        rank = _group()[0]
        mine = [j for j, r in enumerate(owners) if r == rank]
        ctx.devices = [p.device for p in parts]
        full = gather_columns(dict(zip(mine, parts)), owners)
        out = full[0].to(home)
        for p in full[1:]:
            out = out + p.to(home)
        return out.view_as(out) if any(out is p for p in parts) else out

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *[grad.to(d) for d in ctx.devices])


def row_sum(parts: Sequence[torch.Tensor], owners: Sequence[int], home: Any) -> torch.Tensor:
    """The sum over a mesh row's columns of their partials, in column order,
    on ``home``: ``parts`` are this process's columns' (in column order),
    the others come from their owners (``owners``, the row's ranks) — the
    partial sums of a tensor-parallel layer, which cross processes when the
    row does."""
    return _RowSum.apply(list(owners), torch.device(home), *parts)


# ----------------------------------------------------------------------------
# the row a data-parallel shard loop runs
# ----------------------------------------------------------------------------
_ROW: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar("qst_mesh_row",
                                                                       default=None)


@contextlib.contextmanager
def running_row(row: int):
    """While entered, :func:`current_row` is ``row``: a data-parallel loop
    says which data shard's row it runs, so that a tensor-parallel layer
    knows which processes own that row's columns."""
    token = _ROW.set(row)
    try:
        yield
    finally:
        _ROW.reset(token)


def current_row(mesh: Mesh) -> int:
    """The row being run (:func:`running_row`), else this process's first
    row of ``mesh``."""
    row = _ROW.get()
    return mesh._own_first_row() if row is None else row


class GlobalArray(list):
    """A tensor laid out over a mesh (``global_array_from_local``): one
    entry a block of the split dimension (a replicated spec: one a mesh
    position), the block on this process's device for it where this
    process holds it and None where only others do. ``shape`` is the
    global shape, ``dim`` the split dimension (None: replicated).
    ``lead[i]``: this process is block i's first holder (a data shard whose
    mesh row spans processes is held by each of them), which gives it to
    ``full``."""

    def __init__(self, blocks, shape, dim: Optional[int], lead: Optional[Sequence[bool]] = None,
                 whole: Optional[bool] = None):
        super().__init__(blocks)
        self.shape = tuple(shape)
        self.dim = dim
        self.lead = [b is not None for b in blocks] if lead is None else list(lead)
        # every process holds every block: ``full`` gathers nothing
        self.whole = all(b is not None for b in blocks) if whole is None else whole

    def full(self) -> torch.Tensor:
        """The whole tensor on this process's first block's device: the
        blocks of every process gathered in order, each from its first
        holder (every process calls this together unless each holds every
        block)."""
        own = [b for b in self if b is not None]
        if self.dim is None:
            return own[0]
        if self.whole:
            return torch.cat(own, dim=self.dim)
        led = [b for b, first in zip(self, self.lead) if b is not None and first]
        local = torch.cat(led, dim=self.dim) if led else own[0].narrow(self.dim, 0, 0)
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
    ``(None, "data")`` (a data shard's block on its row), ``(("data",
    "model"),)`` (one block a position), ``()`` (replicated: every process
    passes the whole value). Each process passes the rows of the blocks it
    holds, in order (``process_shard_bounds`` where each block has one
    holder): a data shard whose mesh row is split across processes is
    passed by each process of the row, the same block from each. → a
    :class:`GlobalArray`."""
    x = torch.as_tensor(local)
    mesh = as_mesh(mesh)
    dim, axes = _split_spec(tuple(spec))
    if dim is None:
        return GlobalArray([x.to(d) if mesh.owns(i) else None
                            for i, d in enumerate(mesh.devices)], x.shape, None)
    if axes == (DATA_AXIS,) and DATA_AXIS in mesh.shape:
        n = mesh.shape[DATA_AXIS]
        holders = [sorted(set(mesh.row_ranks(i))) for i in range(n)]
        devs = [mesh.row_home(i) if mesh.in_row(i) else None for i in range(n)]
    elif set(axes) == set(mesh.axis_names) and len(axes) == 2:
        holders = [[r] for r in mesh.ranks]
        devs = list(mesh.devices)
    else:
        raise ValueError(f"unsupported spec {spec}")
    counts = [int(c) for c in gather_ordered(torch.tensor([x.shape[dim]]))]
    held = [sum(1 for h in holders if r in h) for r in range(len(counts))]
    sizes = {c // k for c, k in zip(counts, held) if k}
    if len(sizes) != 1 or any(c != k * next(iter(sizes)) for c, k in zip(counts, held)):
        raise ValueError(f"the processes' rows {counts} do not split into blocks of one "
                         f"size ({held} blocks a process)")
    size = sizes.pop()
    mine = [i for i, h in enumerate(holders) if mesh.rank in h]
    pieces = iter(x.split(size, dim=dim)) if mine else iter(())
    blocks = [next(pieces).to(devs[i]) if i in mine else None for i in range(len(holders))]
    shape = list(x.shape)
    shape[dim] = size * len(holders)
    world = len(counts)
    return GlobalArray(blocks, shape, dim, lead=[h[0] == mesh.rank for h in holders],
                       whole=all(len(h) == world for h in holders))


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
