"""Device meshes, the shard loop and the dtype policy — counterpart of
``qst_tpu/core/meshes.py``.

The JAX package is single-controller: one process drives a
``jax.sharding.Mesh`` through ``shard_map``. The port keeps that shape
without ``torch.distributed``: a :class:`Mesh` is a (data, model) grid of
``torch.device`` s in one process, and a sharded computation is one Python
loop over the shards (:func:`shard_loop`), each shard's tensors on its own
device, the candidates merged on the mesh's first device
(:func:`merge_topk`). A mesh may name one device more than once, as the JAX
tests' eight virtual CPU devices share one host: the CPU tests and one GPU
then run the sharded code itself, and a host with several cards places the
shards on distinct ones.

- A :class:`Mesh` has two named axes: ``("data", "model")`` by default, or
  ``("pipe", "data")`` from ``make_pipe_mesh`` (the pipeline's stages over
  ``pipe``, each microbatch's rows over ``data``).
- ``make_mesh(data=-1, model=1, devices=None)``: ``devices=None`` takes
  :func:`visible_devices` — every CUDA card, and an error without one.
  ``$QST_TORCH_VIRTUAL_DEVICES=n`` (read here only) makes that list n long,
  round-robin over the cards: the counterpart of XLA's
  ``--xla_force_host_platform_device_count``.
- ``batch_sharding`` / ``replicated`` / ``corpus_sharding``: (mesh, spec)
  descriptors that ``SentenceEncoder(out_sharding=)`` and the indexes read.
- The shard order is ``flat_shard_index``: row-major over (data, model);
  shard i holds rows [i·shard_rows, (i+1)·shard_rows), which is how
  ``P((DATA_AXIS, MODEL_AXIS))`` lays out a corpus.
- ``initialize_distributed`` is the multi-host hook behind the JAX
  package's environment gate (``torch.distributed.init_process_group``:
  ``nccl`` for CUDA, ``gloo`` for the CPU). Meshes that span processes are
  not carried: ``global_array_from_local`` is the single-process form.

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
    """A 2-D grid of devices in one process with two named axes, ``("data",
    "model")`` unless ``axis_names`` says otherwise (``make_pipe_mesh``:
    ``("pipe", "data")``).

    ``devices`` is row-major: position i = row·columns + column
    (``flat_shard_index``). ``shape`` maps each axis name to its size, as
    the JAX mesh's does."""

    def __init__(self, grid: Sequence[Sequence[Any]],
                 axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)):
        rows = [[torch.device(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
            raise ValueError(f"a mesh has two distinct axis names, got {axis_names}")
        self.grid = rows
        self.devices: List[torch.device] = [d for row in rows for d in row]
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: len(rows), self.axis_names[1]: len(rows[0])}

    @property
    def size(self) -> int:
        return len(self.devices)

    def flat_shard_index(self, row_index: int, column_index: int) -> int:
        return row_index * len(self.grid[0]) + column_index

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The device of each shard along one axis (the other axis's first
        position: along ``data`` a batch shard is replicated over ``model``)."""
        if axis == self.axis_names[0]:
            return [row[0] for row in self.grid]
        if axis == self.axis_names[1]:
            return list(self.grid[0])
        raise ValueError(f"unknown mesh axis {axis!r}; axes {self.axis_names}")

    def device_at(self, **index: int) -> torch.device:
        """The device at one position, by axis name (an axis left out: its
        first position): ``mesh.device_at(data=i, model=j)``."""
        if any(a not in self.shape for a in index):
            raise ValueError(f"unknown mesh axis in {sorted(index)}; axes {self.axis_names}")
        return self.grid[index.get(self.axis_names[0], 0)][index.get(self.axis_names[1], 0)]

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices without repeats, in first-appearance order."""
        return list(dict.fromkeys(self.devices))

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and other.grid == self.grid
                and other.axis_names == self.axis_names)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


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


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A 2-D (data, model) mesh over the devices (default
    :func:`visible_devices`). ``data=-1`` takes every device ``model`` leaves;
    a smaller-than-world mesh takes a device prefix."""
    devs = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    n = len(devs)
    if model <= 0:
        raise ValueError(f"model axis must be >= 1, got {model}")
    if data <= 0:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    return Mesh([devs[r * model:(r + 1) * model] for r in range(data)])


def make_pipe_mesh(pipe: int, data: int = 1,
                   devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A 2-D ("pipe", "data") mesh (``qst_tpu/parallel/pipeline.py:59``):
    stage p's row holds the devices of its ``data`` shards."""
    devs = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    if pipe < 1 or data < 1:
        raise ValueError(f"mesh {pipe}x{data}: both axes must be >= 1")
    if pipe * data > len(devs):
        raise ValueError(f"mesh {pipe}x{data} needs more than {len(devs)} devices")
    return Mesh([devs[p * data:(p + 1) * data] for p in range(pipe)], (PIPE_AXIS, DATA_AXIS))


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
        (one entry for a replicated tensor: the mesh's first device)."""
        if not self.spec:
            return self.mesh.devices[:1]
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
                           device: Any = None) -> bool:
    """Multi-process hook, gated as in the JAX package: it acts when the
    coordinator is given or ``$QST_COORDINATOR_ADDRESS`` is set (with
    ``$QST_NUM_PROCESSES`` and ``$QST_PROCESS_ID``); ``auto`` takes
    ``torch.distributed``'s ``env://`` variables. The group's backend is
    ``gloo`` for a CPU ``device``, else ``nccl``. → True when a group was
    created, False when the gate is closed (one process: the default)."""
    coordinator_address = coordinator_address or os.environ.get(COORDINATOR_ENV)
    if not coordinator_address:
        return False
    import torch.distributed as dist

    dev = None if device is None else torch.device(device)
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


def global_array_from_local(local, mesh: Mesh, spec: Tuple = ()) -> List[torch.Tensor]:
    """Place this process's rows on the mesh as ``Sharding(mesh, spec)``
    lays them out: → one tensor per block of the leading dimension, each on
    its device (a replicated spec gives one copy per mesh device). Only
    single-process meshes: a group of more than one process raises."""
    if _group()[1] > 1:
        raise NotImplementedError("meshes across processes are not ported")
    x = torch.as_tensor(local)
    sh = Sharding(as_mesh(mesh), tuple(spec))
    if not sh.spec:
        return [x.to(d) for d in mesh.devices]
    devs = sh.shard_devices()
    if x.shape[0] % len(devs):
        raise ValueError(f"{x.shape[0]} rows do not split into {len(devs)} shards")
    return [b.to(d) for b, d in zip(x.chunk(len(devs)), devs)]


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
    ``full``'s, the blocks are views of it and nothing is copied; otherwise
    each device gets its blocks and ``full`` is released."""

    def __init__(self, full: torch.Tensor, mesh: Mesh, rows: int, extra: int = 0):
        if full.shape[0] != rows * mesh.size + extra:
            raise ValueError(f"{full.shape[0]} rows != {mesh.size} shards x {rows} + {extra}")
        self.mesh, self.rows, self.extra = mesh, rows, extra
        self.blocks = [full[i * rows:(i + 1) * rows + extra].to(d)
                       for i, d in enumerate(mesh.devices)]
        self.full = full if all(d == full.device for d in mesh.devices) else None

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def gather(self) -> torch.Tensor:
        """The padded rows as one tensor on the mesh's first device (a
        view when the blocks share one; a copy otherwise)."""
        if self.full is not None:
            return self.full[:self.rows * self.mesh.size]
        dev = self.mesh.devices[0]
        return torch.cat([b[:self.rows].to(dev) for b in self.blocks])


def gathered(x: Union[torch.Tensor, RowShards]) -> torch.Tensor:
    """An index's stored rows as one tensor: a tensor as it is, a
    :class:`RowShards` through :meth:`RowShards.gather` (padded rows)."""
    return x.gather() if isinstance(x, RowShards) else x


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``, asynchronously where that is safe: a copy to a
    card is queued behind the source's work (a copy to the host waits)."""
    return x.to(device, non_blocking=device.type == "cuda")


def replicate(x: torch.Tensor, mesh: Mesh) -> dict:
    """{device: x on it} for each distinct device of the mesh — a
    replicated operand is sent once a device, not once a shard."""
    return {d: to_device(x, d) for d in mesh.distinct_devices()}


def shard_loop(mesh: Mesh, fn: Callable[[int, torch.device], Any],
               axis: Optional[str] = None) -> list:
    """Run ``fn(shard_index, device)`` for every shard in ``flat_shard_index``
    order, each on its device (``torch.cuda.device`` context for a card);
    with ``axis``, for each position along that axis only (its device:
    ``axis_devices``). Nothing here waits for a device: a shard's work is
    queued behind the previous shard's without a host sync, so offsets and
    counts the body needs are host ints."""
    out = []
    devices = mesh.devices if axis is None else mesh.axis_devices(axis)
    for i, dev in enumerate(devices):
        if dev.type == "cuda":
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


def merge_topk(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], k: int,
               device: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``all_gather`` + ``lax.top_k``: the per-shard
    (scores (Q, k_i), ids (Q, k_i)) concatenated in shard order on
    ``device``, then the top k with ``lax.top_k``'s order — among equal
    scores the earlier shard wins. → (scores (Q, k') f32, ids (Q, k')
    int64), k' = min(k, Σ k_i)."""
    device = torch.device(device)
    s = torch.cat([to_device(p[0], device).float() for p in parts], dim=1)
    i = torch.cat([to_device(p[1], device).long() for p in parts], dim=1)
    s2, pos = top_k(s, min(k, s.shape[1]))
    return s2, torch.gather(i, 1, pos)
