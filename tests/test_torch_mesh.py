"""``qst_tpu_torch/core/meshes.py`` against ``qst_tpu/core/meshes.py``: the
mesh shapes and errors of ``tests/test_core.py``, the shardings' devices,
``process_shard_bounds``, the closed distributed gate, the virtual-device
variable, the dtype policy, and the merge's order among equal scores
against ``lax.top_k`` over the ``all_gather`` order."""

import jax
import numpy as np
import pytest
import torch

from qst_tpu.core import meshes as jm
from qst_tpu_torch.core import meshes as tm


def test_make_mesh_shapes_and_errors(devices):
    cpu8 = ["cpu"] * 8
    for kw in ({"data": 4, "model": 2}, {}, {"data": 3, "model": 2}, {"data": 1, "model": 1}):
        assert tm.make_mesh(devices=cpu8, **kw).shape == jm.make_mesh(devices=devices, **kw).shape
    for kw in ({"data": 5, "model": 2}, {"model": 3}, {"model": 0}):
        with pytest.raises(ValueError) as want:
            jm.make_mesh(devices=devices, **kw)
        with pytest.raises(ValueError) as got:
            tm.make_mesh(devices=cpu8, **kw)
        assert str(got.value) == str(want.value)


def test_mesh_order_and_shardings():
    devs = [f"cuda:{i}" for i in range(8)]
    mesh = tm.make_mesh(4, 2, devices=devs)
    # row-major: flat_shard_index(d, m) = d·2 + m is the device's position
    assert [str(d) for d in mesh.devices] == devs
    assert mesh.flat_shard_index(2, 1) == 5 and mesh.size == 8
    assert [str(d) for d in tm.batch_sharding(mesh).shard_devices()] == devs[::2]
    assert [str(d) for d in tm.corpus_sharding(mesh).shard_devices()] == devs
    assert [str(d) for d in tm.replicated(mesh).shard_devices()] == devs[:1]
    assert tm.make_mesh(4, 2, devices=devs) == mesh
    with pytest.raises(TypeError, match="Mesh"):
        tm.as_mesh(object())
    assert tm.sharded(tm.make_mesh(1, 1, devices=devs)) is None


def test_process_shard_bounds_matches_jax():
    for n, pc in ((10, 3), (7, 7), (3, 5), (100, 1)):
        for pi in range(pc):
            assert tm.process_shard_bounds(n, pi, pc) == jm.process_shard_bounds(n, pi, pc)
    assert tm.process_shard_bounds(10) == jm.process_shard_bounds(10) == (0, 10)
    with pytest.raises(ValueError, match="outside"):
        tm.process_shard_bounds(10, 3, 3)


def test_distributed_gate(monkeypatch):
    for env in (tm.COORDINATOR_ENV, tm.NUM_PROCESSES_ENV, tm.PROCESS_ID_ENV):
        monkeypatch.delenv(env, raising=False)
    assert tm.initialize_distributed() is False        # closed: one process
    monkeypatch.setenv(tm.COORDINATOR_ENV, "localhost:1234")
    with pytest.raises(ValueError, match=tm.NUM_PROCESSES_ENV):
        tm.initialize_distributed(device="cpu")
    monkeypatch.setenv(tm.NUM_PROCESSES_ENV, "2")
    with pytest.raises(ValueError, match=tm.PROCESS_ID_ENV):
        tm.initialize_distributed(device="cpu")
    assert jm.COORDINATOR_ENV == tm.COORDINATOR_ENV


def test_virtual_devices_variable(monkeypatch):
    monkeypatch.delenv(tm.VIRTUAL_DEVICES_ENV, raising=False)
    assert tm.visible_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setenv(tm.VIRTUAL_DEVICES_ENV, "8")
    assert tm.visible_devices("cpu") == [torch.device("cpu")] * 8
    assert tm.visible_devices("cuda:1") == [torch.device("cuda", 1)] * 8
    assert tm.make_mesh(4, 2, devices=tm.visible_devices("cpu")).shape == {"data": 4, "model": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.visible_devices()
    monkeypatch.setenv(tm.VIRTUAL_DEVICES_ENV, "0")
    with pytest.raises(ValueError, match=">= 1"):
        tm.visible_devices("cpu")


def test_global_array_from_local():
    mesh = tm.make_mesh(4, 2, devices=["cpu"] * 8)
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    blocks = tm.global_array_from_local(x, mesh, (("data", "model"),))
    assert len(blocks) == 8 and all(b.shape == (2, 3) for b in blocks)
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), x)
    assert len(tm.global_array_from_local(x, mesh, ("data",))) == 4
    assert len(tm.global_array_from_local(x, mesh)) == 8
    with pytest.raises(ValueError, match="split"):
        tm.global_array_from_local(x[:15], mesh, ("data",))


def test_dtype_policy_matches_jax():
    jp, tp = jm.dtype_policy(), tm.dtype_policy()
    assert str(tp.compute_dtype).removeprefix("torch.") == jp.compute_dtype.name
    assert tp.param_dtype == tp.output_dtype == torch.float32
    tree = {"w": torch.ones(2), "ids": torch.arange(3), "inner": [torch.zeros(1), (torch.ones(1),)]}
    out = tp.cast_compute(tree)
    assert out["w"].dtype == torch.bfloat16 and out["ids"].dtype == torch.int64
    assert out["inner"][0].dtype == torch.bfloat16 and out["inner"][1][0].dtype == torch.bfloat16
    assert tm.dtype_policy("float16").compute_dtype == torch.float16


@pytest.mark.parametrize("k", [1, 5, 12])
def test_merge_keeps_the_all_gather_top_k_order(k):
    """Per-shard candidates full of equal scores (and −inf slots): the
    merged ids are lax.top_k's over the shards' concatenation — the
    earlier shard, then the earlier slot, first among equals."""
    rng = np.random.default_rng(k)
    parts = []
    for shard in range(4):
        s = rng.choice([0.5, 0.25, -1.0, -np.inf], size=(3, 4)).astype(np.float32)
        s = -np.sort(-s, axis=1)
        parts.append((s, rng.integers(0, 1000, size=(3, 4)) + 1000 * shard))
    all_s = np.concatenate([p[0] for p in parts], axis=1)
    all_i = np.concatenate([p[1] for p in parts], axis=1)
    ws, pos = jax.lax.top_k(all_s, k)
    wi = np.take_along_axis(all_i, np.asarray(pos), axis=1)
    gs, gi = tm.merge_topk([(torch.from_numpy(s), torch.from_numpy(i)) for s, i in parts],
                           k, "cpu")
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_row_shards_are_views_on_one_device():
    mesh = tm.make_mesh(2, 2, devices=["cpu"] * 4)
    full = torch.arange(4 * 3 + 1, dtype=torch.float32)[:, None]
    rs = tm.RowShards(full, mesh, 3, extra=1)
    assert [b[:, 0].tolist() for b in rs.blocks] == [[0, 1, 2, 3], [3, 4, 5, 6],
                                                     [6, 7, 8, 9], [9, 10, 11, 12]]
    assert rs.blocks[1].data_ptr() == full[3].data_ptr()
    assert rs.gather().shape == (12, 1)
    assert tm.gathered(rs).data_ptr() == full.data_ptr() and tm.gathered(full) is full
