"""Meshes across processes: the port's runtime of ``tests/test_distributed.py``
(``tests/dist_worker.py``) and more.

Two OS processes join one ``torch.distributed`` group over gloo through
``core/meshes.py:initialize_distributed`` (``$QST_COORDINATOR_ADDRESS``,
``$QST_NUM_PROCESSES``, ``$QST_PROCESS_ID``), each with two CPU positions
(``$QST_TORCH_VIRTUAL_DEVICES=2``), so ``make_mesh(4, 1,
*global_devices("cpu"))`` lays out four positions, two a process. The worker is this file run as a script
(``python tests/test_torch_distributed.py <job> <rank> <world> <port>
<dir>``); it imports torch and the port only, and writes what it computed
under ``<dir>`` for the test, which compares it with the port's
one-process mesh of the same shape (bit for bit) and with qst_tpu.

The train steps are the ``tiny`` preset at f32 and dropout 0 from JAX's
initial weights (``state_dict_from_flax_params``), on one global batch from
``np.random.default_rng(0)`` that each process passes as its own rows
(``process_shard_bounds``, ``global_array_from_local`` with ``(None,
"data")``, as ``tests/dist_worker.py`` does). Against JAX's
``make_train_step`` on four devices: the loss at rtol 1e-5 and every
parameter at atol 1e-5 (0.1·lr), the attention key biases at 2·lr: their
gradient is rounding noise, which Adam's first step turns into ±lr in
either package (as in ``test_torch_parallel_train.py``).

Every subprocess has a timeout; a hang fails the test.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
B = 4
S = 8
LR = 1e-4
CASES = [("module", False), ("fused", False), ("module", True), ("fused", True)]
SEARCHES = ["exact_pallas", "exact_xla", "exact_int8", "ivf_pallas", "ivf_xla", "pq", "ivfpq",
            "streaming"]
TIMEOUT = 240


# ---------------------------------------------------------------- shared
def port_configs(path: str):
    """The port's tiny configs of the train steps (f32, dropout 0)."""
    from qst_tpu_torch.core import config as tc

    fused = path == "fused"
    return (tc.EncoderConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0,
                                  use_fused_layer=fused),
            tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=fused),
            tc.TrainConfig(batch_size=B, learning_rate=LR, scheduler="constantlr",
                           max_grad_norm=0.5))


def global_batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 128, (4, B, S)).astype(np.int32)
    mask = np.ones((4, B, S), np.int32)
    mask[..., S // 2:] = 0
    return ids, mask


def corpus():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((700, 32)).astype(np.float32),
            rng.standard_normal((5, 32)).astype(np.float32))


def one_step(mesh, path: str, tp: bool, init, ids, mask):
    """One port train step on ``mesh`` → (loss, the flat state dict)."""
    from qst_tpu_torch.train import train_step as tts

    tcfg, tl, tt = port_configs(path)
    if tp:
        st, _ = tts.create_train_state_sharded(tcfg, tt, torch.Generator(), 10, mesh, tl,
                                               initial_params=init)
    else:
        st, _ = tts.create_train_state(tcfg, tt, torch.Generator(), 10, tl,
                                       initial_params=init, device="cpu")
    st, loss = tts.make_train_step(tcfg, tl, None, mesh)(st, ids, mask, None)
    return loss, st.flat_state_dict()


def search(mesh, kind: str):
    """One search of ``corpus()`` on ``mesh`` → (scores, ids) numpy."""
    from qst_tpu_torch.retrieval.index import ExactIndex
    from qst_tpu_torch.retrieval.ivf import IVFIndex
    from qst_tpu_torch.retrieval.ivfpq import IVFPQIndex
    from qst_tpu_torch.retrieval.pq import PQIndex
    from qst_tpu_torch.retrieval.streaming import StreamingExactIndex

    emb, q = corpus()
    if kind == "pq":
        return PQIndex(emb, m=8, mesh=mesh, keep_rows=True, device="cpu").search(
            q, k=10, refine_factor=2)
    if kind == "ivfpq":
        s, ids = IVFPQIndex(emb, n_clusters=16, m=8, mesh=mesh, device="cpu").search(
            q, k=10, n_probe=4)
        return s, np.array([[-1 if j is None else j for j in row] for row in ids])
    if kind == "streaming":
        return StreamingExactIndex(emb, tile_rows=512, mesh=mesh, device="cpu").search(q, k=10)
    if kind.startswith("exact"):
        dtype = "int8" if kind == "exact_int8" else "bfloat16"
        backend = "xla" if kind == "exact_xla" else "pallas"
        return ExactIndex(emb, mesh=mesh, dtype=dtype, device="cpu").search(
            q, k=10, backend=backend)
    idx = IVFIndex(emb, n_clusters=16, mesh=mesh, device="cpu")
    s, i = idx._device_search(idx._queries(q), 10, 4, kind.split("_")[1])
    return s.numpy(), i.numpy()


def trainer(root: str, exp: str, mesh, epochs: int, init):
    """A ``Trainer`` of the tiny preset (dropout 0.1, the nn.Module path),
    batch 8, one example a role, a checkpoint and a constant score every
    step."""
    from qst_tpu_torch.core import config as tc
    from qst_tpu_torch.data import QuadrupletCollator, QuadrupletDataset
    from qst_tpu_torch.models.tokenizer import HashTokenizer
    from qst_tpu_torch.train.trainer import Trainer

    cfg = tc.EncoderConfig.tiny()
    over = dict(batch_size=8, epochs=epochs, learning_rate=1e-3, scheduler="constantlr",
                evaluation_steps=1, checkpoint_save_steps=1, early_stopping_patience=50,
                experiment_dir=exp)
    return Trainer(cfg, tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5),
                   tc.TrainConfig(**over),
                   QuadrupletDataset(root, n_pos=1, n_part_pos=1, n_neg=1, seed=1),
                   QuadrupletCollator(HashTokenizer(vocab_size=cfg.vocab_size),
                                      max_length=cfg.max_seq_length),
                   evaluator=lambda m, e, s: 0.5, mesh=mesh, initial_params=init)


TEXTS = [f"a {w} sits by the {p} number {i}" for i, (w, p) in enumerate(
    zip(("cat dog bird fish car boat tree lamp cup pen " * 3).split(),
        ("river road hill lake park yard shop dock room wall " * 3).split()))]


def cli_argv(job: str, data: str, out: str):
    if job == "train_main":
        return ["--dataset_root", data, "--experiment_dir", out, "--encoder_preset", "tiny",
                "--device", "cpu", "--batch_size", "8", "--epochs", "1", "--mesh_data", "-1",
                "--evaluation_steps", "0", "--learning_rate", "1e-3"]
    return ["--dataset_root", data, "--output_root", out, "--encoder_preset", "tiny",
            "--device", "cpu", "--mesh_data", "4", "--n_queries", "12",
            "--accuracy_at_k", "1", "--precision_recall_at_k", "1", "--mrr_at_k", "3",
            "--ndcg_at_k", "3", "--map_at_k", "3", "--score_functions", "cos_sim", "dot_score"]


# ---------------------------------------------------------------- the worker
def worker(job: str, rank: int, out: str) -> None:
    """One process of the group: the job's results under ``out``."""
    torch.set_num_threads(1)
    from qst_tpu_torch.core import meshes as tm

    if job in ("train_main", "ir_eval"):
        data, dest, extra = sys.argv[6], sys.argv[7], sys.argv[8:]
        if job == "train_main":
            from qst_tpu_torch.cli import train_main
            from qst_tpu_torch.train import trainer as trainer_mod

            train = trainer_mod.Trainer.train
            kept = {}
            trainer_mod.Trainer.train = lambda self, **kw: kept.setdefault(
                "result", train(self, **kw))
            assert train_main.main(cli_argv(job, data, dest) + extra) == 0
            torch.save(kept["result"].state.flat_state_dict(), os.path.join(out, f"r{rank}.pt"))
        else:
            from qst_tpu_torch.cli import ir_eval_main

            assert ir_eval_main.main(cli_argv(job, data, dest) + extra) == 0
        import torch.distributed as dist

        dist.destroy_process_group()
        return
    assert tm.initialize_distributed(device="cpu")
    import torch.distributed as dist

    try:
        results = {"world": dist.get_world_size()}
        mesh = tm.make_mesh(4, 1, *tm.global_devices("cpu"))
        results["ranks"] = mesh.ranks
        ids, mask = global_batch()
        lo, hi = tm.process_shard_bounds(B)
        blocks = tm.global_array_from_local(ids[:, lo:hi], mesh, (None, "data"))
        results["blocks"] = [None if b is None else b.clone() for b in blocks]
        results["full"] = blocks.full()
        init = torch.load(os.path.join(out, "init.pt"), weights_only=True)
        for path, tp in CASES:
            m = tm.make_mesh(2, 2, *tm.global_devices("cpu")) if tp else mesh
            a = tm.global_array_from_local(ids[:, lo:hi], m, (None, "data"))
            b = tm.global_array_from_local(mask[:, lo:hi], m, (None, "data"))
            results[(path, tp)] = one_step(m, path, tp, init, a, b)
        for kind in SEARCHES:
            results[kind] = search(mesh, kind)
        from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
        from qst_tpu_torch.models.tokenizer import HashTokenizer

        tcfg = port_configs("module")[0]
        results["encode"] = SentenceEncoder(tcfg, init, HashTokenizer(tcfg.vocab_size),
                                            mesh=mesh).encode(TEXTS, batch_size=8)
        exp = os.path.join(out, "exp")
        trainer(os.path.join(out, "chunks"), exp, mesh, 1, init).train()
        got = trainer(os.path.join(out, "chunks"), exp, mesh, 2, init).train(resume=True)
        results["trainer"] = (got.state.step, got.state.flat_state_dict())
        torch.save(results, os.path.join(out, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    job, rank, world, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], \
        sys.argv[5]
    os.environ.update({"QST_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                       "QST_NUM_PROCESSES": world, "QST_PROCESS_ID": str(rank),
                       "QST_TORCH_VIRTUAL_DEVICES": "2"})
    worker(job, rank, out)
    sys.exit(0)


# ---------------------------------------------------------------- the tests
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_group(job: str, out: str, *extra: str, timeout: int = TIMEOUT):
    """Start two processes of the worker → ``wait()``, which fails the
    caller on a worker's failure or hang."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("QST_") and k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r), "2",
                               port, out, *extra], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]

    def wait() -> None:
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, text in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{text[-4000:]}"

    return wait


def run_group(job: str, out: str, *extra: str) -> None:
    start_group(job, out, *extra)()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_init():
    import jax

    from qst_tpu.core import config as jc
    from qst_tpu.models.sentence_encoder import init_params as jax_init_params

    jcfg = jc.EncoderConfig(**dataclasses.asdict(port_configs("module")[0]))
    return jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two workers' results and the initial weights they started from."""
    from helpers import write_synthetic_dataset
    from qst_tpu_torch.models.hf_import import state_dict_from_flax_params

    out = str(tmp_path_factory.mktemp("group"))
    init = state_dict_from_flax_params(jax_init(), port_configs("module")[0])
    torch.save(init, os.path.join(out, "init.pt"))
    write_synthetic_dataset(os.path.join(out, "chunks"), n_chunks=2, chunk_dim=8)
    wait = start_group("all", out)
    refs = references(init)           # while the workers run
    wait()
    return out, init, [torch.load(os.path.join(out, f"r{r}.pt"), weights_only=False)
                       for r in range(2)], refs


def _equal_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("n,pc", [(8, 2), (10, 3), (3, 5), (7, 1)])
def test_process_shard_bounds_and_gate_match_jax(n, pc, monkeypatch):
    """The port's copy of ``process_shard_bounds`` and of the environment
    gate are qst_tpu's."""
    from qst_tpu.core import meshes as jm
    from qst_tpu_torch.core import meshes as tm

    assert [tm.process_shard_bounds(n, i, pc) for i in range(pc)] == \
        [jm.process_shard_bounds(n, i, pc) for i in range(pc)]
    with pytest.raises(ValueError, match="outside"):
        tm.process_shard_bounds(n, pc, pc)
    monkeypatch.delenv(tm.COORDINATOR_ENV, raising=False)
    assert tm.initialize_distributed() is jm.initialize_distributed() is False
    assert (tm.COORDINATOR_ENV, tm.NUM_PROCESSES_ENV, tm.PROCESS_ID_ENV) == \
        (jm.COORDINATOR_ENV, jm.NUM_PROCESSES_ENV, jm.PROCESS_ID_ENV)


def test_global_array_from_local_across_processes(group):
    """Each process's rows land on the positions it owns (P(None, "data")
    on the (4, B, S) ids): rank 0 holds data blocks 0 and 1, rank 1 blocks
    2 and 3, the others None; ``full()`` is the global batch on both."""
    _, _, (r0, r1), _ = group
    ids = torch.as_tensor(global_batch()[0])
    assert r0["world"] == 2 and r0["ranks"] == r1["ranks"] == [0, 0, 1, 1]
    for rank, res in enumerate((r0, r1)):
        for i, blk in enumerate(res["blocks"]):
            if i // 2 == rank:
                assert torch.equal(blk, ids[:, i * B // 4:(i + 1) * B // 4])
            else:
                assert blk is None
        assert torch.equal(res["full"], ids)


def references(init):
    """The port's one-process mesh of each case's shape, and qst_tpu's
    ``make_train_step`` on four devices (the data-parallel step, which the
    DP + TP cases are held to too: the JAX package's tensor-parallel step
    is the same function with its parameters laid out, and
    ``test_torch_parallel_train.py`` holds the port's to it)."""
    import jax
    import jax.numpy as jnp

    from qst_tpu.core import config as jc
    from qst_tpu.core.meshes import make_mesh as jax_make_mesh
    from qst_tpu.train import train_step as jts
    from qst_tpu_torch.core.meshes import make_mesh
    from qst_tpu_torch.models.hf_import import state_dict_from_flax_params

    ids, mask = global_batch()
    params = jax_init()
    out, jax_out = {}, {}
    for path, tp in CASES:
        tcfg, tl, tt = port_configs(path)
        mesh = make_mesh(2, 2, devices=["cpu"] * 4) if tp else make_mesh(4, 1, devices=["cpu"] * 4)
        port = one_step(mesh, path, tp, init, ids, mask)
        if path not in jax_out:
            to_j = lambda cls, c: cls(**dataclasses.asdict(c))  # noqa: E731
            jcfg, jl, jt = (to_j(jc.EncoderConfig, tcfg), to_j(jc.LossConfig, tl),
                            to_j(jc.TrainConfig, tt))
            st, tx = jts.create_train_state(jcfg, jt, jax.random.key(0), 10, jl,
                                            initial_params=params)
            st, loss = jts.make_train_step(
                jcfg, jl, tx, mesh=jax_make_mesh(4, 1, devices=jax.devices()[:4]))(
                st, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(3))
            jax_out[path] = float(loss), state_dict_from_flax_params(
                jax.tree.map(np.asarray, st.params), tcfg)
        out[(path, tp)] = port, jax_out[path]
    return out


@pytest.mark.parametrize("path,tp", CASES, ids=["dp-module", "dp-fused", "dp_tp-module",
                                                "dp_tp-fused"])
def test_step_across_processes(group, path, tp):
    """A DP step on 4 × 1 and a DP + TP step on 2 × 2, each mesh two
    processes × two positions: the loss is equal on both ranks, the
    parameters are the same bits on both ranks and the same bits as the
    one-process mesh's step, and they equal qst_tpu's step on four devices
    (module docstring's tolerances)."""
    _, _, (r0, r1), refs = group
    (loss0, p0), (loss1, p1) = r0[(path, tp)], r1[(path, tp)]
    (one_loss, one_params), (jloss, jparams) = refs[(path, tp)]
    assert torch.equal(loss0, loss1) and torch.equal(loss0, one_loss)
    _equal_dicts(p0, p1)
    _equal_dicts(p0, one_params)
    np.testing.assert_allclose(float(loss0), jloss, rtol=1e-5)
    for k, v in jparams.items():
        atol = 2 * LR if k.endswith("attention.self.key.bias") else 1e-5
        np.testing.assert_allclose(p0[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("kind", SEARCHES)
def test_search_across_processes(group, kind):
    """Exact (bf16 through K4/K5's plain versions, the scan, int8), IVF
    (K6's plain version, the scan), PQ (refined), IVF-PQ and the streamed
    index over four positions of two processes: both ranks return the
    one-process mesh's answer, bit for bit, and the unsharded index's ids."""
    from qst_tpu_torch.core.meshes import make_mesh

    _, _, (r0, r1), _ = group
    want = search(make_mesh(4, 1, devices=["cpu"] * 4), kind)
    for res in (r0, r1):
        np.testing.assert_array_equal(res[kind][0], want[0])
        np.testing.assert_array_equal(res[kind][1], want[1])
    plain = search(None, kind)
    np.testing.assert_array_equal(r0[kind][1], plain[1])


def test_encode_across_processes(group):
    """``SentenceEncoder(mesh=)``: each process encodes its data shards and
    both get every row — the one-process mesh's bits, the unsharded
    encoder's values to 1e-6."""
    from qst_tpu_torch.core.meshes import make_mesh
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
    from qst_tpu_torch.models.tokenizer import HashTokenizer

    _, init, (r0, r1), _ = group
    tcfg = port_configs("module")[0]
    tok = HashTokenizer(tcfg.vocab_size)
    one = SentenceEncoder(tcfg, init, tok, mesh=make_mesh(4, 1, devices=["cpu"] * 4)).encode(
        TEXTS, batch_size=8)
    np.testing.assert_array_equal(r0["encode"], one)
    np.testing.assert_array_equal(r1["encode"], one)
    plain = SentenceEncoder(tcfg, init, tok).encode(TEXTS, batch_size=8)
    np.testing.assert_allclose(r0["encode"], plain, rtol=0, atol=1e-6)


def test_trainer_across_processes_checkpoints_and_resumes(group, tmp_path):
    """``Trainer(mesh=)`` over two processes: one epoch, then a second run
    resumed from its last checkpoint, ends on both ranks at the bits of one
    process training two epochs on the same mesh shape; process 0 alone
    wrote the logs (one entry a step, not two) and the checkpoints."""
    import json

    from qst_tpu_torch.core.meshes import make_mesh

    out, init, (r0, r1), _ = group
    (s0, p0), (s1, p1) = r0["trainer"], r1["trainer"]
    assert s0 == s1 == 4
    _equal_dicts(p0, p1)
    want = trainer(os.path.join(out, "chunks"), str(tmp_path / "one"),
                   make_mesh(4, 1, devices=["cpu"] * 4), 2, init).train()
    _equal_dicts(p0, want.state.flat_state_dict())
    with open(os.path.join(out, "exp", "train_loss.json")) as f:
        assert [e["steps"] for e in json.load(f)] == [1, 2, 3, 4]
    periodic = os.path.join(out, "exp", "checkpoints", "periodic")
    assert sorted(os.listdir(periodic)) == ["3", "4"]
    assert os.path.isfile(os.path.join(out, "exp", "checkpoints", "best", "params.pt"))
    assert not [f for f in os.listdir(os.path.join(periodic, "4")) if f.endswith(".tmp")]


def test_train_main_two_processes_train_one_model(tmp_path, monkeypatch):
    """``train_main`` under ``$QST_COORDINATOR_ADDRESS`` with two processes
    starts the group before anything touches a device and trains ONE
    model over the four positions: both ranks end with the same bits, and
    those of one process on four positions. Without the
    hook each process trained the whole model alone on its two positions,
    whose dropout draws (folded with two data indices, not four) differ."""
    from helpers import write_synthetic_dataset
    from qst_tpu_torch.cli import train_main
    from qst_tpu_torch.train.checkpoints import CheckpointManager

    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_chunks=2, chunk_dim=8)
    run_group("train_main", str(tmp_path), data, str(tmp_path / "two"))
    p0, p1 = (torch.load(str(tmp_path / f"r{r}.pt"), weights_only=True) for r in range(2))
    _equal_dicts(p0, p1)
    monkeypatch.setenv("QST_TORCH_VIRTUAL_DEVICES", "4")
    assert train_main.main(cli_argv("train_main", data, str(tmp_path / "one"))) == 0
    mgr = CheckpointManager(str(tmp_path / "one" / "checkpoints"))
    step = mgr.latest_step()
    want = torch.load(str(tmp_path / "one" / "checkpoints" / "periodic" / str(step) / "state.pt"),
                      weights_only=True)["model"]
    _equal_dicts(p0, want)
    two = CheckpointManager(str(tmp_path / "two" / "checkpoints"))
    assert two.latest_step() == step
    monkeypatch.setenv("QST_TORCH_VIRTUAL_DEVICES", "2")
    assert train_main.main(cli_argv("train_main", data, str(tmp_path / "alone"))) == 0
    alone = torch.load(str(tmp_path / "alone" / "checkpoints" / "periodic" / str(step)
                           / "state.pt"), weights_only=True)["model"]
    assert any(not torch.equal(alone[k], want[k]) for k in want)


def _spanning(shape, ranks):
    from qst_tpu_torch.core.meshes import make_mesh

    return make_mesh(*shape, devices=["cpu"] * len(ranks), ranks=ranks)


def test_a_mesh_knows_which_process_owns_each_position():
    """In one process (rank 0) a mesh with ranks [0, 0, 1, 1]: the shard
    loop runs positions 0 and 1 only, a corpus's blocks exist there only,
    the home device is this process's first, and the axes report their
    owners. The owned blocks hold their own rows' storage only, so that
    the whole corpus is not kept alive in every process."""
    from qst_tpu_torch.core.meshes import RowShards

    mesh = _spanning((2, 2), [0, 0, 1, 1])
    assert mesh.spans_processes and mesh.rank == 0 and mesh.home == torch.device("cpu")
    assert mesh.axis_ranks("data") == [0, 1] and mesh.axis_ranks("model") == [0, 0]
    from qst_tpu_torch.core.meshes import shard_loop

    assert shard_loop(mesh, lambda i, d: i) == [0, 1, None, None]
    assert shard_loop(mesh, lambda i, d: i, axis="data") == [0, None]
    rows = RowShards(torch.arange(8.0)[:, None], mesh, 2)
    assert [b is not None for b in rows.blocks] == [True, True, False, False]
    assert rows.full is None and torch.equal(rows.local, torch.tensor([[0.0], [1.0]]))
    assert [b.untyped_storage().nbytes() for b in rows.blocks[:2]] == [2 * 4, 2 * 4]
    assert _spanning((4, 1), [0, 0, 0, 0]) == _spanning((4, 1), [0, 0, 0, 0])
    with pytest.raises(ValueError, match="ascending"):
        _spanning((2, 1), [1, 0])
