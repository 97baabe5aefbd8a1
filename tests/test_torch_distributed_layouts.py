"""The last layouts across processes: pipeline stages on different
processes, context-parallel and ring attention across processes, and a mesh
row (one data shard's tensor-parallel positions) split across processes.

Like ``tests/test_torch_distributed.py`` the file is its own worker
(``python tests/test_torch_distributed_layouts.py <job> <rank> <world>
<port> <dir> ...``): two OS processes join one gloo group through
``core/meshes.py:initialize_distributed``, each with two CPU positions
(``$QST_TORCH_VIRTUAL_DEVICES=2``), run every layout once, and write what
they computed under ``<dir>``. The test holds each result to the port's
one-process mesh of the same shape and ranks bit for bit, and to qst_tpu's
single-process counterpart on four devices: ``make_pp_train_step`` (the
pipeline steps, the ``tiny`` preset; six layers for the circular
schedule), ``make_train_step`` (the tensor-parallel steps, whose JAX
function is the data-parallel one with its parameters laid out, as in
``test_torch_distributed.py``) and
``ring_attention`` / ``context_parallel_attention``; the loss at rtol 1e-5,
every parameter at atol 1e-5 (0.1·lr), the attention key biases at 2·lr
(rounding noise that Adam's first step turns into ±lr in either package).
The steps are f32 at dropout 0 (the dropout case is held to one process
only: the draws are the port's own) with ``max_grad_norm`` 1e-3, so that
every step clips and the clip's global norm crosses the processes.

Every subprocess has a timeout; a hang fails the test.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
B = 4                   # quadruplets a step: 16 sequences
S = 8
LR = 1e-4
TIMEOUT = 240
HAND_OFFS = {"f32": (torch.float32, (3, 5)), "bf16": (torch.bfloat16, (2, 4, 3)),
             "int64": (torch.int64, (7,))}
# (stages, data, microbatches, rounds, ranks, layers) of each pipeline case:
# the tiny preset's two layers, six where the circular schedule needs them
PIPES = {"gpipe": (2, 1, 4, 1, [0, 1], 2), "circular": (3, 1, 4, 2, [0, 0, 1], 6),
         "pipe_data": (2, 2, 4, 1, [0, 0, 1, 1], 2)}
# (mesh shape, ranks, path) of each tensor-parallel case
TPS = {"tp-fused": ((1, 2), [0, 1], "fused"), "tp-module": ((1, 2), [0, 1], "module"),
       "dp_tp-fused": ((2, 2), [0, 1, 1, 1], "fused"),
       "dp_tp-module": ((2, 2), [0, 1, 1, 1], "module")}
ATTENTION = (2, 4, 32, 16)       # B, heads, S, head width; S split over ranks [0, 1]


# ---------------------------------------------------------------- shared
def configs(path: str = "module", layers: int = 2, dropout: float = 0.0):
    """The port's tiny configs (f32), the clip at 1e-3."""
    from qst_tpu_torch.core import config as tc

    fused = path == "fused"
    return (tc.EncoderConfig.tiny(num_layers=layers, hidden_dropout=dropout,
                                  attention_dropout=dropout, use_fused_layer=fused),
            tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=fused),
            tc.TrainConfig(batch_size=B, learning_rate=LR, scheduler="constantlr",
                           max_grad_norm=1e-3))


def global_batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 128, (4, B, S)).astype(np.int32)
    mask = np.ones((4, B, S), np.int32)
    mask[..., S // 2:] = 0
    mask[0, 0, :] = 1
    return ids, mask


def attention_inputs():
    rng = np.random.default_rng(2)
    return [torch.from_numpy(rng.standard_normal(ATTENTION).astype(np.float32))
            for _ in range(4)]


def hand_off_tensor(name: str, rank: int) -> torch.Tensor:
    dtype, shape = HAND_OFFS[name]
    return (torch.arange(int(np.prod(shape))).reshape(shape) * 3 + 1000 * rank + 7).to(dtype)


def pipe_mesh(case: str, ranks=None):
    from qst_tpu_torch.core.meshes import make_pipe_mesh

    pipe, data, _, _, own, _ = PIPES[case]
    return make_pipe_mesh(pipe, data, devices=["cpu"] * len(own),
                          ranks=own if ranks is None else ranks)


def pp_step(case: str, inits, mesh, dropout: float = 0.0, key=None):
    """One pipeline train step from ``inits[layers]`` → (loss, the state's
    checkpoint dict: stacked parameters and moments, gathered)."""
    from qst_tpu_torch.parallel.pipeline import (
        PipelineLayout,
        make_pp_train_step,
        pp_params_from_encoder,
    )
    from qst_tpu_torch.train import train_step as tts

    pipe, _, M, V, _, layers = PIPES[case]
    cfg, tl, tt = configs(layers=layers, dropout=dropout)
    model = pp_params_from_encoder(inits[layers], cfg, pipe, mesh, V)
    st = tts.TrainState(step=0, model=model, optimizer=tts.make_optimizer(
        tt, 10, model.parameters()), layout=PipelineLayout(cfg, pipe, V, mesh))
    ids, mask = global_batch()
    st, loss = make_pp_train_step(cfg, tl, None, mesh, pipe, M, V)(st, ids, mask, key)
    return loss, st.state_dict()


def pp_forward(inits, mesh):
    """The GPipe 2 × 1 forward (no dropout) of the global batch."""
    from qst_tpu_torch.parallel.pipeline import make_pp_embed_fn, pp_params_from_encoder

    pipe, _, M, V, _, layers = PIPES["gpipe"]
    cfg = configs(layers=layers)[0]
    ids, mask = (torch.from_numpy(a).long().reshape(4 * B, S) for a in global_batch())
    with torch.no_grad():
        return make_pp_embed_fn(cfg, mesh, pipe, M, V)(
            pp_params_from_encoder(inits[layers], cfg, pipe, mesh, V), ids, mask)


def tp_step(case: str, init, mesh):
    """One tensor-parallel step on ``mesh`` → (loss, the state's checkpoint
    dict, gathered), every process passing the blocks of the rows it owns a
    position of."""
    from qst_tpu_torch.core.meshes import global_array_from_local
    from qst_tpu_torch.train import train_step as tts

    cfg, tl, tt = configs(TPS[case][2])
    st, _ = tts.create_train_state_sharded(cfg, tt, torch.Generator(), 10, mesh, tl,
                                           initial_params=init)
    ids, mask = global_batch()
    rows = [i for i in range(mesh.shape["data"]) if mesh.in_row(i)]
    per = B // mesh.shape["data"]
    take = np.concatenate([np.arange(i * per, (i + 1) * per) for i in rows])
    a = global_array_from_local(ids[:, take], mesh, (None, "data"))
    b = global_array_from_local(mask[:, take], mesh, (None, "data"))
    st, loss = tts.make_train_step(cfg, tl, None, mesh)(st, a, b, None)
    return loss, st.state_dict()


def attention(mesh):
    """Context-parallel and ring attention over ``mesh`` → {scheme: (out,
    dq, dk, dv)}, the gradients of Σ out · w."""
    from qst_tpu_torch.parallel import context_parallel_attention, ring_attention

    out = {}
    for name, fn in (("context", context_parallel_attention), ("ring", ring_attention)):
        q, k, v, w = attention_inputs()
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*xs, mesh, "data")
        (o * w).sum().backward()
        out[name] = (o.detach(), *[x.grad for x in xs])
    return out


def trainer(root: str, exp: str, mesh, epochs: int, init):
    """``Trainer(pp_stages=2)`` of the tiny preset (dropout 0.1), batch 8,
    a checkpoint and a constant score every step."""
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
                   evaluator=lambda m, e, s: 0.5, mesh=mesh, initial_params=init,
                   pp_stages=2)


def train_main_argv(data: str, out: str):
    return ["--dataset_root", data, "--experiment_dir", out, "--encoder_preset", "tiny",
            "--device", "cpu", "--batch_size", "8", "--epochs", "1", "--pp_stages", "2",
            "--evaluation_steps", "1", "--learning_rate", "1e-3", "--max_val_samples", "8"]


# ---------------------------------------------------------------- the worker
def worker(job: str, rank: int, out: str) -> None:
    """One process of the group: the job's results under ``out``."""
    torch.set_num_threads(1)
    from qst_tpu_torch.core import meshes as tm

    if job == "train_main":
        from qst_tpu_torch.cli import train_main

        assert train_main.main(train_main_argv(sys.argv[6], sys.argv[7])) == 0
        import torch.distributed as dist

        dist.destroy_process_group()
        return
    assert tm.initialize_distributed(device="cpu")
    import torch.distributed as dist

    try:
        res = {}
        other = 1 - rank
        for name, (dtype, shape) in HAND_OFFS.items():
            mine, like = hand_off_tensor(name, rank), torch.empty(shape, dtype=dtype)
            got = tm.exchange([(mine if rank == 0 else like, 0, 1),
                               (mine if rank == 1 else like, 1, 0)])
            res[("hand_off", name)] = got[other]
        init = torch.load(os.path.join(out, "init.pt"), weights_only=True)
        inits = {2: init, 6: torch.load(os.path.join(out, "init6.pt"), weights_only=True)}
        res["gpipe_forward"] = pp_forward(inits, pipe_mesh("gpipe"))
        for case in PIPES:
            res[case] = pp_step(case, inits, pipe_mesh(case))
        from qst_tpu_torch.train.train_step import dropout_key

        res["pp_dropout"] = pp_step("pipe_data", inits, pipe_mesh("pipe_data"), 0.1,
                                    dropout_key(7, 1))
        res["attention"] = attention(tm.make_mesh(2, 1, devices=["cpu"] * 2, ranks=[0, 1]))
        for case, (shape, ranks, _) in TPS.items():
            mesh = tm.make_mesh(*shape, devices=["cpu"] * len(ranks), ranks=ranks)
            res[case] = tp_step(case, init, mesh)
        # the DP + TP state's checkpoint: gathered by both, written by process 0
        from qst_tpu_torch.train.checkpoints import CheckpointManager
        from qst_tpu_torch.train.train_step import SavedState

        shot = SavedState(res["dp_tp-module"][1])
        if tm.is_primary():
            CheckpointManager(os.path.join(out, "ckpt")).save_now(shot, 1)
        tm.barrier()
        pm = tm.make_pipe_mesh(2, 2, *tm.global_devices("cpu"))
        res["pipe_ranks"] = pm.ranks
        exp = os.path.join(out, "exp")
        trainer(os.path.join(out, "chunks"), exp, pm, 1, init).train()
        got = trainer(os.path.join(out, "chunks"), exp, pm, 2, init).train(resume=True)
        res["trainer"] = (got.state.step, got.state.state_dict())
        torch.save(res, os.path.join(out, f"r{rank}.pt"))
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


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_params(layers: int):
    import jax

    from qst_tpu.core import config as jc
    from qst_tpu.models.sentence_encoder import init_params as jax_init_params

    jcfg = jc.EncoderConfig(**dataclasses.asdict(configs(layers=layers)[0]))
    return jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))


def _to_jax(cls, c):
    return cls(**dataclasses.asdict(c))


def jax_references():
    """qst_tpu's steps and attention on four devices of one process."""
    import jax
    import jax.numpy as jnp

    from qst_tpu.core import config as jc
    from qst_tpu.core.meshes import make_mesh as jax_make_mesh
    from qst_tpu.models.sentence_encoder import embed_fn as jax_embed_fn
    from qst_tpu.parallel import context_parallel_attention as jax_cp
    from qst_tpu.parallel import pipeline as jpp
    from qst_tpu.parallel import ring_attention as jax_ring
    from qst_tpu.train import train_step as jts
    from qst_tpu.train.train_step import TrainState as JaxState
    from qst_tpu_torch.models.hf_import import state_dict_from_flax_params

    ids, mask = (jnp.asarray(a) for a in global_batch())
    out = {}
    params = {n: jax_params(n) for n in (2, 6)}
    for case, (pipe, data, M, V, _, layers) in PIPES.items():
        tcfg, tl, tt = configs(layers=layers)
        jcfg, jl, jt = (_to_jax(jc.EncoderConfig, tcfg), _to_jax(jc.LossConfig, tl),
                        _to_jax(jc.TrainConfig, tt))
        if case == "gpipe":
            out["forward"] = np.asarray(jax.jit(jax_embed_fn(jcfg))(
                params[layers], ids.reshape(4 * B, S), mask.reshape(4 * B, S)))
        jmesh = jpp.make_pipe_mesh(pipe, data)
        pp = jpp.pp_params_from_encoder(params[layers]["encoder"], jcfg, pipe, jmesh, V)
        tx = jts.make_optimizer(jt, 10)
        js = JaxState(step=jnp.zeros((), jnp.int32), params=pp, opt_state=tx.init(pp))
        js, loss = jpp.make_pp_train_step(jcfg, jl, tx, jmesh, pipe, M, V)(
            js, ids, mask, jax.random.key(0))
        out[case] = float(loss), state_dict_from_flax_params(
            jax.tree.map(np.asarray, js.params), tcfg)
    p2 = params[2]
    for path in ("module", "fused"):
        tcfg, tl2, tt2 = configs(path)
        jcfg, jl2, jt2 = (_to_jax(jc.EncoderConfig, tcfg), _to_jax(jc.LossConfig, tl2),
                          _to_jax(jc.TrainConfig, tt2))
        st, tx = jts.create_train_state(jcfg, jt2, jax.random.key(0), 10, jl2,
                                        initial_params=p2)
        st, loss = jts.make_train_step(jcfg, jl2, tx, mesh=jax_make_mesh(
            4, 1, devices=jax.devices()[:4]))(st, ids, mask, jax.random.key(3))
        out[path] = float(loss), state_dict_from_flax_params(
            jax.tree.map(np.asarray, st.params), tcfg)
    q, k, v, w = (jnp.asarray(x.numpy()) for x in attention_inputs())
    jmesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    out["ring"] = (np.asarray(jax_ring(q, k, v, jmesh, "data")),
                   *[np.asarray(g) for g in jax.grad(
                       lambda a, b, c: (jax_ring(a, b, c, jmesh, "data") * w).sum(),
                       argnums=(0, 1, 2))(q, k, v)])
    out["context"] = np.asarray(jax_cp(q, k, v, jmesh, "data"))
    return out


def port_references(inits):
    """The port's one-process meshes of every case's shape and ranks."""
    from qst_tpu_torch.core.meshes import make_mesh
    from qst_tpu_torch.train.train_step import dropout_key

    one = {"gpipe_forward": pp_forward(inits, pipe_mesh("gpipe", [0, 0]))}
    for case, (_, _, _, _, ranks, _) in PIPES.items():
        one[case] = pp_step(case, inits, pipe_mesh(case, [0] * len(ranks)))
    one["pp_dropout"] = pp_step("pipe_data", inits, pipe_mesh("pipe_data", [0] * 4), 0.1,
                                dropout_key(7, 1))
    one["attention"] = attention(make_mesh(2, 1, devices=["cpu"] * 2))
    for case, (shape, ranks, _) in TPS.items():
        one[case] = tp_step(case, inits[2], make_mesh(*shape, devices=["cpu"] * len(ranks)))
    return one


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two workers' results, the one-process references and JAX's."""
    from helpers import write_synthetic_dataset
    from qst_tpu_torch.models.hf_import import state_dict_from_flax_params

    out = str(tmp_path_factory.mktemp("layouts"))
    init = state_dict_from_flax_params(jax_params(2), configs()[0])
    init6 = state_dict_from_flax_params(jax_params(6), configs(layers=6)[0])
    torch.save(init, os.path.join(out, "init.pt"))
    torch.save(init6, os.path.join(out, "init6.pt"))
    write_synthetic_dataset(os.path.join(out, "chunks"), n_chunks=2, chunk_dim=8)
    wait = start_group("all", out)
    refs = jax_references()           # while the workers run
    one = port_references({2: init, 6: init6})
    wait()
    return out, init, [torch.load(os.path.join(out, f"r{r}.pt"), weights_only=False)
                       for r in range(2)], one, refs


def _equal(a, b, where=""):
    """Bit-equal nested dicts / lists / tensors."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def _near_jax(loss, params, want, lr=LR):
    jloss, jparams = want
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for k, v in jparams.items():
        atol = 2 * lr if k.endswith("attention.self.key.bias") else 1e-5
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", list(HAND_OFFS))
def test_hand_off_both_directions(group, name):
    """``exchange`` of one tensor each way between the two processes
    (posted together, so neither blocks the other): each rank receives the
    other's tensor, its dtype, shape and bits."""
    _, _, res, _, _ = group
    for rank in range(2):
        got, want = res[rank][("hand_off", name)], hand_off_tensor(name, 1 - rank)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


def test_gpipe_forward_across_processes(group):
    """GPipe 2 × 1, one stage a process: the forward on both ranks is the
    one-process mesh's, bit for bit, and qst_tpu's sequential encoder's."""
    _, _, (r0, r1), one, refs = group
    _equal(r0["gpipe_forward"], r1["gpipe_forward"])
    _equal(r0["gpipe_forward"], one["gpipe_forward"])
    np.testing.assert_allclose(r0["gpipe_forward"].numpy(), refs["forward"], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("case", list(PIPES))
def test_pipeline_step_across_processes(group, case):
    """A pipeline train step (GPipe 2 × 1 over ranks [0, 1], circular 3 × 1
    with two rounds over [0, 0, 1], pipe 2 × data 2 over [0, 0, 1, 1]):
    the loss equal on both ranks, the stacked parameters and moments
    (gathered from the stages' processes) bit-equal between the ranks and to
    the one-process mesh, and qst_tpu's ``make_pp_train_step``."""
    _, _, (r0, r1), one, refs = group
    _equal(r0[case], r1[case])
    _equal(r0[case], one[case])
    loss, sd = r0[case]
    assert sd["layout"] == "pipeline"
    _near_jax(loss, sd["model"], refs[case])


def test_pipeline_with_dropout_across_processes(group):
    """Pipe 2 × data 2 at dropout 0.1 (masks drawn on the device from the
    key folded with the data shard and microbatch): both ranks and the
    one-process mesh bit-equal, and the step differs from dropout 0's."""
    _, _, (r0, r1), one, _ = group
    _equal(r0["pp_dropout"], r1["pp_dropout"])
    _equal(r0["pp_dropout"], one["pp_dropout"])
    assert not torch.equal(r0["pp_dropout"][0], r0["pipe_data"][0])


def test_pipeline_trainer_across_processes_checkpoints_and_resumes(group, tmp_path):
    """``Trainer(pp_stages=2)`` on the group's pipe 2 × 2 mesh (stage 0 on
    process 0, stage 1 on process 1): one epoch, then a second run resumed
    from its checkpoint (each process lays its stage back out), ends on both
    ranks at the bits of one process training two epochs on the same mesh
    shape; process 0 alone wrote the stacked checkpoints."""
    from qst_tpu_torch.core.meshes import make_pipe_mesh

    out, init, (r0, r1), _, _ = group
    assert r0["pipe_ranks"] == [0, 0, 1, 1]
    (s0, sd0), (s1, sd1) = r0["trainer"], r1["trainer"]
    assert s0 == s1 == 4
    _equal(sd0, sd1)
    want = trainer(os.path.join(out, "chunks"), str(tmp_path / "one"),
                   make_pipe_mesh(2, 2, devices=["cpu"] * 4), 2, init).train()
    _equal(sd0, want.state.state_dict())
    with open(os.path.join(out, "exp", "train_loss.json")) as f:
        assert [e["steps"] for e in json.load(f)] == [1, 2, 3, 4]
    saved = torch.load(os.path.join(out, "exp", "checkpoints", "periodic", "4", "state.pt"),
                       weights_only=True)
    assert saved["layout"] == "pipeline"
    _equal(saved["model"], sd0["model"])


def test_train_main_pp_stages_two_processes(tmp_path, monkeypatch):
    """``train_main --pp_stages 2`` under two processes (a pipe 2 × 2 mesh,
    one stage a process) writes, from process 0, what one process writes
    on four positions: the checkpoint (stacked stages, moments), the loss
    log and the evaluators' results, the same bits and values. (The CLI
    writes no ``results.json``; these are its outputs.)"""
    from helpers import write_synthetic_dataset
    from qst_tpu_torch.cli import train_main

    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_chunks=2, chunk_dim=8)
    start_group("train_main", str(tmp_path), data, str(tmp_path / "two"))()
    monkeypatch.setenv("QST_TORCH_VIRTUAL_DEVICES", "4")
    assert train_main.main(train_main_argv(data, str(tmp_path / "one"))) == 0
    one, two = tmp_path / "one", tmp_path / "two"
    steps = sorted(os.listdir(one / "checkpoints" / "periodic"))
    assert steps and sorted(os.listdir(two / "checkpoints" / "periodic")) == steps
    _equal(torch.load(two / "checkpoints" / "periodic" / steps[-1] / "state.pt"),
           torch.load(one / "checkpoints" / "periodic" / steps[-1] / "state.pt"))
    logs = sorted(f for f in os.listdir(one) if f.endswith((".csv", "loss.json")))
    assert "train_loss.json" in logs and any(f.endswith(".csv") for f in logs)
    for f in logs:
        assert (two / f).read_text() == (one / f).read_text(), f


@pytest.mark.parametrize("scheme", ["context", "ring"])
def test_sharded_attention_forward_across_processes(group, scheme):
    """Context-parallel and ring attention over ranks [0, 1] (a 2 × 1 mesh):
    both ranks return every block, in sequence order, the one-process
    mesh's bits and qst_tpu's output within 1e-5."""
    _, _, (r0, r1), one, refs = group
    a, b, o = r0["attention"][scheme], r1["attention"][scheme], one["attention"][scheme]
    _equal(a[0], b[0])
    _equal(a[0], o[0])
    assert a[0].shape == ATTENTION
    want = refs["ring"][0] if scheme == "ring" else refs["context"]
    np.testing.assert_allclose(a[0].numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ["context", "ring"])
def test_sharded_attention_gradients_across_processes(group, scheme):
    """The gradients of Σ out · w in q, k and v on both ranks: the
    one-process mesh's, bit for bit; the ring's are qst_tpu's
    ``jax.grad`` of its ring (1e-4 / 1e-5, as ``test_torch_context_parallel.py``)."""
    _, _, (r0, r1), one, refs = group
    a, b, o = r0["attention"][scheme], r1["attention"][scheme], one["attention"][scheme]
    _equal(a[1:], b[1:])
    _equal(a[1:], o[1:])
    if scheme == "ring":
        for got, want in zip(a[1:], refs["ring"][1:]):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", list(TPS))
def test_split_row_step_across_processes(group, case):
    """A tensor-parallel step whose mesh row is split across processes: TP
    1 × 2 over ranks [0, 1] and DP + TP 2 × 2 over [0, 1, 1, 1], on the
    fused path (K1/K2's plain versions on the row's gathered slices, K3's)
    and the ``nn.Module`` path (partials and the input's gradient across
    the row): the loss and the gathered parameters and moments equal on
    both ranks and to the one-process mesh, bit for bit, and qst_tpu's step
    on four devices."""
    _, _, (r0, r1), one, refs = group
    _equal(r0[case], r1[case])
    _equal(r0[case], one[case])
    loss, sd = r0[case]
    assert sd["layout"] == "tensor_parallel"
    _near_jax(loss, sd["model"], refs[TPS[case][2]])


def test_split_row_checkpoint_gathered_on_process_zero(group):
    """The DP + TP 2 × 2 state over [0, 1, 1, 1] (process 0 holds model
    column 0 only): its checkpoint, gathered by both processes and written
    by process 0, holds every slice under HF names — the one-process
    mesh's state dict, bit for bit."""
    from qst_tpu_torch.train.checkpoints import CheckpointManager

    out, _, _, one, _ = group
    mgr = CheckpointManager(os.path.join(out, "ckpt"))
    assert mgr.latest_step() == 1
    saved = torch.load(os.path.join(out, "ckpt", "periodic", "1", "state.pt"),
                       weights_only=True)
    _equal(saved, one["dp_tp-module"][1])


def test_a_split_row_says_what_each_process_owns():
    """A 2 × 2 mesh over ranks [0, 1, 1, 1] seen from process 0 in one
    interpreter: it runs row 0 only, column 0's position; the model axis
    names its own column and the other's owner; a data-sharded array holds
    row 0's block, which process 0 leads."""
    from qst_tpu_torch.core.meshes import global_array_from_local, make_mesh

    mesh = make_mesh(2, 2, devices=["cpu"] * 4, ranks=[0, 1, 1, 1])
    assert mesh.rank == 0 and mesh.row_ranks(0) == [0, 1] and mesh.row_ranks(1) == [1, 1]
    assert mesh.in_row(0) and not mesh.in_row(1)
    assert mesh.axis_ranks("model") == [0, 1] and mesh.axis_ranks("data") == [0, 1]
    arr = global_array_from_local(torch.arange(6.0).reshape(3, 2), mesh, ("data",))
    assert arr.shape == (6, 2) and arr.lead == [True, False] and arr[1] is None
