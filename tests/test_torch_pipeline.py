"""Pipeline parallelism (``qst_tpu_torch/parallel/pipeline.py``) against
qst_tpu's (``tests/test_pipeline_parallel.py``, case for case).

The port's pipe meshes are ``make_pipe_mesh(pipe, data, devices=["cpu"] *
8)``; qst_tpu's run on its 8 virtual CPU devices. The same weights (JAX
``init_params`` → ``state_dict_from_flax_params``) and batches go through
both: forward outputs at rtol/atol 2e-5 and gradients at rtol 2e-4 / atol
2e-5 (JAX's own bars against its sequential encoder). With dropout the
draws are the port's own (``DeviceDropout``), so the pipeline is held to a
sequential twin of the port that draws the same per-(data shard,
microbatch, layer) masks, as JAX's dropout cases hold it to its own twin.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import write_synthetic_dataset
from qst_tpu.core import config as jc
from qst_tpu.models.sentence_encoder import embed_fn as jax_embed_fn
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.parallel import pipeline as jpp
from qst_tpu_torch.core import config as tc
from qst_tpu_torch.data import QuadrupletCollator, QuadrupletDataset
from qst_tpu_torch.models.bert import MASK_BIAS, DeviceDropout
from qst_tpu_torch.models.hf_import import (
    flax_params_from_state_dict,
    state_dict_from_flax_params,
)
from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule
from qst_tpu_torch.models.tokenizer import HashTokenizer
from qst_tpu_torch.ops.distances import l2_normalize
from qst_tpu_torch.ops.fused_layer import fold_key
from qst_tpu_torch.ops.pooling import POOLERS
from qst_tpu_torch.parallel.pipeline import (
    PipelineLayout,
    make_pipe_mesh,
    make_pp_embed_fn,
    make_pp_train_step,
    pp_params_from_encoder,
    stack_stage_params,
    unstack_stage_params,
)
from qst_tpu_torch.train import train_step as tts
from qst_tpu_torch.train.checkpoints import CheckpointManager
from qst_tpu_torch.train.trainer import Trainer

JCFG = dataclasses.replace(jc.EncoderConfig.tiny(), num_layers=4, hidden_dropout=0.0,
                           attention_dropout=0.0)
CFG = tc.EncoderConfig(**dataclasses.asdict(JCFG))
DCFG = dataclasses.replace(CFG, hidden_dropout=0.3, attention_dropout=0.2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these steps are many small ops at tiny shapes,
    which a thread pool only slows, most of all in the suite's parallel
    run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """qst_tpu's weights → (its param tree, the port's state dict)."""
    p = jax.tree.map(np.asarray, jax_init_params(JCFG, jax.random.key(0)))
    return p, state_dict_from_flax_params(p, CFG)


def _batch(B, seed=0):
    rng = np.random.default_rng(seed)
    S = CFG.max_seq_length
    ids = rng.integers(5, CFG.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[0, S // 2:] = 0  # ragged row
    return ids, mask


def _pipe(pipe, data):
    return make_pipe_mesh(pipe, data, devices=["cpu"] * 8)


def _t(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


def test_stack_unstack_roundtrip(params):
    _, sd = params
    stacked = stack_stage_params(sd, CFG.num_layers, 2)
    q = stacked["attention.self.query.weight"]
    assert q.shape == (2, 2, CFG.hidden_size, CFG.hidden_size)
    flat = unstack_stage_params(stacked, CFG.num_layers)
    layers = {k: v for k, v in sd.items() if k.startswith("encoder.layer.")}
    assert flat.keys() == layers.keys() and all(torch.equal(flat[k], v) for k, v in layers.items())
    with pytest.raises(ValueError):
        stack_stage_params(sd, CFG.num_layers, 3)


def test_circular_stack_unstack_roundtrip(params):
    """v = 2: stage p's slots are chunks p, p + S; the round trip restores
    every layer, and the shapes are v = 1's."""
    _, sd = params
    stacked = stack_stage_params(sd, CFG.num_layers, 2, n_rounds=2)
    flat = unstack_stage_params(stacked, CFG.num_layers, n_rounds=2)
    assert all(torch.equal(flat[k], sd[k]) for k in flat)
    v1 = stack_stage_params(sd, CFG.num_layers, 2)
    assert {k: v.shape for k, v in stacked.items()} == {k: v.shape for k, v in v1.items()}
    # stage 0 holds layers 0 and 2, stage 1 layers 1 and 3
    assert torch.equal(stacked["output.dense.bias"][0, 1], sd["encoder.layer.2.output.dense.bias"])


def test_jax_pipeline_tree_carries_over_both_ways(params):
    """A JAX pipeline tree ({"embeddings", "stages"}) becomes the port's
    stacked layout, which ``flax_params_from_state_dict`` carries back."""
    jp, sd = params
    jtree = jpp.pp_params_from_encoder(jp["encoder"], JCFG, 2, n_rounds=2)
    stacked = state_dict_from_flax_params(jtree, CFG)
    want = PipelineLayout(CFG, 2, 2).export(
        pp_params_from_encoder(sd, CFG, 2, n_rounds=2).state_dict())
    assert stacked.keys() == want.keys()
    assert all(torch.equal(stacked[k], want[k]) for k in want)
    back = flax_params_from_state_dict(stacked, CFG)
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, jtree))


FORWARDS = [(2, 1, 4, 1), (4, 1, 2, 1), (2, 2, 2, 1),                       # GPipe
            (2, 1, 2, 2), (2, 1, 4, 2), (4, 1, 4, 1), (2, 2, 2, 2)]         # circular


@pytest.mark.parametrize("pipe,data,microbatches,rounds", FORWARDS)
def test_pp_forward_matches_jax(params, pipe, data, microbatches, rounds):
    """The pipelined forward against qst_tpu's ``make_pp_embed_fn`` on the
    same mesh shape (the circular schedule with a data axis and M == S, the
    tightest wrap timing, included)."""
    jp, sd = params
    ids, mask = _batch(8)
    jmesh = jpp.make_pipe_mesh(pipe, data)
    want = np.asarray(jax.jit(jpp.make_pp_embed_fn(JCFG, jmesh, pipe, microbatches, rounds))(
        jpp.pp_params_from_encoder(jp["encoder"], JCFG, pipe, jmesh, rounds),
        jnp.asarray(ids), jnp.asarray(mask)))
    mesh = _pipe(pipe, data)
    model = pp_params_from_encoder(sd, CFG, pipe, mesh, rounds)
    got = make_pp_embed_fn(CFG, mesh, pipe, microbatches, rounds)(model, *_t(ids, mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("rounds", [1, 2], ids=["gpipe", "circular"])
def test_pp_gradients_match_jax(params, rounds):
    """Autograd through the schedule (and the wrap bank) gives qst_tpu's
    pipelined gradients, embeddings and every layer."""
    jp, sd = params
    pipe, M = 2, 2
    ids, mask = _batch(4)
    jmesh = jpp.make_pipe_mesh(pipe, 1)
    jfwd = jpp.make_pp_embed_fn(JCFG, jmesh, pipe, M, rounds)
    g = jax.jit(jax.grad(lambda p: (jfwd(p, jnp.asarray(ids), jnp.asarray(mask)) ** 2).sum()))(
        jpp.pp_params_from_encoder(jp["encoder"], JCFG, pipe, jmesh, rounds))
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, g), CFG)
    mesh = _pipe(pipe, 1)
    model = pp_params_from_encoder(sd, CFG, pipe, mesh, rounds)
    (make_pp_embed_fn(CFG, mesh, pipe, M, rounds)(model, *_t(ids, mask)) ** 2).sum().backward()
    got = PipelineLayout(CFG, pipe, rounds).export({n: p.grad for n, p in model.named_parameters()})
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-4, atol=2e-5, err_msg=k)


def test_pp_gradients_match_sequential_with_a_data_axis(params):
    """On a 2 × 2 pipe mesh, each data shard's stage gradients summed in
    data-index order: the flat gradients of the unpipelined encoder."""
    _, sd = params
    ids, mask = _t(*_batch(8))
    mesh = _pipe(2, 2)
    model = pp_params_from_encoder(sd, CFG, 2, mesh, 2)
    (make_pp_embed_fn(CFG, mesh, 2, 2, 2)(model, ids, mask) ** 2).sum().backward()
    ref = SentenceEncoderModule(CFG)
    ref.load_state_dict(sd)
    (ref(ids, mask)["sentence_embedding"] ** 2).sum().backward()
    got = PipelineLayout(CFG, 2, 2).flat({n: p.grad for n, p in model.named_parameters()})
    for n, p in ref.named_parameters():
        torch.testing.assert_close(got[n], p.grad, rtol=2e-4, atol=2e-5, msg=n)


def test_pp_train_step_matches_jax(params):
    """One pipelined train step (2 × 2 mesh, 2 microbatches, the fused γ
    loss's plain version) against qst_tpu's ``make_pp_train_step``: the loss
    and the parameters after AdamW (atol 0.1·lr, the key bias 2·lr, as in
    ``test_torch_train.py``)."""
    from qst_tpu.train.train_step import TrainState as JaxState
    from qst_tpu.train.train_step import make_optimizer as jax_optimizer

    jp, sd = params
    lr = 1e-3
    jt = jc.TrainConfig(batch_size=8, learning_rate=lr, scheduler="constantlr")
    jl = jc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=True)
    rng = np.random.default_rng(3)
    S = CFG.max_seq_length
    ids = rng.integers(5, CFG.vocab_size, (4, 8, S)).astype(np.int32)
    mask = np.ones((4, 8, S), np.int32)
    mask[:, :, S // 2:] = 0
    jmesh = jpp.make_pipe_mesh(2, 2)
    pp = jpp.pp_params_from_encoder(jp["encoder"], JCFG, 2, jmesh)
    tx = jax_optimizer(jt, 100)
    js = JaxState(step=jnp.zeros((), jnp.int32), params=pp, opt_state=tx.init(pp))
    js, jloss = jpp.make_pp_train_step(JCFG, jl, tx, jmesh, 2, 2)(
        js, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(0))
    mesh = _pipe(2, 2)
    model = pp_params_from_encoder(sd, CFG, 2, mesh)
    tl = tc.LossConfig(**dataclasses.asdict(jl))
    opt = tts.make_optimizer(tc.TrainConfig(**dataclasses.asdict(jt)), 100, model.parameters())
    st = tts.TrainState(step=0, model=model, optimizer=opt, layout=PipelineLayout(CFG, 2))
    st, loss = make_pp_train_step(CFG, tl, None, mesh, 2, 2)(st, ids, mask, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, js.params), CFG)
    got = st.layout.export(st.model.state_dict())
    for k, v in want.items():
        atol = 2 * lr if k.endswith("attention.self.key.bias") else 0.1 * lr
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def test_pp_train_step_learns(params):
    _, sd = params
    mesh = _pipe(2, 2)
    model = pp_params_from_encoder(sd, CFG, 2, mesh)
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5)
    opt = tts.make_optimizer(tc.TrainConfig(batch_size=8, learning_rate=1e-3,
                                            scheduler="constantlr"), 100, model.parameters())
    st = tts.TrainState(step=0, model=model, optimizer=opt)
    step = make_pp_train_step(CFG, loss_cfg, None, mesh, 2, 2)
    rng = np.random.default_rng(3)
    S = CFG.max_seq_length
    ids = rng.integers(5, CFG.vocab_size, (4, 8, S)).astype(np.int32)
    mask = np.ones((4, 8, S), np.int32)
    losses = [float(step(st, ids, mask, None)[1]) for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_pp_validation_errors(params):
    _, sd = params
    with pytest.raises(ValueError, match="pipe"):
        make_pp_embed_fn(CFG, _pipe(4, 1), n_stages=2, n_microbatches=2)
    with pytest.raises(ValueError, match="pipe"):
        make_pp_embed_fn(CFG, tc_mesh(), 2, 2)
    fwd = make_pp_embed_fn(CFG, _pipe(2, 1), 2, n_microbatches=3)
    model = pp_params_from_encoder(sd, CFG, 2, _pipe(2, 1))
    with pytest.raises(ValueError, match="microbatches"):
        fwd(model, *_t(*_batch(8)))                   # 8 % 3 != 0
    with pytest.raises(ValueError, match="data shards"):
        make_pp_embed_fn(CFG, _pipe(2, 4), 2, 4)(model, *_t(*_batch(8)))
    with pytest.raises(ValueError, match="n_microbatches >= n_stages"):
        make_pp_embed_fn(CFG, _pipe(2, 1), 2, n_microbatches=1, n_rounds=2)
    with pytest.raises(ValueError, match="divisible"):
        make_pp_embed_fn(CFG, _pipe(2, 1), 2, n_microbatches=4, n_rounds=3)
    with pytest.raises(ValueError, match="divisible"):
        stack_stage_params(sd, CFG.num_layers, 2, n_rounds=3)


def tc_mesh():
    from qst_tpu_torch.core.meshes import make_mesh

    return make_mesh(2, 1, devices=["cpu"] * 2)


# ------------------------------------------------------------- with dropout
def _sequential_twin(model_sd, ids, mask, key, n_microbatches, n_data=1):
    """The unpipelined forward drawing the pipeline's masks: embeddings at
    layer ``num_layers`` of the key, layer l of microbatch m on data shard d
    at layer l of the key folded with d, then m."""
    from qst_tpu_torch.models.bert import BertEmbeddings, BertLayer

    emb = BertEmbeddings(DCFG)
    emb.load_state_dict({k[len("embeddings."):]: v for k, v in model_sd.items()
                         if k.startswith("embeddings.")})
    layers = []
    for i in range(DCFG.num_layers):
        layer = BertLayer(DCFG)
        prefix = f"encoder.layer.{i}."
        layer.load_state_dict({k[len(prefix):]: v for k, v in model_sd.items()
                               if k.startswith(prefix)})
        layers.append(layer)
    for m in (emb, *layers):
        m.train()
    B, S = ids.shape
    hidden = emb(ids, torch.zeros_like(ids), torch.arange(S)[None], DeviceDropout(
        key, DCFG.num_layers))
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, MASK_BIAS).float()
    mb = B // n_microbatches
    local = mb // n_data
    outs = []
    for m in range(n_microbatches):
        for d in range(n_data):
            rows = slice(m * mb + d * local, m * mb + (d + 1) * local)
            h, km = hidden[rows], fold_key(fold_key(key, d), m)
            for i, layer in enumerate(layers):
                h = layer(h, bias[rows], DeviceDropout(km, i), mask[rows])
            outs.append(h)
    pooled = POOLERS[DCFG.pooling](torch.cat(outs), mask)
    return l2_normalize(pooled) if DCFG.normalize else pooled


@pytest.mark.parametrize("pipe,data,microbatches,rounds", [(2, 1, 2, 1), (2, 1, 2, 2),
                                                           (2, 2, 2, 1)])
def test_pp_dropout_forward_matches_sequential_same_masks(params, pipe, data, microbatches,
                                                          rounds):
    """With dropout the pipeline equals the sequential twin that draws the
    same masks (the circular schedule too: slots map to global layers); the
    same key twice gives the same bits, another key another output, and
    no key the deterministic forward."""
    _, sd = params
    ids, mask = _t(*_batch(8))
    mesh = _pipe(pipe, data)
    model = pp_params_from_encoder(sd, DCFG, pipe, mesh, rounds)
    model.train()
    fwd = make_pp_embed_fn(DCFG, mesh, pipe, microbatches, rounds)
    key = tts.dropout_key(7, 1)
    out = fwd(model, ids, mask, key)
    twin = _sequential_twin(sd, ids, mask, key, microbatches, data)
    torch.testing.assert_close(out, twin, rtol=2e-5, atol=2e-5)
    assert torch.equal(out, fwd(model, ids, mask, key))
    assert (fwd(model, ids, mask, tts.dropout_key(8, 1)) - out).abs().max() > 1e-4
    det = SentenceEncoderModule(DCFG)
    det.load_state_dict(sd)
    torch.testing.assert_close(fwd(model, ids, mask), det(ids, mask)["sentence_embedding"],
                               rtol=2e-5, atol=2e-5)


def test_pp_dropout_gradients_match_sequential(params):
    """Identical masks → identical gradients (rtol 5e-4 / atol 5e-5, JAX's)."""
    _, sd = params
    ids, mask = _t(*_batch(4))
    mesh = _pipe(2, 1)
    model = pp_params_from_encoder(sd, DCFG, 2, mesh)
    model.train()
    key = tts.dropout_key(11, 1)
    (make_pp_embed_fn(DCFG, mesh, 2, 2)(model, ids, mask, key) ** 2).sum().backward()
    leaves = {k: v.clone().requires_grad_() for k, v in sd.items()}
    (_sequential_twin(leaves, ids, mask, key, 2) ** 2).sum().backward()
    got = PipelineLayout(DCFG, 2).flat({n: p.grad for n, p in model.named_parameters()})
    for k, v in leaves.items():
        if v.grad is not None:
            torch.testing.assert_close(got[k], v.grad, rtol=5e-4, atol=5e-5, msg=k)


def test_pp_train_step_stochastic_learns(params):
    """The pipelined step at dropout, composed with a data axis: another key
    another loss, the same key the same bits, and it still optimizes."""
    _, sd = params
    mesh = _pipe(2, 2)
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5)
    rng = np.random.default_rng(3)
    S = DCFG.max_seq_length
    ids = rng.integers(5, DCFG.vocab_size, (4, 8, S)).astype(np.int32)
    mask = np.ones((4, 8, S), np.int32)

    def fresh():
        model = pp_params_from_encoder(sd, DCFG, 2, mesh)
        opt = tts.make_optimizer(tc.TrainConfig(learning_rate=1e-3, scheduler="constantlr"),
                                 100, model.parameters())
        return tts.TrainState(step=0, model=model, optimizer=opt)

    step = make_pp_train_step(DCFG, loss_cfg, None, mesh, 2, 2)
    _, la = step(fresh(), ids, mask, tts.dropout_key(0, 1))
    _, lb = step(fresh(), ids, mask, tts.dropout_key(1, 1))
    _, la2 = step(fresh(), ids, mask, tts.dropout_key(0, 1))
    assert abs(float(la) - float(lb)) > 1e-6 and torch.equal(la, la2)
    st = fresh()
    losses = [float(step(st, ids, mask, tts.dropout_key(0, i + 1))[1]) for i in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_pp_circular_v4_matches_jax(params):
    """v = 4 (8 layers, 2 stages): four wrap rounds through the bank."""
    jcfg8 = dataclasses.replace(JCFG, num_layers=8)
    cfg8 = dataclasses.replace(CFG, num_layers=8)
    p8 = jax.tree.map(np.asarray, jax_init_params(jcfg8, jax.random.key(2)))
    ids, mask = _batch(4)
    want = np.asarray(jax.jit(jax_embed_fn(jcfg8))(p8, jnp.asarray(ids), jnp.asarray(mask)))
    mesh = _pipe(2, 1)
    model = pp_params_from_encoder(state_dict_from_flax_params(p8, cfg8), cfg8, 2, mesh, 4)
    got = make_pp_embed_fn(cfg8, mesh, 2, 2, 4)(model, *_t(ids, mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------------ trainer
def _trainer(root, exp, **kw):
    ds = QuadrupletDataset(root, n_pos=1, n_part_pos=1, n_neg=1, seed=1)
    collator = QuadrupletCollator(HashTokenizer(vocab_size=CFG.vocab_size),
                                  max_length=CFG.max_seq_length)
    tcfg = tc.TrainConfig(batch_size=8, epochs=2, learning_rate=1e-3, scheduler="constantlr",
                          evaluation_steps=2, checkpoint_save_steps=1,
                          checkpoint_save_total_limit=10, early_stopping_patience=50,
                          experiment_dir=exp)
    loss = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5)
    return Trainer(DCFG, loss, tcfg, ds, collator, **kw), tcfg


def test_trainer_pipeline_parallel(tmp_path, params):
    """``Trainer(pp_stages=2)`` on a 2 × 2 pipe mesh (qst_tpu's
    ``test_trainer_pipeline_parallel``): 4 steps, the stacked layout in the
    periodic checkpoints, the best artifact flat and loadable by a plain
    module, a run resumed from step 2 ending with the uninterrupted run's
    weights bit for bit (dropout 0.3 included), and JAX's refusals."""
    _, sd = params
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=2, chunk_dim=8)
    mesh = _pipe(2, 2)
    seen = []
    trainer, tcfg = _trainer(root, str(tmp_path / "pp"), mesh=mesh, initial_params=sd,
                             pp_stages=2, evaluator=lambda m, e, s: seen.append(
                                 type(m).__name__) or 0.5)
    result = trainer.train()
    assert result.state.step == 4 and set(seen) == {"SentenceEncoderModule"}
    ckdir = os.path.join(tcfg.experiment_dir, "checkpoints")
    saved = torch.load(os.path.join(ckdir, "periodic", "4", "state.pt"), weights_only=True)
    assert saved["layout"] == "pipeline"
    assert saved["model"]["stages.attention.self.query.weight"].shape[:2] == (2, 2)
    mgr = CheckpointManager(ckdir)
    best = mgr.restore_best_params()
    assert best.keys() == sd.keys()
    SentenceEncoderModule(DCFG).load_state_dict(best)
    import shutil

    shutil.copytree(str(tmp_path / "pp"), str(tmp_path / "re"))
    for s in (3, 4):
        shutil.rmtree(str(tmp_path / "re" / "checkpoints" / "periodic" / str(s)))
    again, _ = _trainer(root, str(tmp_path / "re"), mesh=mesh, initial_params=sd, pp_stages=2)
    resumed = again.train(resume=True)
    a, b = result.state.flat_state_dict(), resumed.state.flat_state_dict()
    assert resumed.state.step == 4 and all(torch.equal(a[k], b[k]) for k in a)

    with pytest.raises(ValueError, match="steps_per_call"):
        _trainer(root, str(tmp_path / "x"), mesh=mesh, pp_stages=2, steps_per_call=2)
    with pytest.raises(ValueError, match="mesh"):
        _trainer(root, str(tmp_path / "y"), mesh=None, pp_stages=2, device="cpu")[0].train()
