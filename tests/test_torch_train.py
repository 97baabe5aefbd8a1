"""The port's training path against qst_tpu's: schedules, the optimizer
chain (clip, AdamW with weight decay, gradient accumulation), the train
step on the fused and the ``nn.Module`` path, and the ``Trainer`` with
checkpoints and resume.

Same weights (JAX ``init_params`` → ``state_dict_from_flax_params``) and the
same numpy batches go through both packages at f32 and dropout 0 (the
dropout bits of the two frameworks' generators differ; the in-kernel masks
are held to the TPU kernel's in test_torch_fused_layer_bwd.py). Tolerances:
losses rtol 1e-5; gradients rtol 1e-4 / atol 1e-6 of the largest gradient
(summation order through six layers); parameters after AdamW steps atol
1e-4 = 0.1·lr — Adam's first steps divide each gradient by its own
magnitude, so an element whose gradient is near eps = 1e-8 turns float
noise into a fraction of lr, and the key bias, whose gradient is zero up to
rounding, moves by up to ±lr in either package (atol 2·lr there).
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import write_synthetic_dataset
from qst_tpu.core import config as jc
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.train import callbacks as jcallbacks
from qst_tpu.train import schedules as jsched
from qst_tpu.train import train_step as jts
from qst_tpu.train.trainer import Trainer as JaxTrainer
from qst_tpu_torch.core import config as tc
from qst_tpu_torch.data import QuadrupletCollator, QuadrupletDataset
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.models.tokenizer import HashTokenizer
from qst_tpu_torch.train import callbacks as tcallbacks
from qst_tpu_torch.train import schedules as tsched
from qst_tpu_torch.train import train_step as tts
from qst_tpu_torch.train.checkpoints import CheckpointManager
from qst_tpu_torch.train.trainer import Trainer

B = 8
LR = 1e-3


def _batch(S, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 512, (4, B, S)).astype(np.int32)
    mask = np.ones((4, B, S), np.int32)
    mask[:, :, S // 2:] = 0
    mask[1, 3, 5:] = 0
    return ids, mask


def _configs(fused: bool):
    jcfg = jc.EncoderConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0,
                                 use_fused_layer=fused)
    jl = jc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=fused)
    jt = jc.TrainConfig(batch_size=B, learning_rate=LR, scheduler="constantlr",
                        max_grad_norm=0.5)
    to_t = lambda cls, c: cls(**dataclasses.asdict(c))  # noqa: E731
    return (jcfg, jl, jt), (to_t(tc.EncoderConfig, jcfg), to_t(tc.LossConfig, jl),
                            to_t(tc.TrainConfig, jt))


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("name", sorted(jsched.SCHEDULES))
def test_schedules_match_optax_point_by_point(name):
    for lr, warmup, total in ((1e-3, 100, 1000), (2e-5, 10_000, 500), (1.0, 0, 1),
                              (0.5, 3, 7), (1.0, 10, 100)):
        js, ts = jsched.get_schedule(name, lr, warmup, total), tsched.get_schedule(
            name, lr, warmup, total)
        for count in [*range(30), 99, 100, 101, 499, 500, 999, 1000, 1001, 5000]:
            assert abs(ts(count) - float(js(count))) <= 1e-6 * lr, (lr, warmup, total, count)
    with pytest.raises(ValueError):
        tsched.get_schedule("bogus", 1.0, 1, 2)


# ---------------------------------------------------------------- optimizer
def _optimizer_pair(scheduler, accum, weight_decay, max_norm):
    jt = jc.TrainConfig(learning_rate=0.1, scheduler=scheduler, warmup_steps=2,
                        weight_decay=weight_decay, max_grad_norm=max_norm,
                        gradient_accumulation_steps=accum)
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "bias": rng.standard_normal(5).astype(np.float32),
              "ln_scale": np.ones(5, np.float32)}
    tx = jts.make_optimizer(jt, total_steps=20)
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    opt = tts.make_optimizer(tc.TrainConfig(**dataclasses.asdict(jt)), 20, tparams.values())
    return tx, params, tparams, opt


@pytest.mark.parametrize("scheduler,accum,weight_decay,max_norm,grad_scale", [
    ("constantlr", 1, 0.0, 1.0, 0.01),      # below the norm: no clipping
    ("constantlr", 1, 0.0, 1.0, 10.0),      # above: clipped as g·max/‖g‖
    ("warmuplinear", 1, 0.01, 1.0, 10.0),   # decay on every leaf; schedule count
    ("warmuplinear", 3, 0.01, 0.5, 3.0),    # MultiSteps: average, then clip
    ("warmupcosine", 2, 0.1, 100.0, 1.0),
])
def test_clipped_adamw_is_the_optax_chain(scheduler, accum, weight_decay, max_norm,
                                          grad_scale):
    tx, params, tparams, opt = _optimizer_pair(scheduler, accum, weight_decay, max_norm)
    state = tx.init(params)
    rng = np.random.default_rng(1)
    moved = []
    for step in range(9):
        grads = {k: (grad_scale * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in params.items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        moved.append(opt.step())
        for k in params:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{k} step {step}")
    assert moved == [(i + 1) % accum == 0 for i in range(9)]


@pytest.mark.parametrize("norm", [0.5, 0.9999995, 1.0, 1.5, 40.0])
def test_clip_is_optax_not_torch_clip_grad_norm(norm):
    """optax clips g · max/‖g‖ only when ‖g‖ >= max; torch's clip_grad_norm_
    scales by max/(‖g‖ + 1e-6) whenever that is below 1 — it moves a
    gradient just under the norm and clips a large one slightly harder."""
    rng = np.random.default_rng(8)
    raw = [rng.standard_normal(s).astype(np.float32) for s in ((6, 5), (5,), (3, 3))]
    total = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in raw))
    grads = [g * np.float32(norm / total) for g in raw]
    tx = optax.clip_by_global_norm(1.0)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    got = tts.clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    torch.nn.utils.clip_grad_norm_(params, 1.0)
    torch_moved = any(not np.array_equal(p.grad.numpy(), np.asarray(b))
                      for p, b in zip(params, want))
    assert torch_moved == (norm + 1e-6 > 1.0)


def test_weight_decay_reaches_biases_and_layernorm():
    """adamw decays every leaf: with zero gradients each parameter moves by
    −lr·wd·p, LayerNorm scales and biases included."""
    tx, params, tparams, opt = _optimizer_pair("constantlr", 1, 0.1, 1.0)
    for p in tparams.values():
        p.grad = torch.zeros_like(p)
    opt.step()
    for k, v in params.items():
        np.testing.assert_allclose(tparams[k].detach().numpy(), v - 0.1 * 0.1 * v,
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_optimizer_state_round_trips():
    _, _, tparams, opt = _optimizer_pair("warmuplinear", 2, 0.01, 1.0)
    for _ in range(3):
        for p in tparams.values():
            p.grad = torch.ones_like(p)
        opt.step()
    sd = opt.state_dict()
    assert sd["param_groups"][0]["count"] == 1 and sd["param_groups"][0]["mini_step"] == 1
    _, _, tparams2, opt2 = _optimizer_pair("warmuplinear", 2, 0.01, 1.0)
    opt2.load_state_dict(sd)
    assert opt2.param_groups[0]["count"] == 1
    assert torch.equal(opt2.state[tparams2["w"]]["acc"], opt.state[tparams["w"]]["acc"])


# ---------------------------------------------------------------- train step
@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
@pytest.mark.parametrize("nsteps", [1, 2])
def test_train_steps_match_jax_make_train_step(fused, nsteps):
    (jcfg, jl, jt), (tcfg, tl, tt) = _configs(fused)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    sj, tx = jts.create_train_state(jcfg, jt, jax.random.key(0), 10, jl, initial_params=params)
    step_j = jts.make_train_step(jcfg, jl, tx)
    st, _ = tts.create_train_state(tcfg, tt, torch.Generator().manual_seed(0), 10, tl,
                                   initial_params=state_dict_from_flax_params(params, tcfg),
                                   device="cpu")
    step_t = tts.make_train_step(tcfg, tl)
    for i in range(nsteps):
        ids, mask = _batch(jcfg.max_seq_length, i)
        sj, lj = step_j(sj, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(1))
        st, lt = step_t(st, ids, mask, None)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert st.step == int(sj.step) == nsteps
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, sj.params), tcfg)
    got = st.model.state_dict()
    for k, v in want.items():
        atol = 2 * LR if k.endswith("attention.self.key.bias") else 0.1 * LR
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_gradients_match_jax(fused):
    """The gradient itself (JAX's by an SGD step of rate 1 from the same
    params), which Adam's normalisation would hide."""
    (jcfg, jl, jt), (tcfg, tl, tt) = _configs(fused)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(2)))
    tx = optax.sgd(1.0)
    sj = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=tx.init({"encoder": params}))
    ids, mask = _batch(jcfg.max_seq_length, 3)
    new, _ = jts.make_train_step(jcfg, jl, tx)(sj, jnp.asarray(ids), jnp.asarray(mask),
                                              jax.random.key(1))
    grads_j = state_dict_from_flax_params(
        jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), params, new.params), tcfg)
    st, _ = tts.create_train_state(tcfg, tt, torch.Generator(), 10, tl,
                                   initial_params=state_dict_from_flax_params(params, tcfg),
                                   device="cpu")
    emb = tts.encoder_apply_fn(tcfg)(st.model, torch.from_numpy(ids.reshape(4 * B, -1)),
                                     torch.from_numpy(mask.reshape(4 * B, -1)), None)
    loss = tts.loss_from_config(tl)(*emb.reshape(4, B, -1))
    loss.backward()
    scale = max(np.abs(v.numpy()).max() for v in grads_j.values())
    for name, p in st.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_j[name].numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=name)


def test_d_regularized_step_trains_the_discriminator():
    (jcfg, _, jt), (tcfg, _, tt) = _configs(False)
    tl = tc.LossConfig(kind="d_regularized", lmbd=0.1)
    st, _ = tts.create_train_state(tcfg, tt, torch.Generator().manual_seed(0), 10, tl,
                                   device="cpu")
    before = {k: v.clone() for k, v in st.discriminator.state_dict().items()}
    st, loss = tts.make_train_step(tcfg, tl)(st, *_batch(tcfg.max_seq_length), None)
    assert np.isfinite(loss.item())
    assert not torch.equal(st.discriminator.logit.weight, before["logit.weight"])
    with pytest.raises(ValueError, match="discr_apply"):
        tts.loss_from_config(tl)


def test_eval_loss_is_deterministic_and_matches_jax():
    (jcfg, jl, _), (tcfg, tl, tt) = _configs(False)
    jcfg = dataclasses.replace(jcfg, hidden_dropout=0.1, attention_dropout=0.1)
    tcfg = dataclasses.replace(tcfg, hidden_dropout=0.1, attention_dropout=0.1)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(4)))
    ids, mask = _batch(jcfg.max_seq_length, 5)
    want = float(jts.make_eval_loss_fn(jcfg, jl)(params, jnp.asarray(ids), jnp.asarray(mask)))
    st, _ = tts.create_train_state(tcfg, tt, torch.Generator(), 10, tl,
                                   initial_params=state_dict_from_flax_params(params, tcfg),
                                   device="cpu")
    got = tts.make_eval_loss_fn(tcfg, tl)(st.model.train(), ids, mask)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_dropout_follows_the_generator(fused):
    """In train() mode with a dropout key both paths drop: the same key
    (seed, step) gives the same embeddings, another seed or another step
    others, no key none."""
    cfg = tc.EncoderConfig.tiny(use_fused_layer=fused)
    st, _ = tts.create_train_state(cfg, tc.TrainConfig(), torch.Generator().manual_seed(0), 10,
                                   device="cpu")
    enc = tts.encoder_apply_fn(cfg)
    ids, mask = (torch.from_numpy(a.reshape(4 * B, -1)) for a in _batch(cfg.max_seq_length))
    st.model.train()
    runs = [enc(st.model, ids, mask, k) for k in (tts.dropout_key(1, 3), tts.dropout_key(1, 3),
                                                  tts.dropout_key(2, 3), tts.dropout_key(1, 4),
                                                  None)]
    assert torch.equal(runs[0], runs[1])
    for other in runs[2:]:
        assert not torch.allclose(runs[0], other)
    with torch.no_grad():
        det = tts.make_eval_loss_fn(cfg, tc.LossConfig())(st.model, *_batch(cfg.max_seq_length))
    assert np.isfinite(det.item())


# ------------------------------------------------------- callbacks, checkpoints
def test_early_stopping_is_the_source_code():
    from test_torch_data import _code

    assert _code(tcallbacks.EarlyStopping) == _code(jcallbacks.EarlyStopping)
    assert _code(tcallbacks.Callback) == _code(jcallbacks.Callback)
    es = tcallbacks.EarlyStopping(patience=2, mode="max")
    assert [es.update(s, 0, i) for i, s in enumerate((0.5, 0.6, 0.55, 0.58))] == [
        False, False, False, True]


def test_checkpoint_roundtrip_and_retention(tmp_path):
    _, (tcfg, tl, tt) = _configs(False)
    state, _ = tts.create_train_state(tcfg, tt, torch.Generator().manual_seed(0), 10, tl,
                                      device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_steps=2, total_limit=2)
    assert not mgr.maybe_save(state, 1)
    for step in (2, 4, 6):
        assert mgr.maybe_save(state, step)
    assert mgr.steps() == [4, 6]
    assert mgr.update_best(state, 0.5) and not mgr.update_best(state, 0.4)
    state.step = 9
    mgr.save_now(state, 9)
    other, _ = tts.create_train_state(tcfg, tt, torch.Generator().manual_seed(7), 10, tl,
                                      device="cpu")
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore_latest(other)
    assert restored is other and other.step == 9
    for (k, a), b in zip(state.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), k
    best = mgr.restore_best_params()
    assert set(best) == set(state.model.state_dict())


# ------------------------------------------------------------ the trainer
def _trainer(root, exp, fused=False, n_examples=2, **over):
    cfg = tc.EncoderConfig.tiny(use_fused_layer=fused)
    ds = QuadrupletDataset(root, n_pos=n_examples, n_part_pos=n_examples, n_neg=1, seed=1)
    collator = QuadrupletCollator(HashTokenizer(vocab_size=cfg.vocab_size),
                                  max_length=cfg.max_seq_length)
    tcfg = tc.TrainConfig(**{**dict(
        batch_size=4, epochs=2, learning_rate=1e-3, scheduler="warmuplinear", warmup_steps=2,
        evaluation_steps=0, checkpoint_save_steps=5, checkpoint_save_total_limit=10,
        save_best_model=False, experiment_dir=exp), **over})
    loss = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=fused)
    return Trainer(cfg, loss, tcfg, ds, collator, device="cpu"), tcfg


def test_resume_matches_uninterrupted(tmp_path):
    """A run resumed from a mid-epoch checkpoint ends with the parameters of
    the uninterrupted run: batch order, sampling draws, dropout generators
    and optimizer state are all functions of (seed, step). One example per
    role: the collator picks among several with an rng of its own that a
    resumed run starts afresh (in qst_tpu as well; ROADMAP.md §C)."""
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=2, chunk_dim=12)   # 24 instances
    trainer_a, cfg_a = _trainer(root, str(tmp_path / "expA"), n_examples=1)
    final_a = trainer_a.train().state
    assert final_a.step == 12

    trainer_b, cfg_b = _trainer(root, str(tmp_path / "expB"), n_examples=1)
    src = os.path.join(cfg_a.experiment_dir, "checkpoints")
    dst = os.path.join(cfg_b.experiment_dir, "checkpoints")
    shutil.copytree(src, dst)
    periodic = os.path.join(dst, "periodic")
    for entry in os.listdir(periodic):
        if int(entry) > 5:
            shutil.rmtree(os.path.join(periodic, entry))
    assert CheckpointManager(dst).steps() == [5]
    final_b = trainer_b.train(resume=True).state
    assert final_b.step == 12
    for (k, a), b in zip(final_a.model.state_dict().items(),
                         final_b.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_trainer_end_to_end_on_the_fused_path(tmp_path):
    """The fused path (plain K1/K2/K3 on the CPU) with dropout: evaluation
    at epoch −1, early stopping, the loss log, best-model checkpoint."""
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=2, chunk_dim=8)
    trainer, cfg = _trainer(root, str(tmp_path / "exp"), fused=True, evaluation_steps=2,
                            early_stopping_patience=2, save_best_model=True, epochs=3)
    scores = iter([0.1, 0.5, 0.6, 0.6, 0.6, 0.6])
    trainer.evaluator = lambda model, epoch, steps: next(scores, 0.6)
    result = trainer.train()
    assert result.history[0]["epoch"] == -1
    assert result.best_score == 0.6 and result.stopped_early
    assert result.steps_per_sec > 0
    losses = [e["loss"] for e in tcallbacks_json(cfg)]
    assert losses and all(np.isfinite(losses))
    assert CheckpointManager(os.path.join(cfg.experiment_dir, "checkpoints")
                             ).restore_best_params() is not None


def tcallbacks_json(cfg):
    from qst_tpu_torch.core.telemetry import JsonLogSink

    return JsonLogSink(os.path.join(cfg.experiment_dir, "train_loss.json")).read()


def test_unported_trainer_options_raise(tmp_path):
    """Mesh and pipeline training are ported; what raises is what qst_tpu's
    Trainer refuses (``qst_tpu/train/trainer.py:89-98, 124-127``): the
    pipeline without a ("pipe", "data") mesh, with the d-regularized loss,
    or with steps_per_call > 1, and steps_per_call 0."""
    from qst_tpu_torch.core.meshes import make_mesh

    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=1, chunk_dim=8)
    trainer, cfg = _trainer(root, str(tmp_path / "exp"))
    args = (trainer.encoder_cfg, trainer.loss_cfg, cfg, trainer.dataset, trainer.collator)
    for mesh in (None, make_mesh(2, 1, devices=["cpu"] * 2)):
        with pytest.raises(ValueError, match="pipe"):
            Trainer(*args, mesh=mesh, pp_stages=2, device="cpu").train()
    d_reg = tc.LossConfig(kind="d_regularized")
    with pytest.raises(ValueError, match="d_regularized"):
        Trainer(args[0], d_reg, *args[2:], pp_stages=2)
    with pytest.raises(ValueError):
        Trainer(*args, steps_per_call=0)
    with pytest.raises(ValueError, match="pipeline"):      # as qst_tpu's Trainer
        Trainer(*args, steps_per_call=2, pp_stages=2)


def test_trainer_keeps_the_source_attributes(tmp_path):
    """``mesh``, ``steps_per_call`` and the ``pp_*`` options stay on the
    trainer as qst_tpu's keeps them (``qst_tpu/train/trainer.py``), with its
    default for ``pp_microbatches`` (the stage count)."""
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=1, chunk_dim=8)
    trainer, _ = _trainer(root, str(tmp_path / "exp"))
    assert (trainer.mesh, trainer.steps_per_call, trainer.pp_stages, trainer.pp_microbatches,
            trainer.pp_rounds) == (None, 1, 1, 1, 1)


def test_fused_loss_of_unbound_roles_equals_the_sliced_form():
    """The train step unbinds its (4, B, D) embeddings for the loss (one
    stack on the way back); loss and gradient are those of four slices."""
    tl = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=True)
    emb = torch.from_numpy(np.random.default_rng(21).standard_normal((4, 5, 16)).astype(
        np.float32))
    loss_fn = tts.loss_from_config(tl)
    a, b = emb.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    la, lb = loss_fn(*a.unbind(0)), loss_fn(b[0], b[1], b[2], b[3])
    la.backward()
    lb.backward()
    assert torch.equal(la, lb) and torch.equal(a.grad, b.grad)


def test_initial_params_reach_training(tmp_path):
    """Trainer(initial_params) at lr 0 finishes with the given weights."""
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=2, chunk_dim=8)
    trainer, _ = _trainer(root, str(tmp_path / "exp0"), learning_rate=0.0, epochs=1,
                          scheduler="constantlr", checkpoint_save_steps=0)
    from qst_tpu_torch.models.sentence_encoder import init_params

    custom = init_params(trainer.encoder_cfg, torch.Generator().manual_seed(99),
                         device="cpu")
    trainer.initial_params = custom
    result = trainer.train()
    for k, v in custom.items():
        np.testing.assert_allclose(result.state.model.state_dict()[k].numpy(), v.numpy(),
                                   atol=1e-7, err_msg=k)


def _trainer_with_evaluator(root, exp, framework, evaluate):
    """A one-epoch run on the tiny preset at dropout 0 from qst_tpu's
    weights, in either package, with the sequential evaluator (IR, quadruplet,
    loss) every two steps or with none."""
    from helpers import make_instances

    (jcfg, jl, _), (tcfg, tl, _) = _configs(False)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(6)))
    val = make_instances(8, offset=3)
    for inst in val:
        inst["negative"] = [make_instances(1, offset=inst["id"] + 9)[0]["positive"][0]]
    over = dict(batch_size=4, epochs=1, learning_rate=LR, scheduler="constantlr",
                evaluation_steps=2, checkpoint_save_steps=0, save_best_model=True,
                experiment_dir=exp)
    grid = dict(accuracy_at_k=(1, 3), precision_recall_at_k=(1,), mrr_at_k=(5,),
                ndcg_at_k=(5,), map_at_k=(10,), score_functions=("cos_sim", "dot_score"))
    if framework == "jax":
        from qst_tpu.data import QuadrupletCollator as JaxCollator
        from qst_tpu.data import QuadrupletDataset as JaxDataset
        from qst_tpu.evals import create_ir_evaluation_set, get_sequential_evaluator
        from qst_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer

        tok = JaxHashTokenizer(vocab_size=jcfg.vocab_size)
        evaluator = get_sequential_evaluator(
            jcfg, jl, tok, val, val_batches=[val[:4], val[4:]],
            ir_eval_set=create_ir_evaluation_set(make_instances(16), n_queries=6, seed=2),
            ir_cfg=jc.IREvalConfig(**grid), log_dir=exp)
        return JaxTrainer(jcfg, jl, jc.TrainConfig(**{**dataclasses.asdict(jc.TrainConfig()),
                                                      **over}),
                          JaxDataset(root, seed=1),
                          JaxCollator(tok, max_length=jcfg.max_seq_length),
                          evaluator=evaluator, initial_params=params)
    from qst_tpu_torch.evals import create_ir_evaluation_set, get_sequential_evaluator

    tok = HashTokenizer(vocab_size=tcfg.vocab_size)
    evaluator = get_sequential_evaluator(
        tcfg, tl, tok, val, val_batches=[val[:4], val[4:]],
        ir_eval_set=create_ir_evaluation_set(make_instances(16), n_queries=6, seed=2),
        ir_cfg=tc.IREvalConfig(**grid), log_dir=exp) if evaluate else None
    return Trainer(tcfg, tl, tc.TrainConfig(**over), QuadrupletDataset(root, seed=1),
                   QuadrupletCollator(tok, max_length=tcfg.max_seq_length),
                   evaluator=evaluator, initial_params=state_dict_from_flax_params(params, tcfg),
                   device="cpu")


def test_trainer_with_the_sequential_evaluator_matches_jax(tmp_path):
    """The history (epoch −1, every second step, each epoch's end) within
    1e-4 of qst_tpu's Trainer with its own evaluator on the same data; and
    evaluating leaves training alone: the logged losses and the final
    weights are those of the same run without an evaluator."""
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=2, chunk_dim=8)     # 4 steps an epoch
    want = _trainer_with_evaluator(root, str(tmp_path / "jax"), "jax", True).train(
        rng=jax.random.key(14))
    with_eval = _trainer_with_evaluator(root, str(tmp_path / "t"), "torch", True).train()
    without = _trainer_with_evaluator(root, str(tmp_path / "n"), "torch", False).train()
    assert [(h["epoch"], h["steps"]) for h in with_eval.history] == [
        (h["epoch"], h["steps"]) for h in want.history] == [
        (-1, -1), (0, 2), (0, 4), (0, 4)]
    np.testing.assert_allclose([h["score"] for h in with_eval.history],
                               [h["score"] for h in want.history], rtol=0, atol=1e-4)
    assert with_eval.best_score == pytest.approx(want.best_score, abs=1e-4)
    assert without.history == []
    losses = [tcallbacks_json(tc.TrainConfig(experiment_dir=str(tmp_path / d)))
              for d in ("t", "n")]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    for (k, a), b in zip(with_eval.state.model.state_dict().items(),
                         without.state.model.state_dict().values()):
        assert torch.equal(a, b), k


# ------------------------------------------------------------ multi-step
K_STEPS = 3


def _stacked(S, K, seed=0):
    """K (4, B, S) batches stacked: (K, 4, B, S) ids and mask."""
    pairs = [_batch(S, seed + j) for j in range(K)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_multi_step_matches_jax_make_multi_step(fused):
    """K = 3 steps in one call against qst_tpu's scanned ``make_multi_step``
    from the same weights at dropout 0: per-step losses and the final
    parameters to the one- and two-step tests' tolerances."""
    (jcfg, jl, jt), (tcfg, tl, tt) = _configs(fused)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(3)))
    ids, mask = _stacked(jcfg.max_seq_length, K_STEPS, seed=4)
    sj, tx = jts.create_train_state(jcfg, jt, jax.random.key(0), 10, jl, initial_params=params)
    sj, lj = jts.make_multi_step(jcfg, jl, tx, K_STEPS)(
        sj, jnp.asarray(ids), jnp.asarray(mask), jax.random.split(jax.random.key(1), K_STEPS))
    st, _ = tts.create_train_state(tcfg, tt, torch.Generator().manual_seed(0), 10, tl,
                                   initial_params=state_dict_from_flax_params(params, tcfg),
                                   device="cpu")
    st, lt = tts.make_multi_step(tcfg, tl, None, K_STEPS)(st, ids, mask, None)
    assert lt.shape == (K_STEPS,) and st.step == int(sj.step) == K_STEPS
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, sj.params), tcfg)
    got = st.model.state_dict()
    for k, v in want.items():
        atol = 2 * LR if k.endswith("attention.self.key.bias") else 0.1 * LR
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def _state_tensors(st):
    return [t.detach().clone() for t in st.optimizer.state_tensors()]


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
@pytest.mark.parametrize("accum", [1, 2])
def test_multi_step_equals_single_steps_exactly(fused, accum):
    """With dropout 0.1 and the per-step keys, K steps in one call are K
    single steps bit for bit: losses, parameters, moments, accumulators and
    the host counters."""
    cfg = tc.EncoderConfig.tiny(use_fused_layer=fused)
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=fused)
    tcfg = tc.TrainConfig(learning_rate=LR, warmup_steps=2, gradient_accumulation_steps=accum)
    ids, mask = _stacked(cfg.max_seq_length, K_STEPS, seed=7)
    keys = torch.stack([tts.dropout_key(5, s) for s in range(1, K_STEPS + 1)])
    multi_st, _ = tts.create_train_state(cfg, tcfg, torch.Generator().manual_seed(1), 10,
                                         loss_cfg, device="cpu")
    multi_st, losses = tts.make_multi_step(cfg, loss_cfg, None, K_STEPS)(multi_st, ids, mask,
                                                                          keys)
    single_st, _ = tts.create_train_state(cfg, tcfg, torch.Generator().manual_seed(1), 10,
                                          loss_cfg, device="cpu")
    step = tts.make_train_step(cfg, loss_cfg)
    singles = []
    for j in range(K_STEPS):
        single_st, loss = step(single_st, ids[j], mask[j], keys[j])
        singles.append(loss)
    assert torch.equal(losses, torch.stack(singles))
    for a, b in zip(_state_tensors(multi_st), _state_tensors(single_st)):
        assert torch.equal(a, b)
    groups = [s.optimizer.param_groups[0] for s in (multi_st, single_st)]
    assert ([(g["count"], g["mini_step"]) for g in groups] == [
        (K_STEPS // accum, K_STEPS % accum)] * 2)
    assert multi_st.step == single_st.step == K_STEPS


def test_accumulation_inside_multi_step():
    """``MultiSteps`` inside the multi-step (qst_tpu's
    ``test_accumulation_inside_multi_step_scan``): with accumulation 2 and
    K = 4, exactly two updates fire, the mini-step ends at 0, and every
    parameter moved."""
    cfg = tc.EncoderConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0)
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5)
    tcfg = tc.TrainConfig(batch_size=4, learning_rate=1e-3, scheduler="constantlr",
                          gradient_accumulation_steps=2)
    st, opt = tts.create_train_state(cfg, tcfg, torch.Generator().manual_seed(0), 50, loss_cfg,
                                     device="cpu")
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    ids, mask = _stacked(cfg.max_seq_length, 4, seed=2)
    st, losses = tts.make_multi_step(cfg, loss_cfg, opt, 4)(st, ids, mask, None)
    assert losses.shape == (4,) and torch.isfinite(losses).all()
    group = opt.param_groups[0]
    assert (group["count"], group["mini_step"]) == (2, 0)
    assert all(not torch.equal(before[k], v) for k, v in st.model.state_dict().items()
               if not k.endswith("position_ids"))
    assert all(torch.count_nonzero(opt.state[p]["acc"]) == 0 for p in st.model.parameters())
    with pytest.raises(ValueError, match="multi_step takes"):
        tts.make_multi_step(cfg, loss_cfg, opt, 4)(st, ids[:3], mask[:3], None)
    with pytest.raises(ValueError):
        tts.make_multi_step(cfg, loss_cfg, opt, 0)


def test_step_draws_are_a_pure_function_of_seed_and_step():
    """The training forward's draws (layer seeds, embedding mask) follow
    from (seed, step) alone; another seed or step draws anew."""
    from qst_tpu_torch.ops.fused_layer import embedding_dropout, step_draws

    base, seeds = step_draws(tts.dropout_key(14, 3), 6)
    again = step_draws(tts.dropout_key(14, 3).clone(), 6)
    assert torch.equal(base, again[0]) and torch.equal(seeds, again[1])
    assert seeds.dtype == torch.int32 and seeds.shape == (6, 1)
    assert len(set(seeds.flatten().tolist())) == 6 and int(seeds.min()) >= 0
    for other in (tts.dropout_key(14, 4), tts.dropout_key(15, 3)):
        b, s = step_draws(other, 6)
        assert not torch.equal(b, base) and not torch.equal(s, seeds)
    x = torch.ones((64, 32, 16), dtype=torch.float32)
    y = embedding_dropout(x, base, 0.1)
    assert torch.equal(y, embedding_dropout(x, base, 0.1))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01
    assert set(torch.unique(y).tolist()) == {0.0, float(np.float32(1 / 0.9))}


@pytest.mark.parametrize("seed", [0, 1, 12345678, 2**30 + 7, 2**31 - 1])
def test_the_int32_embedding_hash_gives_the_int64_hash_bits(seed):
    """The embedding mask's int32 hash (wrapping products, masked shifts)
    equals the int64 reference ``_hash31`` over the whole int32 index range."""
    from qst_tpu_torch.ops import fused_layer as fl

    rng = np.random.default_rng(seed)
    idx = np.concatenate([np.arange(4096), rng.integers(0, 2**31, 50_000),
                          [2**31 - 1, 2**31 - 2, 2**16 - 1, 2**16]])
    idx = torch.from_numpy(idx.astype(np.int64))
    base = torch.tensor([seed], dtype=torch.int64)
    fast = fl._hash31_i32(idx.to(torch.int32), base, fl._TAG_EMBED)
    assert fast.dtype == torch.int32
    assert torch.equal(fast.long(), fl._hash31(idx, base, fl._TAG_EMBED))


def _kstep_trainer(root, exp, framework, K, evals):
    """One epoch pair on the tiny preset at dropout 0 from qst_tpu's
    weights, ``steps_per_call`` K, an evaluator that records its steps."""
    (jcfg, jl, _), (tcfg, tl, _) = _configs(False)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(9)))
    over = dict(batch_size=4, epochs=2, learning_rate=LR, scheduler="constantlr",
                evaluation_steps=2, checkpoint_save_steps=0, early_stopping_patience=50,
                save_best_model=False, experiment_dir=exp)
    evaluator = lambda model, epoch, steps: evals.append((epoch, steps)) or 0.5  # noqa: E731
    if framework == "jax":
        from qst_tpu.data import QuadrupletCollator as JaxCollator
        from qst_tpu.data import QuadrupletDataset as JaxDataset
        from qst_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer

        return JaxTrainer(jcfg, jl, jc.TrainConfig(**over), JaxDataset(root, seed=1),
                          JaxCollator(JaxHashTokenizer(vocab_size=jcfg.vocab_size),
                                      max_length=jcfg.max_seq_length),
                          evaluator=evaluator, initial_params=params, steps_per_call=K)
    return Trainer(tcfg, tl, tc.TrainConfig(**over), QuadrupletDataset(root, seed=1),
                   QuadrupletCollator(HashTokenizer(vocab_size=tcfg.vocab_size),
                                      max_length=tcfg.max_seq_length),
                   evaluator=evaluator, initial_params=state_dict_from_flax_params(params, tcfg),
                   steps_per_call=K, device="cpu")


def test_trainer_steps_per_call_matches_jax(tmp_path):
    """``Trainer(steps_per_call=3)`` against qst_tpu's (``test_trainer_steps_per_call``):
    4 batches an epoch run as one multi-step and one remainder step; the
    evaluations fall where qst_tpu's do (after the call that crosses a
    boundary), the logged losses and final weights agree, and the same run
    at one step a call ends with the same weights bit for bit."""
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=2, chunk_dim=8)     # 16 instances
    evals = {"jax": [], "torch": [], "single": []}
    want = _kstep_trainer(root, str(tmp_path / "jax"), "jax", 3, evals["jax"]).train(
        rng=jax.random.key(14))
    got = _kstep_trainer(root, str(tmp_path / "t"), "torch", 3, evals["torch"]).train()
    single = _kstep_trainer(root, str(tmp_path / "s"), "torch", 1, evals["single"]).train()
    assert got.state.step == int(want.state.step) == 8
    assert evals["torch"] == evals["jax"] == [(-1, -1), (0, 3), (0, 4), (0, 4), (1, 7), (1, 8),
                                              (1, 8)]
    assert [h["steps"] for h in got.history] == [s for _, s in evals["torch"]]
    logged = [tcallbacks_json(tc.TrainConfig(experiment_dir=str(tmp_path / d)))
              for d in ("t", "jax")]
    assert [e["steps"] for e in logged[0]] == [e["steps"] for e in logged[1]] == [3, 4, 7, 8]
    np.testing.assert_allclose([e["loss"] for e in logged[0]], [e["loss"] for e in logged[1]],
                               rtol=1e-5)
    want_sd = state_dict_from_flax_params(jax.tree.map(np.asarray, want.state.params),
                                          _configs(False)[1][0])
    for k, v in want_sd.items():
        atol = 2 * LR if k.endswith("attention.self.key.bias") else 0.1 * LR
        np.testing.assert_allclose(got.state.model.state_dict()[k].numpy(), v.numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    for (k, a), b in zip(got.state.model.state_dict().items(),
                         single.state.model.state_dict().values()):
        assert torch.equal(a, b), k


def _cuda_tiny_states(dropout, accum, n):
    cfg = tc.EncoderConfig.tiny(use_fused_layer=True, hidden_dropout=dropout,
                                attention_dropout=dropout)
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=True)
    tcfg = tc.TrainConfig(learning_rate=LR, warmup_steps=2, gradient_accumulation_steps=accum)
    states = [tts.create_train_state(cfg, tcfg, torch.Generator().manual_seed(2), 20, loss_cfg,
                                     device="cuda")[0] for _ in range(n)]
    return cfg, loss_cfg, states


@pytest.mark.cuda
@pytest.mark.parametrize("dropout,accum", [(0.1, 1), (0.0, 1), (0.1, 2)])
def test_cuda_captured_steps_equal_eager_steps(dropout, accum):
    """On the card: two calls of K = 4 (the first runs its steps eagerly and
    captures, the second replays the graph) against 8 single steps from the
    same state — losses, parameters and Adam moments bit for bit — and the
    replay's launches counted exactly: K1 and K2 per layer and step, K3 once
    each way per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import quadruplet as qd

    K = 4
    cfg, loss_cfg, (graph_st, eager_st) = _cuda_tiny_states(dropout, accum, 2)
    ids, mask = _stacked(cfg.max_seq_length, 2 * K, seed=11)
    keys = torch.stack([tts.dropout_key(3, s) for s in range(1, 2 * K + 1)])
    multi = tts.make_multi_step(cfg, loss_cfg, None, K)
    counters = (fl.fused_bert_layer, fl.fused_bert_layer_bwd,
                qd.fused_gamma_quadruplet_loss_fwd, qd.fused_gamma_quadruplet_loss_bwd)
    graph_losses = []
    for call in range(2):
        before = [c.launches for c in counters]
        graph_st, losses = multi(graph_st, ids[call * K:(call + 1) * K],
                                 mask[call * K:(call + 1) * K], keys[call * K:(call + 1) * K])
        torch.cuda.synchronize()
        graph_losses.append(losses)
        L = cfg.num_layers
        assert [c.launches - b for c, b in zip(counters, before)] == [K * L, K * L, K, K]
    assert multi._graph is not None
    step = tts.make_train_step(cfg, loss_cfg)
    eager_losses = []
    for j in range(2 * K):
        eager_st, loss = step(eager_st, ids[j], mask[j], keys[j])
        eager_losses.append(loss)
    assert torch.equal(torch.cat(graph_losses), torch.stack(eager_losses))
    for a, b in zip(_state_tensors(graph_st), _state_tensors(eager_st)):
        assert torch.equal(a, b)
    assert graph_st.step == eager_st.step == 2 * K
