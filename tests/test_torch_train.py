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
                                   initial_params=state_dict_from_flax_params(params, tcfg))
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
                                   initial_params=state_dict_from_flax_params(params, tcfg))
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
    st, _ = tts.create_train_state(tcfg, tt, torch.Generator().manual_seed(0), 10, tl)
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
                                   initial_params=state_dict_from_flax_params(params, tcfg))
    got = tts.make_eval_loss_fn(tcfg, tl)(st.model.train(), ids, mask)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_dropout_follows_the_generator(fused):
    """In train() mode with a generator both paths drop: the same generator
    seed gives the same loss, another seed another loss, no generator none."""
    cfg = tc.EncoderConfig.tiny(use_fused_layer=fused)
    st, _ = tts.create_train_state(cfg, tc.TrainConfig(), torch.Generator().manual_seed(0), 10)
    enc = tts.encoder_apply_fn(cfg)
    ids, mask = (torch.from_numpy(a.reshape(4 * B, -1)) for a in _batch(cfg.max_seq_length))
    st.model.train()
    runs = [enc(st.model, ids, mask, g) for g in (torch.Generator().manual_seed(1),
                                                  torch.Generator().manual_seed(1),
                                                  torch.Generator().manual_seed(2), None)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], runs[2])
    assert not torch.allclose(runs[0], runs[3])
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
    state, _ = tts.create_train_state(tcfg, tt, torch.Generator().manual_seed(0), 10, tl)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_steps=2, total_limit=2)
    assert not mgr.maybe_save(state, 1)
    for step in (2, 4, 6):
        assert mgr.maybe_save(state, step)
    assert mgr.steps() == [4, 6]
    assert mgr.update_best(state, 0.5) and not mgr.update_best(state, 0.4)
    state.step = 9
    mgr.save_now(state, 9)
    other, _ = tts.create_train_state(tcfg, tt, torch.Generator().manual_seed(7), 10, tl)
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
    return Trainer(cfg, loss, tcfg, ds, collator), tcfg


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
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=1, chunk_dim=8)
    trainer, cfg = _trainer(root, str(tmp_path / "exp"))
    args = (trainer.encoder_cfg, trainer.loss_cfg, cfg, trainer.dataset, trainer.collator)
    for kw in (dict(steps_per_call=2), dict(pp_stages=2), dict(mesh=object())):
        with pytest.raises(NotImplementedError):
            Trainer(*args, **kw)
    with pytest.raises(ValueError):
        Trainer(*args, steps_per_call=0)


def test_initial_params_reach_training(tmp_path):
    """Trainer(initial_params) at lr 0 finishes with the given weights."""
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=2, chunk_dim=8)
    trainer, _ = _trainer(root, str(tmp_path / "exp0"), learning_rate=0.0, epochs=1,
                          scheduler="constantlr", checkpoint_save_steps=0)
    from qst_tpu_torch.models.sentence_encoder import init_params

    custom = init_params(trainer.encoder_cfg, torch.Generator().manual_seed(99))
    trainer.initial_params = custom
    result = trainer.train()
    for k, v in custom.items():
        np.testing.assert_allclose(result.state.model.state_dict()[k].numpy(), v.numpy(),
                                   atol=1e-7, err_msg=k)
