"""Training on device meshes: the port's sharding rules, tensor-parallel
state, data- and tensor-parallel train steps and multi-step, and the
device-drawn dropout of the ``nn.Module`` path, against qst_tpu's
(``tests/test_parallel.py``, ``tests/test_train.py``).

The port's meshes are ``make_mesh(d, m, devices=["cpu"] * (d·m))``: one
process, each shard a position of the host; qst_tpu's side runs on its 8
virtual CPU devices (``mesh8``, 4 × 2). Same weights (JAX ``init_params`` →
``state_dict_from_flax_params``) and numpy batches go through both
packages at f32 and dropout 0. Tolerances: the loss at rtol 1e-5, the eval
loss after a step at JAX's rtol 2e-4, parameters after one AdamW step at
lr = 1e-4 to atol 1e-5 = 0.1·lr — Adam's first step divides each gradient
by its own magnitude, so the key bias, whose gradient is zero up to
rounding, moves by up to ±lr in either package (atol 2·lr there), as in
``test_torch_train.py``. With dropout the draws are the port's own, so
the port is held to itself: bit-equal between calls, the same as a step
that draws the same masks, and distinct across shards, layers and keys.
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
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.parallel import sharding as jsharding
from qst_tpu.train import train_step as jts
from qst_tpu_torch.core import config as tc
from qst_tpu_torch.core.meshes import make_mesh
from qst_tpu_torch.data import QuadrupletCollator, QuadrupletDataset
from qst_tpu_torch.models.bert import DeviceDropout, TensorParallelLayer
from qst_tpu_torch.models.hf_import import (
    flax_params_from_state_dict,
    state_dict_from_flax_params,
)
from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule, init_params
from qst_tpu_torch.models.tokenizer import HashTokenizer
from qst_tpu_torch.parallel import sharding as tsharding
from qst_tpu_torch.train import train_step as tts
from qst_tpu_torch.train.checkpoints import CheckpointManager
from qst_tpu_torch.train.trainer import Trainer

B = 8
LR = 1e-4
MPNET = dict(name="mpnet-tp", arch="mpnet", vocab_size=128, hidden_size=32, num_layers=1,
             num_heads=4, intermediate_size=64, max_position_embeddings=64,
             max_seq_length=16, dtype="float32", pad_token_id=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these steps are many small ops at tiny shapes,
    which a thread pool only slows, most of all in the suite's parallel
    run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(data, model):
    return make_mesh(data, model, devices=["cpu"] * (data * model))


def _batch(S, seed=0, K=None):
    rng = np.random.default_rng(seed)
    shape = (4, B, S) if K is None else (K, 4, B, S)
    ids = rng.integers(5, 128, shape).astype(np.int32)
    mask = np.ones(shape, np.int32)
    mask[..., S // 2:] = 0
    return ids, mask


def _configs(fused: bool, **enc):
    jcfg = jc.EncoderConfig.tiny(**{**dict(hidden_dropout=0.0, attention_dropout=0.0,
                                           use_fused_layer=fused), **enc})
    jl = jc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=fused)
    jt = jc.TrainConfig(batch_size=B, learning_rate=LR, scheduler="constantlr",
                        max_grad_norm=0.5)
    to_t = lambda cls, c: cls(**dataclasses.asdict(c))  # noqa: E731
    return (jcfg, jl, jt), (to_t(tc.EncoderConfig, jcfg), to_t(tc.LossConfig, jl),
                            to_t(tc.TrainConfig, jt))


def _assert_params(got, want, lr=LR):
    for k, v in want.items():
        atol = 2 * lr if k.endswith("attention.self.key.bias") else 0.1 * lr
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), rtol=0, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------- the rules
def _role(kind, shape_rank, spec_axis, name):
    """Which features a sharded axis holds: "out" or "in" (None: replicated)."""
    if spec_axis is None:
        return None
    if kind == "jax":
        if shape_rank == 1 or name.endswith("bias"):
            return "out"
        if shape_rank == 2:
            return "in" if spec_axis == 0 else "out"
        inputs = 2 if ("output_dense" in name or name.split("/")[-2] == "o") else 1
        return "in" if spec_axis < inputs else "out"
    return "out" if spec_axis == 0 else "in"


@pytest.mark.parametrize("arch", ["bert", "mpnet"])
def test_port_specs_split_what_jax_splits(arch):
    """Each port tensor's rule splits the same features (heads, FFN columns;
    a kernel's inputs or outputs) as JAX's rule for the counterpart leaf:
    every leaf of a probe tree is filled with its own index, so the port
    tensor it becomes names it."""
    jcfg = (jc.EncoderConfig(**MPNET) if arch == "mpnet" else jc.EncoderConfig.tiny())
    tcfg = tc.EncoderConfig(**dataclasses.asdict(jcfg))
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    probe = jax.tree_util.tree_unflatten(
        tree, [np.full(np.shape(v), i + 1, np.float32) for i, (_, v) in enumerate(leaves)])
    jspecs = jax.tree_util.tree_leaves(jsharding.tree_param_specs(params),
                                       is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    sd = state_dict_from_flax_params(probe, tcfg)
    sharded = 0
    for name, t in sd.items():
        i = int(t.reshape(-1)[0]) - 1
        path = "/".join(str(getattr(k, "key", k)) for k in leaves[i][0])
        jspec = tuple(jspecs[i])
        jaxis = next((a for a, s in enumerate(jspec) if s == "model"), None)
        tspec = tsharding.spec_for_param(name, t.ndim)
        taxis = tsharding.split_dim(tspec)
        assert _role("jax", np.ndim(leaves[i][1]), jaxis, path) == _role(
            "port", t.ndim, taxis, name), (name, path, jspec, tspec)
        sharded += taxis is not None
    assert sharded == 10 * tcfg.num_layers      # q/k/v weight+bias, o, FFN in w+b, FFN out
    # a moment's name embeds its parameter's
    assert tsharding.spec_for_param("mu/encoder.layer.0.attention.self.query.weight", 2) == (
        "model", None)
    assert tsharding.spec_for_param("encoder.layer.0.output.LayerNorm.weight", 1) == ()


def test_create_sharded_and_state_shardings():
    """``create_sharded`` lays a state dict out by the rules (blocks on the
    model axis' devices, replicated tensors once); ``state_shardings`` finds
    the same layout from shapes alone (the meta device)."""
    cfg = tc.EncoderConfig.tiny()
    mesh = _mesh(4, 2)
    make = lambda: init_params(cfg, torch.Generator().manual_seed(0), device="cpu")  # noqa: E731
    laid, shardings = tsharding.create_sharded(mesh, make)
    sd = make()
    assert set(laid) == set(sd) == set(shardings)
    q = "encoder.layer.0.attention.self.query.weight"
    assert shardings[q].spec == ("model", None) and len(laid[q]) == 2
    assert torch.equal(torch.cat(laid[q]), sd[q])
    assert torch.equal(laid["embeddings.word_embeddings.weight"],
                       sd["embeddings.word_embeddings.weight"])
    shapes_only = tsharding.state_shardings(mesh, SentenceEncoderModule, cfg)
    assert {n: s.spec for n, s in shapes_only.items()} == {
        n: s.spec for n, s in shardings.items()}


@pytest.mark.parametrize("arch", ["bert", "mpnet"])
def test_tensor_parallel_state(arch):
    """``create_train_state_sharded``: each layer a ``TensorParallelLayer``
    holding its heads' and FFN columns' slices (copies, not views), the
    gathered state the initial one, Adam's moments beside every tensor,
    the optimizer over each slice and each replicated tensor once."""
    cfg = (tc.EncoderConfig(**MPNET) if arch == "mpnet" else tc.EncoderConfig.tiny())
    tcfg = tc.TrainConfig(batch_size=8, scheduler="constantlr")
    sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state, opt = tts.create_train_state_sharded(
        cfg, tcfg, torch.Generator(), 10, _mesh(4, 2), initial_params=sd)
    layer = state.model.encoder.layer[0]
    assert isinstance(layer, TensorParallelLayer) and len(layer.shards) == 2
    assert layer.shards[1].query.weight.shape == (cfg.hidden_size // 2, cfg.hidden_size)
    assert layer.shards[0].output.weight.shape == (cfg.hidden_size, cfg.intermediate_size // 2)
    flat = state.flat_state_dict()
    assert flat.keys() == sd.keys() and all(torch.equal(flat[k], sd[k]) for k in sd)
    n_full = sum(t.numel() for t in sd.values())
    assert sum(p.numel() for p in opt.param_groups[0]["params"]) == n_full
    ptrs = [p.data_ptr() for p in opt.param_groups[0]["params"]]
    assert len(set(ptrs)) == len(ptrs)
    opt.init_state()
    assert all(opt.state[p]["mu"].shape == p.shape for p in opt.param_groups[0]["params"])
    q = ("encoder.layer.0.attention.attn.q.weight" if arch == "mpnet"
         else "encoder.layer.0.attention.self.query.weight")
    # the layer's slices are the blocks of the dimension the rule splits
    dim = tsharding.split_dim(tsharding.spec_for_param(q, 2))
    assert dim == 0 and torch.equal(layer.shards[1].query.weight, sd[q].chunk(2, dim)[1])


# ---------------------------------------------------------------- the steps
@pytest.fixture(scope="module")
def jax_steps(mesh8):
    """qst_tpu's one DP step (replicated state) and one DP+TP step (sharded
    state) on mesh8, for both paths, from one init: → {(fused, tp): (params
    before, params after, loss, eval loss)}."""
    out = {}
    ids, mask = _batch(16)
    for fused in (False, True):
        (jcfg, jl, jt), _ = _configs(fused)
        params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
        evl = jts.make_eval_loss_fn(jcfg, jl)
        for tp in (False, True):
            if tp:
                st, tx, _ = jts.create_train_state_sharded(jcfg, jt, jax.random.key(0), 10,
                                                           mesh8, jl, initial_params=params)
            else:
                st, tx = jts.create_train_state(jcfg, jt, jax.random.key(0), 10, jl,
                                                initial_params=params)
            st, loss = jts.make_train_step(jcfg, jl, tx, mesh=mesh8)(
                st, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(3))
            out[(fused, tp)] = (params, jax.tree.map(np.asarray, st.params), float(loss),
                                float(evl(st.params, jnp.asarray(ids), jnp.asarray(mask))))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
@pytest.mark.parametrize("tp", [False, True], ids=["dp", "dp_tp"])
def test_sharded_step_matches_jax(jax_steps, fused, tp):
    """One step on a 4 × 1 mesh (DP) or a 4 × 2 mesh with the tensor-parallel
    state (DP + TP) against qst_tpu's ``make_train_step(mesh=mesh8)``."""
    params, jparams, jloss, jeval = jax_steps[(fused, tp)]
    _, (tcfg, tl, tt) = _configs(fused)
    init = state_dict_from_flax_params(params, tcfg)
    if tp:
        mesh = _mesh(4, 2)
        st, _ = tts.create_train_state_sharded(tcfg, tt, torch.Generator(), 10, mesh, tl,
                                                  initial_params=init)
    else:
        mesh = _mesh(4, 1)
        st, _ = tts.create_train_state(tcfg, tt, torch.Generator(), 10, tl,
                                       initial_params=init, device="cpu")
    ids, mask = _batch(16)
    st, loss = tts.make_train_step(tcfg, tl, None, mesh)(st, ids, mask, None)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    flat = st.flat_state_dict()
    _assert_params(flat, state_dict_from_flax_params(jparams, tcfg))
    model = SentenceEncoderModule(tcfg)
    model.load_state_dict(flat)
    got = tts.make_eval_loss_fn(tcfg, tl)(model, ids, mask)
    np.testing.assert_allclose(got.item(), jeval, rtol=2e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_sharded_multi_step_matches_jax(mesh8, fused):
    """K = 2 steps in one call on the 4 × 2 mesh (tensor-parallel state)
    against qst_tpu's ``make_multi_step(mesh=mesh8)`` (replicated state)."""
    (jcfg, jl, jt), (tcfg, tl, tt) = _configs(fused)
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(1)))
    ids, mask = _batch(16, seed=2, K=2)
    sj, tx = jts.create_train_state(jcfg, jt, jax.random.key(0), 10, jl, initial_params=params)
    sj, lj = jts.make_multi_step(jcfg, jl, tx, 2, mesh=mesh8)(
        sj, jnp.asarray(ids), jnp.asarray(mask), jax.random.split(jax.random.key(1), 2))
    mesh = _mesh(4, 2)
    st, _ = tts.create_train_state_sharded(tcfg, tt, torch.Generator(), 10, mesh, tl,
                                              initial_params=state_dict_from_flax_params(
                                                  params, tcfg))
    st, lt = tts.make_multi_step(tcfg, tl, None, 2, mesh)(st, ids, mask, None)
    assert st.step == 2 and lt.shape == (2,)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    _assert_params(st.flat_state_dict(),
                   state_dict_from_flax_params(jax.tree.map(np.asarray, sj.params), tcfg))


def _state(cfg, loss_cfg, mesh=None, seed=4, accum=1):
    tcfg = tc.TrainConfig(learning_rate=1e-3, warmup_steps=2, gradient_accumulation_steps=accum)
    sd = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    if mesh is not None and mesh.shape["model"] > 1:
        return tts.create_train_state_sharded(cfg, tcfg, torch.Generator(), 10, mesh, loss_cfg,
                                              initial_params=sd)[0]
    return tts.create_train_state(cfg, tcfg, torch.Generator(), 10, loss_cfg,
                                  initial_params=sd, device="cpu")[0]


def _tensors(st):
    return [t.detach().clone() for t in st.optimizer.state_tensors()]


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
@pytest.mark.parametrize("shape", [(4, 1), (4, 2)], ids=["dp", "dp_tp"])
def test_sharded_steps_are_bit_equal_between_calls(fused, shape):
    """At dropout 0.1 a sharded step from the same state and key gives the
    same bits twice (the gradients summed in data-index order), and K = 3
    steps in one multi-step call are K single sharded steps bit for bit."""
    cfg = tc.EncoderConfig.tiny(use_fused_layer=fused)
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=fused)
    mesh = _mesh(*shape)
    ids, mask = _batch(cfg.max_seq_length, seed=5, K=3)
    keys = torch.stack([tts.dropout_key(7, s) for s in (1, 2, 3)])
    step = tts.make_train_step(cfg, loss_cfg, None, mesh)
    a, b, m = (_state(cfg, loss_cfg, mesh) for _ in range(3))
    losses = []
    for st in (a, b):
        for j in range(3):
            _, loss = step(st, ids[j], mask[j], keys[j])
            losses.append(loss)
    assert torch.equal(torch.stack(losses[:3]), torch.stack(losses[3:]))
    for x, y in zip(_tensors(a), _tensors(b)):
        assert torch.equal(x, y)
    _, multi = tts.make_multi_step(cfg, loss_cfg, None, 3, mesh)(m, ids, mask, keys)
    assert torch.equal(multi, torch.stack(losses[:3]))
    for x, y in zip(_tensors(a), _tensors(m)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_a_one_position_mesh_is_the_unsharded_step(fused):
    """A 1 × 1 mesh runs the unsharded step: the same bits at dropout 0.1."""
    cfg = tc.EncoderConfig.tiny(use_fused_layer=fused)
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=fused)
    ids, mask = _batch(cfg.max_seq_length, seed=6)
    key = tts.dropout_key(3, 1)
    runs = []
    for mesh in (None, _mesh(1, 1)):
        st = _state(cfg, loss_cfg)
        _, loss = tts.make_train_step(cfg, loss_cfg, None, mesh)(st, ids, mask, key)
        runs.append((loss, _tensors(st)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(x, y) for x, y in zip(runs[0][1], runs[1][1]))


def test_data_shards_draw_their_own_masks():
    """On the fused and the module path a data shard's key is the step's
    folded with its index: the shards' embeddings differ from the unsharded
    draw's, while a shard alone under its folded key gives its rows."""
    from qst_tpu_torch.ops.fused_layer import fold_key

    cfg = tc.EncoderConfig.tiny(hidden_dropout=0.3, attention_dropout=0.3)
    model = SentenceEncoderModule(cfg)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(1), device="cpu"))
    model.train()
    ids, mask = (torch.from_numpy(a.reshape(4 * B, -1)).long() for a in _batch(32, seed=1))
    key = tts.dropout_key(2, 9)
    fwd = tts.encoder_apply_fn(cfg, _mesh(4, 1))
    emb = fwd(model, ids, mask, key)
    plain = tts.encoder_apply_fn(cfg)
    rows = 4 * B // 4
    for i in range(4):
        part = plain(model, ids[i * rows:(i + 1) * rows], mask[i * rows:(i + 1) * rows],
                     fold_key(key, i))
        assert torch.equal(emb[i * rows:(i + 1) * rows], part)
    assert not torch.allclose(emb, plain(model, ids, mask, key))


def test_device_dropout_is_a_pure_function_of_key_layer_and_site():
    """The device draw: the same key draws the same mask; another layer, site, key or a
    folded key (a data shard, a microbatch) another; a head slice draws its
    part of the whole tensor's mask; the kept share is the rate's."""
    from qst_tpu_torch.ops.fused_layer import fold_key

    key = tts.dropout_key(14, 3)
    shape = (4, 6, 16, 16)
    d = DeviceDropout(key, 2)
    m = d.keep(shape, 1, 0.1, "cpu")
    assert torch.equal(m, DeviceDropout(key.clone(), 2).keep(shape, 1, 0.1, "cpu"))
    others = [DeviceDropout(key, 3).keep(shape, 1, 0.1, "cpu"),
              d.keep(shape, 2, 0.1, "cpu"),
              DeviceDropout(tts.dropout_key(14, 4), 2).keep(shape, 1, 0.1, "cpu"),
              DeviceDropout(fold_key(key, 0), 2).keep(shape, 1, 0.1, "cpu"),
              DeviceDropout(fold_key(key, 1), 2).keep(shape, 1, 0.1, "cpu")]
    for o in others:
        assert not torch.equal(m, o)
    assert not torch.equal(others[3], others[4])
    part = d.keep((4, 3, 16, 16), 1, 0.1, "cpu", heads=(3, 6))
    assert torch.equal(part, m[:, 3:])
    assert abs(m.float().mean().item() - 0.9) < 0.01


def _np_hash31(idx, seed, tag):
    """murmur3-fmix32 of idx ^ (seed + tag·0x9E3779B9), low 31 bits, in uint32."""
    with np.errstate(over="ignore"):
        h = idx.astype(np.uint32) ^ np.uint32((seed + tag * 0x9E3779B9) & 0xFFFFFFFF)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h & np.uint32(0x7FFFFFFF)


@pytest.mark.parametrize("shape,heads", [((3, 4, 5, 7), None), ((3, 2, 5, 7), (1, 4)),
                                         ((2, 5, 9), None)])
def test_module_keep_mask_is_the_counter_hash(shape, heads):
    """``module_keep_mask`` on the host: the site seed is the hash of the
    key's step under its seed (tag 7) hashed with layer·4 + site (tag 11);
    element i is kept when the hash of its index in the whole tensor (tag
    0) is under int((1 − rate)·(2³¹ − 1)) — a numpy twin in uint32."""
    from qst_tpu_torch.ops.fused_layer import module_keep_mask

    key, layer, site, rate = tts.dropout_key(123456789, 77), 3, 2, 0.15
    got = module_keep_mask(key, layer, site, shape, rate, "cpu", heads)
    seed0, step = (int(v) & 0xFFFFFFFF for v in key.tolist())
    base = int(_np_hash31(np.array([step]), seed0, 7)[0])
    seed = int(_np_hash31(np.array([layer * 4 + site]), base, 11)[0])
    full = list(shape) if heads is None else [shape[0], heads[1], *shape[2:]]
    index = np.arange(np.prod(full)).reshape(full)
    if heads is not None:
        index = index[:, heads[0]:heads[0] + shape[1]]
    want = _np_hash31(index, seed, 0) < int((1.0 - rate) * 2147483647.0)
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_tensor_parallel_layers_draw_the_unsharded_masks():
    """With dropout on the module path a tensor-parallel model (1 × 2 mesh)
    draws the unsharded model's masks: its forward and gradients are the
    unsharded ones under the same key."""
    cfg = tc.EncoderConfig.tiny(hidden_dropout=0.2, attention_dropout=0.2)
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5)
    ids, mask = (torch.from_numpy(a.reshape(4 * B, -1)).long() for a in _batch(32, seed=3))
    key = tts.dropout_key(5, 2)
    fwd = tts.encoder_apply_fn(cfg)
    grads = []
    for mesh in (None, _mesh(1, 2)):
        st = _state(cfg, loss_cfg, mesh)
        st.model.train()
        emb = fwd(st.model, ids, mask, key)
        tts.loss_from_config(loss_cfg)(*emb.reshape(4, B, -1)).backward()
        named = {n: p.grad for n, p in st.model.named_parameters()}
        grads.append((emb, named if st.layout is None else st.layout.export(named)))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=0, atol=1e-6)
    for k, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][k], g, rtol=1e-4, atol=1e-7, msg=k)


# ------------------------------------------------------- checkpoints, trainer
def test_tensor_parallel_checkpoint_is_gathered_and_restores(tmp_path):
    """A tensor-parallel state is saved gathered under HF names (moments
    too) and ``restore_latest`` lays it back into a fresh state's slices;
    ``params.pt`` holds the flat layout; a plain checkpoint refuses to load
    into it."""
    cfg = tc.EncoderConfig.tiny()
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5)
    mesh = _mesh(2, 2)
    st = _state(cfg, loss_cfg, mesh)
    ids, mask = _batch(cfg.max_seq_length)
    tts.make_train_step(cfg, loss_cfg, None, mesh)(st, ids, mask, None)
    mgr = CheckpointManager(str(tmp_path / "ck"), save_steps=1)
    mgr.save_now(st, 1)
    assert mgr.update_best(st, 1.0)
    saved = torch.load(str(tmp_path / "ck" / "periodic" / "1" / "state.pt"), weights_only=True)
    assert saved["layout"] == "tensor_parallel"
    assert set(saved["model"]) == set(init_params(cfg, torch.Generator(), device="cpu"))
    assert set(saved["optimizer"]["moments"]["mu"]) == set(saved["model"])
    other = _state(cfg, loss_cfg, mesh, seed=9)
    assert mgr.restore_latest(other) is other and other.step == 1
    for x, y in zip(_tensors(st), _tensors(other)):
        assert torch.equal(x, y)
    assert other.optimizer.param_groups[0]["count"] == 1
    best = mgr.restore_best_params()
    flat = st.flat_state_dict()
    assert best.keys() == flat.keys() and all(torch.equal(best[k], flat[k]) for k in flat)
    plain = _state(cfg, loss_cfg)
    mgr.save_now(plain, 2)
    with pytest.raises(ValueError, match="same flags"):
        mgr.restore_latest(other)


TRAINER_LR = 1e-3


def _trainer_params(jcfg):
    return jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(5)))


def _trainer_init(tcfg):
    """The trainers' initial weights under HF names."""
    (jcfg, _, _), _ = _configs(False)
    return state_dict_from_flax_params(_trainer_params(jcfg), tcfg)


def _trainer(root, exp, framework, mesh):
    """qst_tpu's tiny preset at dropout 0 from its own weights, batch 8, one
    example a role (the collator's choice among several is an rng a
    resumed run starts afresh, in both packages)."""
    (jcfg, jl, _), (tcfg, tl, _) = _configs(False)
    params = _trainer_params(jcfg)
    over = dict(batch_size=8, epochs=1, learning_rate=TRAINER_LR, scheduler="constantlr",
                evaluation_steps=1, checkpoint_save_steps=1, early_stopping_patience=50,
                experiment_dir=exp)
    one = dict(n_pos=1, n_part_pos=1, n_neg=1)     # a resumed run draws no example anew
    if framework == "jax":
        from qst_tpu.data import QuadrupletCollator as JaxCollator
        from qst_tpu.data import QuadrupletDataset as JaxDataset
        from qst_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
        from qst_tpu.train.trainer import Trainer as JaxTrainer

        return JaxTrainer(jcfg, jl, jc.TrainConfig(**over), JaxDataset(root, **one, seed=1),
                          JaxCollator(JaxHashTokenizer(vocab_size=jcfg.vocab_size),
                                      max_length=jcfg.max_seq_length),
                          evaluator=lambda p, e, s: 0.5, mesh=mesh, initial_params=params)
    return Trainer(tcfg, tl, tc.TrainConfig(**over), QuadrupletDataset(root, **one, seed=1),
                   QuadrupletCollator(HashTokenizer(vocab_size=tcfg.vocab_size),
                                      max_length=tcfg.max_seq_length),
                   evaluator=lambda m, e, s: 0.5, mesh=mesh,
                   initial_params=state_dict_from_flax_params(params, tcfg))


def test_trainer_on_a_mesh_matches_jax_and_resumes(tmp_path, mesh8):
    """``Trainer(mesh=4 × 2)`` takes the tensor-parallel state, as qst_tpu's
    ``Trainer(mesh=mesh8)`` does: two steps end at qst_tpu's weights; the
    evaluator sees a flat model; the best artifact is flat; a run resumed
    from the step-1 checkpoint ends with the uninterrupted run's weights."""
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=2, chunk_dim=8)        # 16 instances: 2 steps
    want = _trainer(root, str(tmp_path / "jax"), "jax", mesh8).train(rng=jax.random.key(14))
    trainer = _trainer(root, str(tmp_path / "t"), "torch", _mesh(4, 2))
    seen = []
    trainer.evaluator = lambda m, e, s: seen.append(type(m).__name__) or 0.5
    got = trainer.train()
    assert got.state.step == int(want.state.step) == 2
    assert got.state.layout.kind == "tensor_parallel" and set(seen) == {"SentenceEncoderModule"}
    (_, _, _), (tcfg, _, _) = _configs(False)
    want_sd = state_dict_from_flax_params(jax.tree.map(np.asarray, want.state.params), tcfg)
    flat = got.state.flat_state_dict()
    _assert_params(flat, want_sd, lr=TRAINER_LR)
    # both steps applied: every tensor left its initial value by more than
    # the tolerance (the key bias, whose gradient is rounding noise, aside)
    init = _trainer_init(tcfg)
    moved = {k: (flat[k] - init[k]).abs().max().item() for k in init
             if not k.endswith("attention.self.key.bias")}
    assert min(moved.values()) > 0.1 * TRAINER_LR, moved
    mgr = CheckpointManager(os.path.join(str(tmp_path / "t"), "checkpoints"))
    assert mgr.steps() == [1, 2] and mgr.restore_best_params().keys() == want_sd.keys()
    # resume from step 1
    import shutil

    shutil.copytree(str(tmp_path / "t"), str(tmp_path / "r"))
    shutil.rmtree(str(tmp_path / "r" / "checkpoints" / "periodic" / "2"))
    resumed = _trainer(root, str(tmp_path / "r"), "torch", _mesh(4, 2)).train(resume=True)
    again = resumed.state.flat_state_dict()
    assert resumed.state.step == 2 and all(torch.equal(again[k], flat[k]) for k in flat)


def test_flax_params_round_trip():
    """``flax_params_from_state_dict`` is the reverse of
    ``state_dict_from_flax_params``: a JAX tree carried over and back is the
    same tree, leaf for leaf."""
    jcfg = jc.EncoderConfig.tiny()
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(2)))
    tcfg = tc.EncoderConfig(**dataclasses.asdict(jcfg))
    back = flax_params_from_state_dict(state_dict_from_flax_params(params, tcfg), tcfg)
    want = params if "encoder" in params else {"encoder": params}
    jax.tree.map(np.testing.assert_array_equal, back, want)


@pytest.mark.cuda
def test_cuda_sharded_steps_launch_per_shard_and_replay_bit_for_bit():
    """On the card, at EncoderConfig.tiny() (2 layers, head width 16) with
    dropout 0.1 on meshes of positions of cuda:0: a DP (4 × 1) and a DP + TP
    (4 × 2) fused step launch K1 and K2 once a layer and data shard and K3
    once each way; two calls from the same state are bit-equal; two
    captured calls of K = 2 on 4 × 1 equal four eager sharded steps bit for
    bit, each replay's launches exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import quadruplet as qd

    counters = (fl.fused_bert_layer, fl.fused_bert_layer_bwd,
                qd.fused_gamma_quadruplet_loss_fwd, qd.fused_gamma_quadruplet_loss_bwd)
    cfg = tc.EncoderConfig.tiny(use_fused_layer=True)
    loss_cfg = tc.LossConfig(margin_pos_part=0.5, margin_part_neg=0.5, use_fused_kernel=True)
    tcfg = tc.TrainConfig(learning_rate=1e-3, warmup_steps=2)
    sd = init_params(cfg, torch.Generator().manual_seed(4), device="cuda")
    ids, mask = _batch(cfg.max_seq_length, seed=8, K=4)
    keys = torch.stack([tts.dropout_key(9, s) for s in range(1, 5)])

    def state(mesh):
        if mesh.shape["model"] > 1:
            return tts.create_train_state_sharded(cfg, tcfg, torch.Generator(), 10, mesh,
                                                  loss_cfg, initial_params=sd)[0]
        return tts.create_train_state(cfg, tcfg, torch.Generator(), 10, loss_cfg,
                                      initial_params=sd, device="cuda")[0]

    for shape in ((4, 1), (4, 2)):
        mesh = make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
        step = tts.make_train_step(cfg, loss_cfg, None, mesh)
        runs = []
        for _ in range(2):
            st = state(mesh)
            for c in counters:
                c.launches = 0
            _, loss = step(st, ids[0], mask[0], keys[0])
            torch.cuda.synchronize()
            assert [c.launches for c in counters] == [2 * 4, 2 * 4, 1, 1], shape
            runs.append((loss, _tensors(st)))
        assert torch.equal(runs[0][0], runs[1][0])
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    mesh = make_mesh(4, 1, devices=["cuda:0"] * 4)
    graph_st, eager_st = state(mesh), state(mesh)
    multi = tts.make_multi_step(cfg, loss_cfg, None, 2, mesh)
    losses = []
    for call in range(2):
        for c in counters:
            c.launches = 0
        part = slice(2 * call, 2 * call + 2)
        losses.append(multi(graph_st, ids[part], mask[part], keys[part])[1])
        torch.cuda.synchronize()
        assert [c.launches for c in counters] == [16, 16, 2, 2]
    assert multi._graph is not None
    step = tts.make_train_step(cfg, loss_cfg, None, mesh)
    eager = torch.stack([step(eager_st, ids[j], mask[j], keys[j])[1] for j in range(4)])
    assert torch.equal(torch.cat(losses), eager)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(graph_st), _tensors(eager_st)))


@pytest.mark.cuda
def test_cuda_module_keep_mask_is_its_plain_version():
    """On the card ``module_keep_mask`` is one launch of its kernel and
    equals the plain version bit for bit: whole tensors (four elements a
    word, a ragged tail), a model shard's heads, a key folded on the card;
    and a captured draw replays under a new key in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from qst_tpu_torch.ops import fused_layer as fl

    key = tts.dropout_key(2024, 5).cuda()
    for shape, heads, rate in (((8, 12, 128, 128), None, 0.1), ((8, 6, 128, 128), (6, 12), 0.1),
                               ((3, 5, 7), None, 0.3), ((2, 3, 5, 7), (2, 7), 0.5)):
        for k in (key, fl.fold_key(key, 3)):
            fl.module_keep_mask.launches = 0
            got = fl.module_keep_mask(k, 4, 1, shape, rate, "cuda", heads)
            assert fl.module_keep_mask.launches == 1
            want = fl.module_keep_mask_plain(k, 4, 1, shape, rate, "cuda", heads)
            assert torch.equal(got, want), (shape, heads)
    static = key.clone()
    graph = torch.cuda.CUDAGraph()
    fl.module_keep_mask(static, 0, 3, (4, 16, 32), 0.1, "cuda")
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out = fl.module_keep_mask(static, 0, 3, (4, 16, 32), 0.1, "cuda")
    for step in (6, 7):
        static.copy_(tts.dropout_key(2024, step))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fl.module_keep_mask_plain(static, 0, 3, (4, 16, 32), 0.1, "cuda"))
