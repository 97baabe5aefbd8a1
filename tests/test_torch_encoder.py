"""The port's sentence encoder against qst_tpu's.

Weights come from qst_tpu's ``init_params`` and go into the port through
``state_dict_from_flax_params``; ids and masks are numpy arrays fed to both.
Tolerance: embeddings 1e-5 absolute at f32 (unit-norm vectors; the
summation order differs, and the TPU kernel's erf is an approximation with
|err| ≤ 1.5e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.core.config import EncoderConfig as JaxConfig
from qst_tpu.models import sentence_encoder as jse
from qst_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.models import sentence_encoder as tse
from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
from qst_tpu_torch.models.tokenizer import HashTokenizer

ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig.tiny()
    params = jax.tree.map(np.asarray, jse.init_params(jcfg, jax.random.key(11)))
    return jcfg, params, state_dict_from_flax_params(params, EncoderConfig.tiny())


def _ids_mask(cfg, B=10, S=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for i, n in enumerate(rng.integers(1, S + 1, B)):
        mask[i, n:] = 0
    return ids, mask


def _model(cfg, sd):
    model = tse.SentenceEncoderModule(cfg)
    model.load_state_dict(sd)
    return model.eval()


@pytest.mark.parametrize("fused", [False, True])
def test_embed_fn_matches_jax(weights, fused):
    jcfg, params, sd = weights
    jcfg = dataclasses.replace(jcfg, use_fused_layer=fused)
    cfg = EncoderConfig(**dataclasses.asdict(jcfg))
    ids, mask = _ids_mask(cfg)
    want = np.asarray(jse.embed_fn(jcfg)(params, jnp.asarray(ids), jnp.asarray(mask)))
    got = tse.embed_fn(cfg)(_model(cfg, sd), torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_fused_and_module_paths_agree(weights):
    _, _, sd = weights
    cfg = EncoderConfig.tiny()
    ids, mask = _ids_mask(cfg, seed=1)
    model = _model(cfg, sd)
    a = tse.embed_fn(cfg)(model, torch.from_numpy(ids), torch.from_numpy(mask))
    b = tse.embed_fn(dataclasses.replace(cfg, use_fused_layer=True))(
        model, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ATOL)


TEXTS = [f"sentence {i} " + "word " * (i % 23) for i in range(21)] + ["", "a b c"]


@pytest.mark.parametrize("batch_size", [8, 256])
def test_sentence_encoder_encode_matches_jax(weights, batch_size):
    """Batch and sequence bucketing, the mask[n:, 0] = 1 pad rows and the
    empty text all go the same way in both packages."""
    jcfg, params, sd = weights
    want = jse.SentenceEncoder(jcfg, params, JaxHashTokenizer(jcfg.vocab_size)).encode(
        TEXTS, batch_size=batch_size)
    enc = tse.SentenceEncoder(EncoderConfig.tiny(), sd, HashTokenizer(jcfg.vocab_size))
    got = enc.encode(TEXTS, batch_size=batch_size)
    assert isinstance(got, np.ndarray) and got.shape == (len(TEXTS), jcfg.hidden_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    on_device = enc.encode(TEXTS[:3], convert_to_numpy=False)
    assert isinstance(on_device, torch.Tensor)
    np.testing.assert_array_equal(on_device.numpy(), got[:3])
    assert enc.encode([]).shape == (0, jcfg.hidden_size)


def test_state_dict_names_are_hf_bert_model_names(weights):
    """The port's parameters carry HF ``BertModel`` names — the names
    ``qst_tpu.models.hf_export`` writes — so a checkpoint loads as it is."""
    from qst_tpu.models.hf_export import export_bert_state_dict

    jcfg, params, _ = weights
    port_keys = set(tse.SentenceEncoderModule(EncoderConfig.tiny()).state_dict())
    assert port_keys == set(export_bert_state_dict(params, jcfg))


def test_init_params_is_seeded_and_device_bound():
    cfg = EncoderConfig.tiny()
    a = tse.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = tse.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert a.keys() == tse.SentenceEncoderModule(cfg).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["embeddings.LayerNorm.weight"], torch.ones(cfg.hidden_size))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tse.init_params(cfg, torch.Generator().manual_seed(1), device="cuda")


def test_flash_attention_flag_is_honoured(weights, monkeypatch):
    """The flag routes the attention through ``FlashAttention`` (its plain
    versions on the CPU, one call a layer) at S = 128: the pooled embedding
    is the einsum path's, the pad rows' token embeddings are not (segment-id
    semantics; tests/test_torch_flash.py holds both to JAX)."""
    from qst_tpu_torch.ops import flash_attention as tfa

    _, _, sd = weights
    over = dict(max_seq_length=128, max_position_embeddings=128)
    sd = {k: (v if k != "embeddings.position_embeddings.weight"
              else torch.cat([v, v])) for k, v in sd.items()}
    calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    ids, mask = _ids_mask(EncoderConfig.tiny(), B=3, S=128)
    outs = {}
    for flag in (False, True):
        model = _model(EncoderConfig.tiny(use_flash_attention=flag, **over), sd)
        with torch.no_grad():
            outs[flag] = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(calls) == EncoderConfig.tiny().num_layers
    np.testing.assert_allclose(outs[True]["sentence_embedding"].numpy(),
                               outs[False]["sentence_embedding"].numpy(), rtol=0, atol=ATOL)
    pad = mask == 0
    assert pad.any()
    assert (outs[True]["token_embeddings"] - outs[False]["token_embeddings"]).abs().numpy()[
        pad].max() > 0.05


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_remat_gives_the_same_values_and_gradients(weights, dropout):
    """``remat=True`` recomputes each layer in the backward: the embeddings
    and every parameter's gradient equal ``remat=False`` bit for bit, with
    dropout too (the recomputation draws the forward's masks again and
    leaves the generator where the forward left it)."""
    _, _, sd = weights
    base = EncoderConfig.tiny(hidden_dropout=dropout, attention_dropout=dropout)
    ids, mask = (torch.from_numpy(x) for x in _ids_mask(base, B=6, S=12, seed=2))
    runs = []
    for remat in (False, True):
        model = tse.SentenceEncoderModule(dataclasses.replace(base, remat=remat))
        model.load_state_dict(sd)
        model.train()
        gen = torch.Generator().manual_seed(3)
        emb = model(ids, mask, dropout_generator=gen)["sentence_embedding"]
        after_forward = gen.get_state()
        emb.square().sum().backward()
        assert torch.equal(gen.get_state(), after_forward)
        runs.append((emb.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (emb_a, grads_a), (emb_b, grads_b) = runs
    assert torch.equal(emb_a, emb_b)
    assert all(g is not None and torch.equal(g, grads_b[n]) for n, g in grads_a.items())
    if dropout:
        model.eval()        # dropout was on: train() and eval() outputs differ
        assert not torch.equal(model(ids, mask)["sentence_embedding"], emb_b)


def test_encode_takes_pipeline_batches_and_ignores_it(weights):
    jcfg, _, sd = weights
    enc = tse.SentenceEncoder(EncoderConfig.tiny(), sd, HashTokenizer(jcfg.vocab_size))
    np.testing.assert_array_equal(enc.encode(TEXTS, batch_size=8, pipeline_batches=4),
                                  enc.encode(TEXTS, batch_size=8))


@pytest.mark.parametrize("batch_size", [4, 8, 64])
def test_encode_dispatch_depth_gives_identical_arrays(weights, batch_size):
    """Depth 1 lands each batch before the next; depth 4 keeps up to four
    in flight through its ring of buffers (more batches than buffers at
    batch size 4): the arrays are the same, and those of the on-device
    path."""
    jcfg, _, sd = weights
    enc = tse.SentenceEncoder(EncoderConfig.tiny(), sd, HashTokenizer(jcfg.vocab_size))
    texts = TEXTS * 3
    one = enc.encode(texts, batch_size=batch_size, dispatch_depth=1)
    four = enc.encode(texts, batch_size=batch_size, dispatch_depth=4)
    assert one.dtype == np.float32 and one.shape == (len(texts), jcfg.hidden_size)
    np.testing.assert_array_equal(one, four)
    np.testing.assert_array_equal(
        one, enc.encode(texts, batch_size=batch_size, convert_to_numpy=False).numpy())
    for bad in (dict(dispatch_depth=0), dict(pipeline_batches=0)):
        with pytest.raises(ValueError):
            enc.encode(texts, **bad)


def test_similarity_matches_jax(weights):
    jcfg, params, sd = weights
    a, b = TEXTS[:3], TEXTS[2:9]
    want = jse.SentenceEncoder(jcfg, params, JaxHashTokenizer(jcfg.vocab_size)).similarity(a, b)
    got = tse.SentenceEncoder(EncoderConfig.tiny(), sd,
                              HashTokenizer(jcfg.vocab_size)).similarity(a, b)
    assert isinstance(got, np.ndarray) and got.shape == (3, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.argmax(got[2]) == 0           # TEXTS[2] is b[0]
