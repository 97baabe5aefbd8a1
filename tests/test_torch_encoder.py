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


def test_unported_arch_raises():
    with pytest.raises(NotImplementedError):
        tse.SentenceEncoderModule(EncoderConfig.tiny(arch="mpnet"))
