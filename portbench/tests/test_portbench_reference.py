"""The plain reference held to qst_tpu_torch on the CPU at small sizes: the
frozen WordPiece and dropout draws bit for bit, the encoders, the loss, the
schedule and the relative-position buckets to float32 rounding."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import data
from portbench.reference import dropout as ref_drop
from portbench.reference import encoder as ref_enc
from portbench.reference import train as ref_train

SMALL = {"bert": dict(model_type="bert", preset="minilm-l6", vocab_size=700, hidden_size=32,
                      num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                      max_position_embeddings=64, type_vocab_size=2, layer_norm_eps=1e-12,
                      hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                      pad_token_id=0, max_seq_length=24, pooling="mean", normalize=True,
                      compute_dtype="float32"),
         "mpnet": dict(model_type="mpnet", preset="mpnet-base", vocab_size=700, hidden_size=32,
                       num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                       max_position_embeddings=66, relative_attention_num_buckets=32,
                       layer_norm_eps=1e-5, hidden_dropout_prob=0.1,
                       attention_probs_dropout_prob=0.1, pad_token_id=1, max_seq_length=24,
                       pooling="mean", normalize=True, compute_dtype="float32")}


@pytest.mark.parametrize("kind", ["bert", "mpnet"])
def test_wordpiece_matches_the_port(kind, tmp_path):
    from qst_tpu_torch.models.tokenizer import load_tokenizer

    lex = data.Lexicon(kind, 900, seed=3)
    texts = lex.texts({"unit": "tokens", "kind": "lognormal", "median": 14, "sigma": 0.6,
                       "min": 4, "max": 60}, 64, np.random.default_rng(1))
    texts += ["Ünïcode wörds, ÀND punctuation!?", "  spaces\tand\nlines  ", ""]
    port = load_tokenizer(lex.write(str(tmp_path / "vocab.txt")))
    ids, mask = port.batch_encode(texts, max_length=32)
    want_ids, want_mask = lex.tokenizer.batch(texts, 32)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)


def test_dropout_draws_match_the_port():
    from qst_tpu_torch.ops import fused_layer as fl

    key = torch.tensor([2200000123 & 0x7FFFFFFF, 5])
    base, layers = fl.step_draws(key, 3)
    want_base, want_layers = ref_drop.step_seeds(int(key[0]), 5, 3)
    assert int(base) == want_base and [int(x) for x in layers] == want_layers
    B, nh, S, H = 10, 4, 6, 8
    seed = want_layers[1]
    np.testing.assert_array_equal(fl._attn_mask(B, nh, S, seed, 0.1, 8, "cpu").numpy(),
                                  ref_drop.attention_mask(B, nh, S, seed, 0.1, 8, "cpu").numpy())
    for tag in (0, 1):
        np.testing.assert_array_equal(
            fl._hidden_mask(B, S, H, seed, 0.1, 8, tag, "cpu").numpy(),
            ref_drop.hidden_mask(B, S, H, seed, 0.1, 8, tag, "cpu").reshape(B * S, H).numpy())
    x = torch.ones((B, S, H))
    np.testing.assert_array_equal(fl.embedding_dropout(x, base, 0.1).numpy(),
                                  ref_drop.embedding_mask((B, S, H), want_base, 0.1, "cpu").numpy())


@pytest.mark.parametrize("kind", ["bert", "mpnet"])
def test_encoder_matches_the_port_in_float32(kind):
    from portbench import program
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule

    cfg = SMALL[kind]
    sd = data.make_weights(cfg, seed=7, device="cpu")
    model = SentenceEncoderModule(program.encoder_config(cfg, use_fused_layer=False)).eval()
    model.load_state_dict(sd)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(5, cfg["vocab_size"], (5, 12), generator=gen)
    mask = torch.ones_like(ids)
    mask[1, 7:] = 0
    mask[3, 4:] = 0
    ids = torch.where(mask > 0, ids, cfg["pad_token_id"])
    with torch.no_grad():
        got = model(ids, mask)["sentence_embedding"]
        want = ref_enc.embed(cfg, sd, ids, mask)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_relative_buckets_match_the_port():
    from qst_tpu_torch.models.mpnet import position_buckets

    for S in (7, 130, 384):
        np.testing.assert_array_equal(position_buckets(S, "cpu").numpy(),
                                      ref_enc.relative_buckets(S).numpy())


def test_loss_and_schedule_match_the_port():
    from qst_tpu_torch.ops.losses import gamma_quadruplet_loss
    from qst_tpu_torch.train.schedules import warmuplinear

    gen = torch.Generator().manual_seed(1)
    a, p, t, n = (torch.nn.functional.normalize(torch.randn(16, 8, generator=gen), dim=1)
                  for _ in range(4))
    torch.testing.assert_close(ref_train.gamma_loss(a, p, t, n, 0.6, 1.0, 0.5, 0.5),
                               gamma_quadruplet_loss(a, p, t, n, gamma=0.6), atol=1e-6, rtol=0)
    schedule = warmuplinear(2e-5, 10, 40)
    for count in (0, 1, 9, 10, 11, 39, 40, 45):
        assert ref_train.warmuplinear(2e-5, 10, 40, count) == pytest.approx(schedule(count))
