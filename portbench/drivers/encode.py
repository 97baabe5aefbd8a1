"""Corpus encoding through ``SentenceEncoder.encode`` with its
defaults (batch 256, numpy out, ``dispatch_depth`` 4).

Set-up: the weights on the device, the vocabulary, the port's tokenizer,
the encoder, a pool of texts from the traffic file's length distribution
and a seeded order that cycles through it. Warm-up: the first calls of that
order. Window: calls of ``texts_per_call`` texts, one after another, until
``--seconds`` have passed; ``encode_docs_per_s`` counts the texts whose
embedding reached the host over the whole window.

Check: a sample of the window's texts drawn from the seed, the pool's
longest among them; the reference encodes each at its own length, and
``embedding_gap`` is the largest distance between a program embedding and
the reference's (both unit vectors).
"""

from __future__ import annotations

import shutil

import numpy as np
import torch

from portbench import data, program
from portbench.harness import (
    Check,
    Outcome,
    Run,
    TokenizerProbe,
    Window,
    free_program_memory,
    peak_memory,
    spanned,
)
from portbench.reference import encoder as ref
from portbench.reference.precision import strict_f32


def keep(positions: np.ndarray, salt: int, every: int) -> np.ndarray:
    """The positions a seeded hash selects, about one in ``every``."""
    h = (positions.astype(np.uint64) * np.uint64(2654435761) + np.uint64(salt)) % np.uint64(1 << 32)
    return h < np.uint64((1 << 32) // every)


def run(run: Run) -> Outcome:
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder

    cfg, tr, dev, seed = run.cfg, run.traffic, run.device, run.seed
    run.phase("imports")
    lex = data.Lexicon(cfg["model_type"], cfg["vocab_size"], seed)
    tmp = data.scratch_dir("portbench_encode_")
    tok = TokenizerProbe(program.tokenizer(lex.write(f"{tmp}/vocab.txt")))
    run.phase("lexicon and tokenizer")
    weights = data.make_weights(cfg, seed, dev)
    run.phase("weights")
    encoder = SentenceEncoder(program.encoder_config(cfg), weights, tok, device=dev)
    del weights
    run.phase("encoder")
    shapes = []
    inner = encoder.encode_ids

    def encode_ids(ids, mask):
        shapes.append(tuple(ids.shape))
        return inner(ids, mask)

    encoder.encode_ids = spanned(encode_ids, "portbench.encode_ids")
    encode = spanned(encoder.encode, "portbench.encode")
    rng = data.rng_of(seed, "texts")
    pool = lex.texts(tr["lengths"], tr["pool"], rng)
    order = rng.permutation(len(pool))
    per_call, batch = tr["texts_per_call"], tr["batch_size"]

    def texts_of(c: int):
        pos = np.arange(c * per_call, (c + 1) * per_call)
        return pos, [pool[i] for i in order[pos % len(pool)]]

    run.phase("texts")
    for c in range(tr["warm_calls"]):
        encoder.encode(texts_of(c)[1], batch_size=batch)
    run.phase("warm-up")
    salt = data.sub_seed(seed, "sample")
    longest = int(np.argmax([len(t) for t in pool]))
    kept_pos, kept_emb = [], []
    window, tracer = Window(run), run.tracer()
    limit_s = min(run.seconds, tr["trace_seconds"]) if run.trace else run.seconds
    window.start()
    tracer.start()
    marks = (len(shapes), tok.mark())
    docs, failed, c = 0, 0, tr["warm_calls"]
    while True:
        pos, texts = texts_of(c)
        emb = encode(texts, batch_size=batch)
        docs += len(texts)
        failed += int((~np.isfinite(emb.sum(axis=1))).sum())
        sel = keep(pos, salt, run.check["every"]) | (order[pos % len(pool)] == longest)
        kept_pos.append(pos[sel])
        kept_emb.append(emb[sel])
        c += 1
        if window.elapsed() >= limit_s:
            break
    seconds = window.stop()
    tracer.stop()
    calls, tok_s, n_lengths = tok.mark()
    lengths = np.concatenate(tok.real_lengths[marks[1][2]:n_lengths])
    observed = {"lengths": lengths, "slots": sum(b * s for b, s in shapes[marks[0]:]),
                "batches": len(shapes) - marks[0],
                "tokenize_s": tok_s - marks[1][1], "tokenize_calls": calls - marks[1][0],
                "window_s": seconds}
    memory = peak_memory(run)
    del encoder, encode, inner, tok
    free_program_memory(run)

    # the check: the reference over a sample of the window's texts
    pos = np.concatenate(kept_pos)
    emb = np.concatenate(kept_emb)
    first = {}
    for i, p in enumerate(pos):                 # one row a text, the pool's longest kept
        first.setdefault(int(order[p % len(pool)]), i)
    text_ids = list(first)
    rows = [first[t] for t in text_ids]
    pick = data.rng_of(seed, "pick").permutation(len(rows))[:run.check["sample"]].tolist()
    if longest in first and text_ids.index(longest) not in pick:
        pick.append(text_ids.index(longest))
    texts = [pool[text_ids[i]] for i in pick]
    got = torch.from_numpy(emb[[rows[i] for i in pick]]).to(dev)
    weights = ref.f32_weights(data.make_weights(cfg, seed, dev))
    with strict_f32():
        want = ref.embed_texts(cfg, weights, lex.tokenizer, texts, cfg["max_seq_length"], dev)
        gap = float((got - want).norm(dim=1).max())
        control = {}
        if run.control:
            low = ref.embed_texts(cfg, weights, lex.tokenizer, texts, cfg["max_seq_length"], dev,
                                  precision="fp8")
            control["embedding_gap"] = float((low - want).norm(dim=1).max())
    checks = [Check("embedding_gap", gap, run.limit("embedding_gap")),
              Check("texts_compared_short", float(max(0, run.check["min_compared"] - len(texts))),
                    0.0)]
    shutil.rmtree(tmp, ignore_errors=True)
    rate = docs / seconds
    return Outcome(attempted=docs, failed=failed,
                   e2e={"encode_docs_per_s": rate},
                   setup_s=window.setup_s, memory_peak_bytes=memory, checks=checks,
                   launched=window.launched, observed=observed, trace=tracer.summary,
                   control=control)
