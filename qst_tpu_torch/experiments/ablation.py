"""Quadruplet-vs-triplet ablation on the port — the recipe of
``benchmarks/ablation_quadruplet_vs_triplet.py`` driven through
``qst_tpu_torch``:

1. write a COCO-style captions annotation file (five topical captions per
   image) and build the quadruplet dataset through ``create_coco_dataset``
   (positive mining at cos ≥ 0.6 with retries, adaptive-crop partial
   positives) with the topic hash embedder;
2. optionally build a WordPiece vocabulary from the constructed corpus;
3. train two arms from the same init on the same data stream — the
   γ-quadruplet loss (γ = 0.6) and the plain triplet loss — with
   hard-contrastive negative mining on the hash embedder, through
   ``Trainer`` (``--steps_per_call`` steps a call, one CUDA graph replay on
   the GPU);
4. evaluate the random-init baseline and both arms: IR under three
   relevance definitions (pos+part / pos-only / part-only) and the
   quadruplet ordering accuracies.

    python -m qst_tpu_torch.experiments.ablation --steps 2000 --wordpiece \\
        --use_fused_layer --steps_per_call 4

Runs on the GPU unless ``--device`` names another device (``--device cpu
--preset tiny --steps 20 --n_images 200 --n_eval 60`` is a CPU smoke run).
The flags and defaults are the JAX script's, plus ``--steps_per_call`` and
``--device``; ``--use_fused_layer`` also puts the γ arm's loss through the fused
quadruplet kernel (K3). The random init and the dropout draws come from
``torch.Generator`` seed 14, which no seed makes equal to ``jax.random``'s;
``run(init_fn=)`` starts both arms from given weights instead.

``--gammas`` is the JAX script's sweep mode: the triplet arm once, then one
γ arm a (γ, margin set) cell of ``--gammas`` × ``--margin_sets``, each from
the same init on the same stream; it prints the
``ablation_gamma_margin_sweep`` JSON line and the sweep table
(``benchmarks/ablation_quadruplet_vs_triplet.py:303-337``):

    python -m qst_tpu_torch.experiments.ablation --steps 2000 --wordpiece \
        --use_fused_layer --steps_per_call 4 --gammas 0.2,0.4,0.6,0.8 \
        --margin_sets 1.0:0.5:0.5,1.0:0.3:0.3

``hash_embed`` and ``make_coco_annotations`` are copies of the JAX
script's, held to them by ``tests/test_torch_dataset.py``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

TOPICS = ("cat dog horse bird fish car truck train plane boat house tower "
          "bridge river mountain forest beach desert island valley pizza "
          "pasta salad bread cheese doctor teacher farmer artist pilot "
          "guitar piano violin drum flute tiger lion bear wolf deer").split()
VERBS = ("runs jumps sleeps flies swims drives climbs falls sings dances "
         "reads writes builds paints cooks waits stands rests turns").split()
PLACES = ("park street field sky ocean kitchen garden station harbor "
          "meadow market library studio farm court plaza valley dock").split()
FILLER = ("quietly slowly quickly happily often rarely gently boldly "
          "calmly eagerly brightly early late softly loudly").split()

# The JAX package's decisive run (benchmarks/RESULTS.md:62-66: 2,000
# steps/arm, WordPiece, fused layers with in-kernel dropout, hard mining)
JAX_DECISIVE = {
    "baseline": {"r10_pos_part": 0.1250, "ndcg10_pos_part": 0.1654, "r10_pos": 0.0725,
                 "acc_pos_part": 0.5217, "acc_part_neg": 0.5383, "acc_pos_neg": 0.8750,
                 "global_accuracy": 0.7033},
    "quadruplet": {"r10_pos_part": 0.3900, "ndcg10_pos_part": 0.4645, "r10_pos": 0.7788,
                   "acc_pos_part": 0.9967, "acc_part_neg": 0.9550, "acc_pos_neg": 1.0000,
                   "global_accuracy": 0.9858},
    "triplet": {"r10_pos_part": 0.3787, "ndcg10_pos_part": 0.4237, "r10_pos": 0.6837,
                "acc_pos_part": 0.9333, "acc_part_neg": 0.8250, "acc_pos_neg": 1.0000,
                "global_accuracy": 0.9342},
}


def hash_embed(texts, dim=128):
    """Deterministic topic-correlated unit vectors (same-topic cos ≈ 0.95,
    cross-topic ≈ 0) — the dataset-construction embedder stand-in."""
    out = np.zeros((len(texts), dim), np.float32)
    for i, t in enumerate(texts):
        words = t.lower().split()
        topic = next((w for w in words if w in TOPICS), "")
        bs = int.from_bytes(hashlib.md5(topic.encode()).digest()[:4], "little")
        ts = int.from_bytes(hashlib.md5(t.encode()).digest()[:4], "little")
        base = np.random.default_rng(bs).standard_normal(dim)
        noise = np.random.default_rng(ts).standard_normal(dim)
        v = base + 0.15 * noise if topic else noise
        out[i] = v / np.linalg.norm(v)
    return out


def make_coco_annotations(path: str, n_images: int, rng) -> None:
    """COCO captions JSON: 5 topical captions per image."""
    images, annotations = [], []
    aid = 0
    for img_id in range(n_images):
        topic = TOPICS[img_id % len(TOPICS)]
        verb = VERBS[(img_id * 3) % len(VERBS)]
        place = PLACES[(img_id * 7) % len(PLACES)]
        variant = img_id // len(TOPICS)
        f = lambda: FILLER[int(rng.integers(0, len(FILLER)))]
        captions = [
            f"a {topic} {verb} {f()} in the {place} area {variant}",
            f"the {topic} {verb} {f()} at the {place} spot {variant}",
            f"one {topic} {f()} {verb} near the {place} side {variant}",
            f"a {topic} that {verb} {f()} by the {place} zone {variant}",
            f"some {topic} {verb} {f()} around the {place} corner {variant}",
        ]
        images.append({"id": img_id})
        for c in captions:
            annotations.append({"id": aid, "image_id": img_id, "caption": c})
            aid += 1
    with open(path, "w") as fobj:
        json.dump({"images": images, "annotations": annotations}, fobj)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=500, help="train steps per arm")
    ap.add_argument("--n_images", type=int, default=4000)
    ap.add_argument("--n_eval", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--use_fused_layer", action="store_true",
                    help="train both arms through the fused layer kernels (K1 with "
                    "in-kernel dropout, K2) and the γ arm's loss through K3")
    ap.add_argument("--wordpiece", action="store_true",
                    help="tokenize with a WordPiece vocab built from the constructed "
                    "dataset instead of the hash tokenizer")
    ap.add_argument("--gammas", type=str, default="",
                    help="comma list of gamma values: sweep mode (VERDICT "
                    "r4 item 5) — trains the triplet baseline once plus one "
                    "gamma arm per (gamma, margin-set) cell and prints a "
                    "sweep table characterizing the part-only R@10 vs "
                    "graded-ordering trade-off")
    ap.add_argument("--margin_sets", type=str, default="1.0:0.5:0.5",
                    help="comma list of pos_neg:pos_part:part_neg margin "
                    "triples for the sweep (reference default 1.0:0.5:0.5, "
                    "models/losses/losses.py:9-19)")
    ap.add_argument("--preset", default="minilm_l6", choices=["minilm_l6", "tiny"],
                    help="encoder preset (tiny = CPU smoke testing)")
    ap.add_argument("--steps_per_call", type=int, default=1,
                    help="train steps per call (K > 1: one CUDA graph replay on the GPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; --device cpu runs on the host)")
    return ap


def wordpiece_vocab(instances: List[dict]) -> Dict[str, int]:
    """Whole words by frequency plus single-character and ##-continuation
    pieces, so crops and substitutions never hit [UNK] (the JAX script's
    ``--wordpiece`` vocabulary)."""
    from collections import Counter

    from qst_tpu_torch.models.tokenizer import basic_tokenize

    all_texts = [c for inst in instances
                 for c in ([inst["reference"]] + inst["positive"] + inst["part_positive"])]
    counts = Counter(w for t in all_texts for w in basic_tokenize(t))
    chars = sorted({c for w in counts for c in w})
    vocab: Dict[str, int] = {}
    for tkn in (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                + chars + ["##" + c for c in chars]
                + [w for w, _ in counts.most_common()]):
        vocab.setdefault(tkn, len(vocab))
    return vocab


def run(args: argparse.Namespace, work: str,
        init_fn: Optional[Callable[[Any], Dict[str, Any]]] = None) -> dict:
    """The whole recipe in ``work`` → {"results": {model: metrics},
    "steps_per_arm", "seconds": {phase: s}, "steps_per_sec": {arm: ...},
    "arms": {arm: its trained state dict}}. ``init_fn(cfg)`` → a state dict
    to start every arm from (default: a random init from seed 14). With
    ``args.gammas`` (the sweep) the arms are the triplet arm, then one a
    (γ, margin set) cell, and ``steps_per_arm`` is the triplet arm's."""
    import dataclasses

    import torch

    from qst_tpu_torch.augment.partial_positive import ADAPTIVE_CROP
    from qst_tpu_torch.core.config import EncoderConfig, IREvalConfig, LossConfig, TrainConfig
    from qst_tpu_torch.core.device import resolve_device
    from qst_tpu_torch.data import (
        HARD_CONTRASTIVE_TRAIN, EmbeddingTable, NegativeMiner, QuadrupletCollator,
        QuadrupletDataset)
    from qst_tpu_torch.data.coco import CocoCaptionsSource, create_coco_dataset
    from qst_tpu_torch.evals import InformationRetrievalEvaluator, create_ir_evaluation_set
    from qst_tpu_torch.evals.quadruplet_evaluator import QuadrupletEvaluator
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params
    from qst_tpu_torch.models.tokenizer import HashTokenizer, WordPieceTokenizer
    from qst_tpu_torch.train import Trainer

    device = resolve_device(args.device)
    seconds: Dict[str, float] = {}
    rng = np.random.default_rng(14)

    # --- 1+2: dataset through the construction pipeline
    ann = os.path.join(work, "captions.json")
    make_coco_annotations(ann, args.n_images, rng)
    src = CocoCaptionsSource(ann, dataset_name="synthetic-coco")
    t0 = time.perf_counter()
    last_ok = create_coco_dataset(
        os.path.join(work, "chunks"), src, encode_fn=hash_embed,
        n_pos_examples=4, n_part_pos_examples=4, augment=False,
        part_pos_algorithm=ADAPTIVE_CROP, seed=14)
    if last_ok < 0:
        raise RuntimeError("dataset construction failed (see the log)")
    seconds["dataset"] = time.perf_counter() - t0
    root = os.path.join(work, "chunks", src.dataset_name)
    instances = list(QuadrupletDataset(root, seed=14).store.iter_instances())
    print(f"dataset: {len(instances)} mined instances in {seconds['dataset']:.1f}s "
          f"(pos/inst={np.mean([len(i['positive']) for i in instances]):.1f}, "
          f"part/inst={np.mean([len(i['part_positive']) for i in instances]):.1f})",
          flush=True)
    eval_instances = instances[:args.n_eval]

    overrides = {"max_seq_length": 32}
    if args.use_fused_layer:
        overrides["use_fused_layer"] = True
    if args.wordpiece:
        vocab = wordpiece_vocab(instances)
        overrides["vocab_size"] = -(-len(vocab) // 128) * 128
        tok = WordPieceTokenizer(vocab)
        print(f"wordpiece vocab: {len(vocab)} tokens (embedding table "
              f"{overrides['vocab_size']})", flush=True)
    cfg = getattr(EncoderConfig, args.preset)(**overrides)
    if not args.wordpiece:
        tok = HashTokenizer(vocab_size=cfg.vocab_size)
    if init_fn is None:
        init = init_params(cfg, torch.Generator().manual_seed(14), device=device)
    else:
        init = {k: v.to(device) for k, v in init_fn(cfg).items()}

    # --- 4: evaluators
    ir_cfg = IREvalConfig(
        accuracy_at_k=(1, 5, 10), precision_recall_at_k=(1, 5, 10),
        mrr_at_k=(10,), ndcg_at_k=(10,), map_at_k=(100,), score_functions=("cos_sim",))
    sets = {
        "pos+part": create_ir_evaluation_set(eval_instances, n_queries=200, seed=14),
        "pos_only": create_ir_evaluation_set(eval_instances, n_queries=200, seed=14,
                                             use_part_pos_examples=False),
        "part_only": create_ir_evaluation_set(eval_instances, n_queries=200, seed=14,
                                              use_pos_examples=False),
    }
    ir_evals = {name: InformationRetrievalEvaluator(s.queries, s.corpus, s.relevant,
                                                    cfg=ir_cfg, device=device)
                for name, s in sets.items()}

    # a negative per instance from a different topic (the j+1 neighbour,
    # skipping forward at the wrap), as the JAX script picks it
    def cross_topic_neg(j: int) -> int:
        n_ev = len(eval_instances)
        o = 1
        while (j + o) % n_ev % len(TOPICS) == j % len(TOPICS):
            o += 1
        return (j + o) % n_ev

    quad_eval = QuadrupletEvaluator(
        anchors=[i["reference"] for i in eval_instances],
        positives=[i["positive"][0] for i in eval_instances],
        part_positives=[i["part_positive"][0] for i in eval_instances],
        negatives=[eval_instances[cross_topic_neg(j)]["positive"][1]
                   for j in range(len(eval_instances))])

    def evaluate(params, label):
        enc = SentenceEncoder(cfg, params, tok, device=device)
        encode = lambda texts: enc.encode(list(texts))  # noqa: E731
        out = {}
        for name, ev in ir_evals.items():
            ev(encode)
            m = ev.last_results["cos_sim"]
            out[name] = {k: round(float(m[k]), 4) for k in ("recall@10", "ndcg@10", "map@100")}
        quad_eval(encode)
        out["ordering"] = {k: round(float(v), 4) for k, v in quad_eval.last_scores.items()}
        print(f"[{label}] {json.dumps(out)}", flush=True)
        return out

    t0 = time.perf_counter()
    results = {"baseline": evaluate(init, "baseline (random init)")}
    seconds["evaluate"] = time.perf_counter() - t0
    steps_per_sec: Dict[str, float] = {}

    # --- 3: the two arms from the same init, mined with the hash embedder
    def train_arm(loss_cfg, label):
        ds = QuadrupletDataset(root, n_pos=1, n_part_pos=1, n_neg=1, seed=14)
        mine_embed = lambda texts: hash_embed(list(texts))  # noqa: E731
        table = EmbeddingTable(ds.store.all_positive_captions(), mine_embed,
                               refresh_steps=10**9, max_pool=20000, device=device)
        ds.miner = NegativeMiner(table, mine_embed, mode=HARD_CONTRASTIVE_TRAIN, seed=14)
        epochs = max(1, -(-args.steps * args.batch // len(ds)))
        spe = -(-args.steps // epochs)
        tcfg = TrainConfig(
            batch_size=args.batch, epochs=epochs, learning_rate=args.lr,
            scheduler="warmuplinear", warmup_steps=50, evaluation_steps=0,
            checkpoint_save_steps=0, use_amp=True, seed=14,
            experiment_dir=os.path.join(work, f"exp_{label}"))
        collator = QuadrupletCollator(tok, max_length=cfg.max_seq_length)
        trainer = Trainer(cfg, loss_cfg, tcfg, ds, collator, evaluator=None,
                          steps_per_epoch=spe, steps_per_call=args.steps_per_call,
                          initial_params=init, device=device)
        t0 = time.perf_counter()
        result = trainer.train(seed=14)
        seconds[f"train {label}"] = time.perf_counter() - t0
        steps_per_sec[label] = result.steps_per_sec
        print(f"[{label}] trained {result.state.step} steps in "
              f"{seconds[f'train {label}']:.1f}s ({result.steps_per_sec:.1f} steps/s in the "
              f"loop)", flush=True)
        return result.state.model.state_dict(), result.state.step

    arms = {}
    if args.gammas:
        # the sweep (the JAX script's VERDICT r4 item 5): the triplet arm
        # once, then one γ arm a (γ, margin set) cell
        gammas = [float(g) for g in args.gammas.split(",")]
        msets = [tuple(float(x) for x in m.split(":")) for m in args.margin_sets.split(",")]
        arms["triplet"], triplet_steps = train_arm(LossConfig(kind="triplet"), "triplet")
        results["triplet"] = evaluate(arms["triplet"], "triplet")
        for g in gammas:
            for (m_pn, m_pp, m_pn2) in msets:
                label = f"gamma={g} margins={m_pn}/{m_pp}/{m_pn2}"
                arms[label], _ = train_arm(LossConfig(
                    kind="gamma", gamma=g, margin_pos_neg=m_pn, margin_pos_part=m_pp,
                    margin_part_neg=m_pn2, use_fused_kernel=args.use_fused_layer), label)
                results[label] = evaluate(arms[label], label)
        return {"results": results, "steps_per_arm": triplet_steps, "seconds": seconds,
                "steps_per_sec": steps_per_sec, "config": dataclasses.asdict(cfg), "arms": arms}
    gamma = LossConfig(kind="gamma", margin_pos_part=0.5, margin_part_neg=0.5,
                       use_fused_kernel=args.use_fused_layer)
    arms["quadruplet"], gamma_steps = train_arm(gamma, "quadruplet")
    results["quadruplet"] = evaluate(arms["quadruplet"], "gamma-quadruplet")
    arms["triplet"], triplet_steps = train_arm(LossConfig(kind="triplet"), "triplet")
    results["triplet"] = evaluate(arms["triplet"], "triplet")
    return {"results": results,
            "steps_per_arm": {"quadruplet": gamma_steps, "triplet": triplet_steps},
            "seconds": seconds, "steps_per_sec": steps_per_sec,
            "config": dataclasses.asdict(cfg), "arms": arms}


def table_row(r: dict) -> dict:
    """One model's columns of the RESULTS.md table."""
    o = r["ordering"]
    return {"r10_pos_part": r["pos+part"]["recall@10"],
            "ndcg10_pos_part": r["pos+part"]["ndcg@10"],
            "r10_pos": r["pos_only"]["recall@10"], "r10_part": r["part_only"]["recall@10"],
            "acc_pos_part": o["acc_pos_part"], "acc_part_neg": o["acc_part_neg"],
            "acc_pos_neg": o["acc_pos_neg"], "global_accuracy": o["global_accuracy"]}


def markdown_table(results: dict, with_jax: bool = True, side: str = "port") -> str:
    """The RESULTS.md table for the baseline and both arms (labelled with
    ``side``), each with the JAX package's decisive row beside it."""
    cols = ("r10_pos_part", "ndcg10_pos_part", "r10_pos", "r10_part", "acc_pos_part",
            "acc_part_neg", "acc_pos_neg", "global_accuracy")
    rows = ["| model | R@10 (pos+part) | NDCG@10 (pos+part) | R@10 (pos) | R@10 (part) | "
            "acc(pos,part) | acc(part,neg) | acc(pos,neg) | global |",
            "|---|---|---|---|---|---|---|---|---|"]
    for label in ("baseline", "quadruplet", "triplet"):
        row = table_row(results[label])
        rows.append(f"| {label} ({side}) | " + " | ".join(str(row[c]) for c in cols) + " |")
        if with_jax:
            jax_row = JAX_DECISIVE[label]
            rows.append(f"| {label} (JAX, RESULTS.md) | "
                        + " | ".join(str(jax_row.get(c, "—")) for c in cols) + " |")
    return "\n".join(rows)


def quality_bars(results: dict, ordering_only: bool = False) -> List[str]:
    """The 2,000-step bars → the ones that do not hold: the quadruplet arm at
    or above the triplet arm on acc(pos,part), acc(part,neg) and global
    accuracy; and, unless ``ordering_only``, its acc(part,neg) ≥ 0.80,
    acc(pos,neg) ≥ 0.99 in both arms and its R@10 (pos+part) no more than
    0.02 below the triplet arm's."""
    q, t = table_row(results["quadruplet"]), table_row(results["triplet"])
    failed = [f"quadruplet {k} {q[k]} < triplet {t[k]}"
              for k in ("acc_pos_part", "acc_part_neg", "global_accuracy") if q[k] < t[k]]
    if not ordering_only:
        if q["acc_part_neg"] < 0.80:
            failed.append(f"quadruplet acc_part_neg {q['acc_part_neg']} < 0.80")
        failed += [f"{name} acc_pos_neg {r['acc_pos_neg']} < 0.99"
                   for name, r in (("quadruplet", q), ("triplet", t)) if r["acc_pos_neg"] < 0.99]
        if q["r10_pos_part"] < t["r10_pos_part"] - 0.02:
            failed.append(f"quadruplet R@10 (pos+part) {q['r10_pos_part']} more than 0.02 "
                          f"below triplet {t['r10_pos_part']}")
    return failed


SWEEP_COLUMNS = ("cell", "R@10 (part)", "acc(part,neg)", "NDCG@10 (pos+part)",
                 "R@10 (pos+part)", "acc(pos,part)", "global")


def sweep_table(results: dict) -> str:
    """The JAX script's sweep table: a row a model (baseline, triplet, each
    cell) — does graded ordering trade off against part-positive rank-band
    retention, and where?"""
    rows = ["| " + " | ".join(SWEEP_COLUMNS) + " |", "|" + "---|" * len(SWEEP_COLUMNS)]
    for label, r in results.items():
        o = r["ordering"]
        rows.append(f"| {label} | {r['part_only']['recall@10']} | {o.get('acc_part_neg')} | "
                    f"{r['pos+part']['ndcg@10']} | {r['pos+part']['recall@10']} | "
                    f"{o.get('acc_pos_part')} | {o.get('global_accuracy')} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="ablation_") as work:
        out = run(args, work)
    out.pop("arms")
    if args.gammas:
        print(json.dumps({"metric": "ablation_gamma_margin_sweep",
                          "steps_per_arm": out["steps_per_arm"], "results": out["results"]}))
        print(sweep_table(out["results"]))
        return 0
    print(json.dumps({"metric": "ablation_quadruplet_vs_triplet", **out}))
    print(markdown_table(out["results"]))
    failed = quality_bars(out["results"], ordering_only=args.steps < 2000)
    print("quality bars: " + ("all hold" if not failed else "; ".join(failed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
