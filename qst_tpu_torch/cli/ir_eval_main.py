"""``python -m qst_tpu_torch.cli.ir_eval_main`` — IR evaluation CLI,
counterpart of ``qst_tpu/cli/ir_eval_main.py``.

Build (or reload) the IR evaluation set from a chunked dataset (use_pos /
use_part_pos flags), run the full metric grid under multiple score functions,
and evaluate the BASELINE model and the TRAINED model back-to-back for A/B
comparison, over an exact, IVF, PQ or IVF-PQ index (``--eval_index``).
Results land in an output dir keyed by the sha256 of the config, as JSON +
the evaluator's CSV. Everything runs on the GPU unless ``--device`` names
another device:

  python -m qst_tpu_torch.cli.ir_eval_main --dataset_root data/test \\
      --model_path trained/exp1 --use_fused_layer [--eval_index ivf|pq|ivfpq]

The flags and defaults are the JAX CLI's. ``--hf_checkpoint_dir`` (a local
sentence-transformers directory, BERT or MPNet) gives the baseline encoder
and its config, ``--baseline_hf_checkpoint`` the baseline's weights file;
``--generate_query_variations`` replaces each query by one compressed
variation (``data/sentence_compression.py``), as the JAX CLI does.
``--use_cross_encoder`` labels the relevant docs with a cross-encoder's
scores at ``--cross_encoder_threshold``: the checkpoint of
``--cross_encoder_dir`` (an HF ``*ForSequenceClassification`` directory,
such as a clone of cross-encoder/stsb-roberta-large, with its own
tokenizer), or without one a random-init scorer of the encoder's
architecture and tokenizer. ``--mesh_data`` / ``--mesh_model`` lay a
``core/meshes.py`` mesh over the devices of ``--device`` (every card by
default; ``$QST_TORCH_VIRTUAL_DEVICES=n`` repeats them n long, as the tests
and one card do) of every process — ``$QST_COORDINATOR_ADDRESS`` (with
``$QST_NUM_PROCESSES`` and ``$QST_PROCESS_ID``) starts a group of processes,
each running its positions: the encoder runs data-parallel and the index
is sharded over it, every process gets every answer, and process 0 writes
the output directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

import numpy as np

from qst_tpu_torch.cli.common import (
    add_bool_flag,
    add_device_flag,
    add_hf_checkpoint_dir_flag,
    dump_args,
    encoder_from_args,
    load_best_params,
    primary_first,
    resolve_hf_checkpoint_dir,
    tokenizer_from_args,
)
from qst_tpu_torch.core.config import (
    CROSS_ENCODER_RELEVANCE_THRESHOLD,
    IREvalConfig,
    N_IR_SAMPLES,
    config_hash,
)

logger = logging.getLogger("qst_tpu_torch.cli.ir_eval")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--model_path",
                   help="experiment dir with a trained best checkpoint")
    p.add_argument("--output_root", default="ir_eval_results")
    p.add_argument("--encoder_preset", default="minilm-l6")
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--baseline_hf_checkpoint", default=None,
                   help="local HF state dict for the baseline encoder")
    add_hf_checkpoint_dir_flag(p)
    p.add_argument("--n_queries", type=int, default=N_IR_SAMPLES)
    p.add_argument("--cross_encoder_threshold", type=float,
                   default=CROSS_ENCODER_RELEVANCE_THRESHOLD)
    p.add_argument("--score_functions", nargs="+",
                   default=["cos_sim", "dot_score", "euclid_score"])
    p.add_argument("--accuracy_at_k", nargs="+", type=int,
                   default=[1, 3, 5, 10])
    p.add_argument("--precision_recall_at_k", nargs="+", type=int,
                   default=[1, 3, 5, 10, 20, 30, 40, 50, 100])
    p.add_argument("--mrr_at_k", nargs="+", type=int,
                   default=[10, 20, 30, 40, 50, 100, 200, 500, 900])
    p.add_argument("--ndcg_at_k", nargs="+", type=int,
                   default=[10, 20, 30, 40, 50, 100, 200, 500, 900])
    p.add_argument("--map_at_k", nargs="+", type=int,
                   default=[100, 200, 500, 900])
    add_bool_flag(p, "use_pos_examples", True)
    add_bool_flag(p, "use_part_pos_examples", True)
    add_bool_flag(p, "use_cross_encoder", False)
    p.add_argument("--eval_index", default="exact",
                   choices=["exact", "ivf", "pq", "ivfpq"],
                   help="index family the evaluator searches with — ivf / "
                   "pq / ivfpq measure the approximate index's recall cost "
                   "directly on the full IR metric grid (cos/dot score "
                   "functions only; pq and ivfpq keep refine rows and "
                   "re-rank exactly)")
    p.add_argument("--eval_ivf_clusters", type=int, default=256)
    p.add_argument("--eval_ivf_probe", type=int, default=8)
    p.add_argument("--eval_pq_m", type=int, default=48)
    p.add_argument("--cross_encoder_dir", default=None,
                   help="local HF *ForSequenceClassification checkpoint "
                   "dir (e.g. a clone of cross-encoder/stsb-roberta-large) "
                   "for REAL relevance labels; default: random-init scorer "
                   "of the encoder architecture (structural path)")
    add_bool_flag(p, "generate_query_variations", False,
                  "paraphrase queries with the augmentation stack")
    add_bool_flag(p, "use_test_set", False,
                  "hold out a test split of instances for the eval set")
    add_bool_flag(p, "use_fused_layer", False,
                  "encode through the fused per-layer kernel (K1)")
    p.add_argument("--test_fraction", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=14)
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    add_device_flag(p)
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    import torch

    from qst_tpu_torch.core.meshes import (
        global_devices,
        initialize_distributed,
        is_primary,
        make_mesh,
    )
    from qst_tpu_torch.data.chunks import ChunkStore
    from qst_tpu_torch.evals.eval_set import create_ir_evaluation_set
    from qst_tpu_torch.evals.ir_evaluator import InformationRetrievalEvaluator
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params

    if initialize_distributed(device=args.device):
        import torch.distributed as dist

        logger.info("multi-process runtime: process %d/%d, %d global devices",
                    dist.get_rank(), dist.get_world_size(),
                    len(global_devices(args.device)[0]))
    devices, ranks = global_devices(args.device)
    mesh = make_mesh(args.mesh_data, args.mesh_model, devices=devices, ranks=ranks)
    device = mesh.home

    if args.eval_index != "exact":
        kept = [s for s in args.score_functions
                if s in ("cos_sim", "dot_score")]
        if kept != list(args.score_functions):
            logger.info("--eval_index %s supports cos/dot only; dropping "
                        "%s", args.eval_index,
                        sorted(set(args.score_functions) - set(kept)))
        args.score_functions = kept or ["cos_sim"]

    ir_cfg = IREvalConfig(
        n_queries=args.n_queries,
        accuracy_at_k=tuple(args.accuracy_at_k),
        precision_recall_at_k=tuple(args.precision_recall_at_k),
        mrr_at_k=tuple(args.mrr_at_k),
        ndcg_at_k=tuple(args.ndcg_at_k),
        map_at_k=tuple(args.map_at_k),
        score_functions=tuple(args.score_functions),
        use_pos_examples=args.use_pos_examples,
        use_part_pos_examples=args.use_part_pos_examples,
        use_cross_encoder=args.use_cross_encoder,
        cross_encoder_threshold=args.cross_encoder_threshold,
        seed=args.seed)

    # output dir keyed by config hash (reference :61-63)
    out_dir = os.path.join(args.output_root, config_hash(ir_cfg)[:16])
    os.makedirs(out_dir, exist_ok=True)
    primary = is_primary()  # the one writer of a group of processes
    if primary:
        dump_args(args, out_dir)

    hf_ckpt = resolve_hf_checkpoint_dir(args)
    hf_baseline_params = None
    if hf_ckpt is not None:
        encoder_cfg, hf_baseline_params, tokenizer = hf_ckpt
        logger.info("baseline from HF checkpoint dir %s (arch=%s)",
                    args.hf_checkpoint_dir, encoder_cfg.arch)
        if args.use_fused_layer:
            encoder_cfg = dataclasses.replace(encoder_cfg, use_fused_layer=True)
    else:
        encoder_cfg = encoder_from_args(
            args.encoder_preset, use_fused_layer=args.use_fused_layer)
        tokenizer = tokenizer_from_args(args.vocab_path, encoder_cfg.vocab_size)

    instances = list(ChunkStore(args.dataset_root).iter_instances())
    if args.use_test_set:  # held-out split (reference :48-58)
        rng = np.random.default_rng(args.seed)
        order = rng.permutation(len(instances))
        n_test = max(1, int(len(instances) * args.test_fraction))
        instances = [instances[int(i)] for i in order[:n_test]]

    cross_encoder_predict = None
    if args.use_cross_encoder:
        from qst_tpu_torch.models.cross_encoder import CrossEncoder, init_cross_encoder

        if args.cross_encoder_dir:
            # weights-present path: the reference's stsb-roberta-large
            # labeler, or any bert/roberta num_labels=1 classification
            # checkpoint
            from qst_tpu_torch.models.hf_import import load_cross_encoder_dir
            from qst_tpu_torch.models.tokenizer import load_tokenizer

            ce_cfg, ce_params, ce_vocab = load_cross_encoder_dir(args.cross_encoder_dir)
            ce_tok = load_tokenizer(ce_vocab or "", vocab_size=ce_cfg.vocab_size)
            ce = CrossEncoder(ce_cfg, ce_params, ce_tok, device=device)
        else:
            ce = CrossEncoder(
                encoder_cfg,
                init_cross_encoder(encoder_cfg, torch.Generator().manual_seed(1), device=device),
                tokenizer, device=device)
        cross_encoder_predict = ce.predict

    query_variation_fn = None
    if args.generate_query_variations:
        from qst_tpu_torch.data.sentence_compression import generate_variations

        query_variation_fn = lambda text: generate_variations(  # noqa: E731
            text, n=1, seed=args.seed)[0]

    eval_set = primary_first(lambda: create_ir_evaluation_set(
        instances, n_queries=args.n_queries,
        use_pos_examples=args.use_pos_examples,
        use_part_pos_examples=args.use_part_pos_examples,
        cross_encoder_predict=cross_encoder_predict,
        cross_encoder_threshold=args.cross_encoder_threshold,
        query_variation_fn=query_variation_fn,
        seed=args.seed,
        cache_path=os.path.join(out_dir, "ir_eval_set.json")))

    index_factory = None
    if args.eval_index == "ivf":
        from qst_tpu_torch.retrieval import IVFIndex

        index_factory = lambda emb, ids, m: IVFIndex(  # noqa: E731
            emb, n_clusters=args.eval_ivf_clusters, ids=ids,
            mesh=m, default_n_probe=args.eval_ivf_probe)
    elif args.eval_index == "pq":
        from qst_tpu_torch.retrieval import PQIndex

        index_factory = lambda emb, ids, m: PQIndex(  # noqa: E731
            emb, m=args.eval_pq_m, ids=ids, mesh=m, keep_rows=True)
    elif args.eval_index == "ivfpq":
        from qst_tpu_torch.retrieval import IVFPQIndex

        index_factory = lambda emb, ids, m: IVFPQIndex(  # noqa: E731
            emb, n_clusters=args.eval_ivf_clusters, m=args.eval_pq_m, ids=ids,
            mesh=m, default_n_probe=args.eval_ivf_probe, keep_rows=True)
    # the encoder's embeddings stay on `device`, and the index with them
    evaluator = InformationRetrievalEvaluator(
        eval_set.queries, eval_set.corpus, eval_set.relevant, cfg=ir_cfg,
        mesh=mesh, log_dir=out_dir if primary else None, index_factory=index_factory)

    def encode_with(params):
        return SentenceEncoder(encoder_cfg, params, tokenizer, device=device,
                               mesh=mesh).encode

    # baseline model (random-init, the checkpoint directory's or a weights file's)
    if hf_baseline_params is not None:
        baseline_params = hf_baseline_params
    else:
        baseline_params = init_params(encoder_cfg, torch.Generator().manual_seed(args.seed),
                                      device=device)
    if args.baseline_hf_checkpoint:
        from qst_tpu_torch.models.hf_import import load_torch_state_dict

        baseline_params = load_torch_state_dict(args.baseline_hf_checkpoint)
    baseline_params = {k: v.to(device) for k, v in baseline_params.items()}

    results = {}
    logger.info("evaluating baseline model")
    baseline_score = evaluator(encode_with(baseline_params))
    results["baseline"] = {"main_score": baseline_score,
                           "metrics": evaluator.last_results}
    if args.model_path:
        logger.info("evaluating trained model from %s", args.model_path)
        trained_params = load_best_params(args.model_path)
        trained_score = evaluator(encode_with(trained_params))
        results["trained"] = {"main_score": trained_score,
                              "metrics": evaluator.last_results}
        logger.info("A/B main score: baseline=%.6f trained=%.6f",
                    baseline_score, trained_score)

    if primary:
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
    logger.info("results written to %s", out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
