"""``python -m qst_tpu_torch.cli.train_main`` — quadruplet fine-tuning CLI,
counterpart of ``qst_tpu/cli/train_main.py``.

Loads a chunked quadruplet dataset, mines negatives for it with the frozen
initial encoder (``data/mining.py``: random or hard-contrastive), splits
train/val, builds the sequential evaluator stack (IR / quadruplet-accuracy /
validation loss, loss last = main score), creates the experiment dir with a
config/provenance dump including ``manual_notes``, and trains with warmup
scheduling, grad clipping, bf16 compute, periodic + best checkpoints and
patience-based early stopping. Everything runs on the GPU unless
``--device`` names another device:

  python -m qst_tpu_torch.cli.train_main --dataset_root data/train \\
      --experiment_dir trained/exp1 --use_fused_layer --use_fused_loss_kernel \\
      --hard_contrastive_mode 1 --use_ir_evaluator

The flags and defaults are the JAX CLI's; ``--steps_per_call K`` runs K
steps per call, one CUDA graph replay on the GPU. ``--hf_checkpoint_dir``
starts from a local sentence-transformers directory (BERT or MPNet, at its
own ``max_seq_length`` up to 512), ``--hf_checkpoint`` from a weights file.
The mesh is built as the JAX CLI builds it: ``--mesh_data`` × ``--mesh_model``
over the visible device positions (``--mesh_data -1``: all of them; one card
is one position unless ``$QST_TORCH_VIRTUAL_DEVICES`` names more) of every
process — ``$QST_COORDINATOR_ADDRESS`` with ``$QST_NUM_PROCESSES`` and
``$QST_PROCESS_ID`` starts a group (``core/meshes.py:initialize_distributed``)
whose processes train one model together, data-parallel, each on its
positions; process 0 writes the experiment directory — or with
``--pp_stages`` > 1 a ("pipe", "data") mesh for the pipelined trunk
(``--pp_microbatches``, ``--pp_rounds``), which excludes ``--mesh_model``
and ``--use_fused_layer``.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    primary_first,
    resolve_hf_checkpoint_dir,
    tokenizer_from_args,
)
from qst_tpu_torch.core.config import (
    DEFAULT_GAMMA,
    IREvalConfig,
    LossConfig,
    TrainConfig,
)

logger = logging.getLogger("qst_tpu_torch.cli.train")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # data
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--val_fraction", type=float, default=0.1)
    p.add_argument("--max_val_samples", type=int, default=1000)
    p.add_argument("--n_pos", type=int, default=1)
    p.add_argument("--n_part_pos", type=int, default=1)
    p.add_argument("--n_neg", type=int, default=1)
    p.add_argument("--hard_contrastive_mode", type=int, default=-1,
                   choices=[-1, 0, 1])
    p.add_argument("--cache_size", type=int, default=30)
    # model
    p.add_argument("--encoder_preset", default="minilm-l6")
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--max_seq_length", type=int, default=None)
    p.add_argument("--hf_checkpoint", default=None,
                   help="local pytorch_model.bin/safetensors to import")
    add_hf_checkpoint_dir_flag(p)
    # loss (reference defaults training/main.py:211-218)
    p.add_argument("--loss_kind", default="gamma",
                   choices=["gamma", "d_regularized", "triplet"])
    p.add_argument("--gamma", type=float, default=DEFAULT_GAMMA)
    p.add_argument("--margin_pos_neg", type=float, default=1.0)
    p.add_argument("--margin_pos_part", type=float, default=0.5)
    p.add_argument("--margin_part_neg", type=float, default=0.5)
    p.add_argument("--p_norm", type=float, default=2.0)
    p.add_argument("--lmbd", type=float, default=0.1)
    add_bool_flag(p, "swap", False, "use distance swap in the margin losses")
    add_bool_flag(p, "use_fused_loss_kernel", False,
                  "route the gamma loss through the fused quadruplet kernel "
                  "(K3; p=2, no swap)")
    # training (reference defaults training/main.py:221-239)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--scheduler", default="warmuplinear",
                   choices=["constantlr", "warmupconstant", "warmuplinear",
                            "warmupcosine", "warmupcosinewithhardrestarts"])
    p.add_argument("--warmup_steps", type=int, default=10_000)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--evaluation_steps", type=int, default=500)
    p.add_argument("--checkpoint_save_steps", type=int, default=500)
    p.add_argument("--checkpoint_save_total_limit", type=int, default=2)
    p.add_argument("--early_stopping_patience", type=int, default=5)
    p.add_argument("--early_stopping_delta", type=float, default=0.0)
    add_bool_flag(p, "save_best_model", True)
    add_bool_flag(p, "use_amp", True, "bf16 compute")
    add_bool_flag(p, "use_fused_layer", False,
                  "train through the fused layer kernels (K1 forward with "
                  "in-kernel dropout at the configured rates, K2 backward)")
    add_bool_flag(p, "use_ir_evaluator", False)
    add_bool_flag(p, "resume", False, "resume from the latest checkpoint")
    p.add_argument("--seed", type=int, default=14)
    p.add_argument("--experiment_dir", required=True)
    p.add_argument("--manual_notes", default="")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="train steps per call: K > 1 replays K captured steps as one "
                   "CUDA graph")
    # parallelism
    p.add_argument("--pp_stages", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=0)
    p.add_argument("--pp_rounds", type=int, default=1)
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="-1 = all devices on the data axis")
    p.add_argument("--mesh_model", type=int, default=1)
    add_device_flag(p)
    return p


def build_trainer(args: argparse.Namespace):
    """Everything ``main`` sets up before training → the ``Trainer``; its
    dataset carries the miner (``trainer.dataset.miner``), its evaluator the
    evaluators (``trainer.evaluator.evaluators``)."""
    import torch

    from qst_tpu_torch.core.device import resolve_device
    from qst_tpu_torch.core.rng import seed_everything
    from qst_tpu_torch.data.collate import QuadrupletCollator
    from qst_tpu_torch.data.mining import EmbeddingTable, NegativeMiner
    from qst_tpu_torch.data.quadruplet_dataset import QuadrupletDataset
    from qst_tpu_torch.evals.eval_set import create_ir_evaluation_set
    from qst_tpu_torch.evals.factory import get_sequential_evaluator
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params
    from qst_tpu_torch.train.trainer import Trainer

    from qst_tpu_torch.core.meshes import global_devices, is_primary, make_mesh, make_pipe_mesh

    device = resolve_device(args.device)
    seed_everything(args.seed)
    hf_ckpt = resolve_hf_checkpoint_dir(
        args, max_seq_length=args.max_seq_length,
        dtype=None if args.use_amp else "float32")
    if hf_ckpt is not None:
        encoder_cfg, hf_params, tokenizer = hf_ckpt
        logger.info("loaded HF checkpoint dir %s (arch=%s, max_seq_length=%d)",
                    args.hf_checkpoint_dir, encoder_cfg.arch, encoder_cfg.max_seq_length)
    else:
        hf_params = None
        encoder_cfg = encoder_from_args(
            args.encoder_preset, max_seq_length=args.max_seq_length,
            dtype=None if args.use_amp else "float32")
        tokenizer = tokenizer_from_args(args.vocab_path, encoder_cfg.vocab_size)
    if args.use_fused_layer:
        encoder_cfg = dataclasses.replace(encoder_cfg, use_fused_layer=True)
        logger.info("training through the fused layer kernels "
                    "(in-kernel dropout at the configured rates)")

    loss_cfg = LossConfig(
        kind=args.loss_kind, gamma=args.gamma,
        margin_pos_neg=args.margin_pos_neg,
        margin_pos_part=args.margin_pos_part,
        margin_part_neg=args.margin_part_neg,
        p=args.p_norm, swap=args.swap, lmbd=args.lmbd,
        use_fused_kernel=args.use_fused_loss_kernel)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        scheduler=args.scheduler, warmup_steps=args.warmup_steps,
        max_grad_norm=args.max_grad_norm,
        evaluation_steps=args.evaluation_steps,
        checkpoint_save_steps=args.checkpoint_save_steps,
        checkpoint_save_total_limit=args.checkpoint_save_total_limit,
        save_best_model=args.save_best_model, use_amp=args.use_amp,
        early_stopping_patience=args.early_stopping_patience,
        early_stopping_delta=args.early_stopping_delta,
        early_stopping_mode="max", seed=args.seed,
        experiment_dir=args.experiment_dir, manual_notes=args.manual_notes)
    primary = is_primary()  # the one writer of a group of processes
    if primary:
        dump_args(args, args.experiment_dir, manual_notes=args.manual_notes)

    devices, ranks = global_devices(device)
    if args.pp_stages > 1:
        if args.mesh_model > 1:
            raise SystemExit("--pp_stages and --mesh_model are exclusive "
                             "(PP composes with data parallelism only)")
        if args.use_fused_layer:
            raise SystemExit(
                "--pp_stages and --use_fused_layer are exclusive: the "
                "pipelined trunk runs the nn.Module layer path (stage chunks "
                "a tick), not the fused per-layer kernels")
        pp_data = (args.mesh_data if args.mesh_data > 0
                   else max(1, len(devices) // args.pp_stages))
        mesh = make_pipe_mesh(args.pp_stages, pp_data, devices=devices, ranks=ranks)
        logger.info("pipeline training: %d stages x %d data shards, "
                    "%d microbatches, %d rounds", args.pp_stages, pp_data,
                    args.pp_microbatches or args.pp_stages, args.pp_rounds)
    else:
        mesh = make_mesh(args.mesh_data, args.mesh_model, devices=devices, ranks=ranks)

    # initial weights: the checkpoint directory's, a weights file's, or random
    if hf_params is not None:
        init = {k: v.to(device) for k, v in hf_params.items()}
    else:
        init = init_params(encoder_cfg, torch.Generator().manual_seed(args.seed), device=device)
    if args.hf_checkpoint:
        from qst_tpu_torch.models.hf_import import load_torch_state_dict

        init = {k: v.to(device) for k, v in load_torch_state_dict(args.hf_checkpoint).items()}
        logger.info("imported HF checkpoint %s", args.hf_checkpoint)

    # mining: the frozen initial encoder over the caption pool, its
    # embeddings on the device
    mining_encoder = SentenceEncoder(encoder_cfg, init, tokenizer)
    encode_fn = mining_encoder.encode
    base_ds = QuadrupletDataset(
        args.dataset_root, n_pos=args.n_pos, n_part_pos=args.n_part_pos,
        n_neg=args.n_neg, cache_size=args.cache_size, seed=args.seed)
    pool = base_ds.store.all_positive_captions()
    miner = NegativeMiner(
        EmbeddingTable(pool, encode_fn),
        encode_fn, mode=args.hard_contrastive_mode, seed=args.seed)
    base_ds.miner = miner

    # train/val split over instance indices
    n = len(base_ds)
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(n)
    n_val = min(max(1, int(n * args.val_fraction)), args.max_val_samples)
    val_idx = [int(i) for i in order[:n_val]]
    val_instances = base_ds[val_idx[: min(n_val, 256)]]
    val_batches = [base_ds[val_idx[s:s + args.batch_size]]
                   for s in range(0, min(n_val, 256), args.batch_size)]

    ir_eval_set = None
    if args.use_ir_evaluator:
        ir_eval_set = primary_first(lambda: create_ir_evaluation_set(
            list(base_ds.store.iter_instances()),
            seed=args.seed,
            cache_path=os.path.join(args.experiment_dir, "ir_eval_set.json")))

    collator = QuadrupletCollator(tokenizer,
                                  max_length=encoder_cfg.max_seq_length,
                                  seed=args.seed)
    evaluator = get_sequential_evaluator(
        encoder_cfg, loss_cfg, tokenizer, val_instances,
        val_batches=val_batches, ir_eval_set=ir_eval_set,
        ir_cfg=IREvalConfig() if ir_eval_set else None,
        log_dir=args.experiment_dir if primary else None, mesh=None)

    # train FROM the resolved weights (copied: the miner keeps the frozen ones)
    return Trainer(encoder_cfg, loss_cfg, train_cfg, base_ds, collator,
                   evaluator=evaluator, mesh=mesh, steps_per_call=args.steps_per_call,
                   initial_params=init, pp_stages=args.pp_stages,
                   pp_microbatches=args.pp_microbatches, pp_rounds=args.pp_rounds,
                   device=device)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from qst_tpu_torch.core.meshes import global_devices, initialize_distributed

    # multi-process hook first (gated on $QST_COORDINATOR_ADDRESS; nothing
    # in the default single-process mode): the mesh spans every process
    if initialize_distributed(device=args.device):
        import torch.distributed as dist

        logger.info("multi-process runtime: process %d/%d, %d global devices",
                    dist.get_rank(), dist.get_world_size(),
                    len(global_devices(args.device)[0]))
    trainer = build_trainer(args)
    result = trainer.train(seed=args.seed, resume=args.resume)
    logger.info(
        "done: best=%.6f (epoch %d), %d evals, %.2f steps/s, early_stop=%s",
        result.best_score, result.best_epoch, len(result.history),
        result.steps_per_sec, result.stopped_early)
    return 0


if __name__ == "__main__":
    sys.exit(main())
