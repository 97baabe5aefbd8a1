"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU (serving to datasets).

    python3 chip_smoke.py                          # every phase, one GPU
    python3 chip_smoke.py --phases build,check     # a new kernel's first, short call
    python3 chip_smoke.py --phases build,check,train
    python3 chip_smoke.py --phases build,check,ivf
    python3 chip_smoke.py --phases build,pq
    python3 chip_smoke.py --phases build,flash     # the long-document path alone
    python3 chip_smoke.py --phases build,roberta   # RoBERTa, the cross-encoder, the MLM head
    python3 chip_smoke.py --phases build,marian    # Marian and the on-card backtranslator
    python3 chip_smoke.py --phases build,mesh      # the sharded serving path
    python3 chip_smoke.py --phases build,train_mesh   # training on meshes
    python3 chip_smoke.py --phases build,dist      # meshes across two processes
    python3 chip_smoke.py --phases build,check,train,evaluate
    python3 chip_smoke.py --phases build,dataset,capture,ablation
    python3 chip_smoke.py --phases build,ablation --ablation_steps 2000   # the decisive run

Phases (any failure exits non-zero and prints no result):

1. build  — compile qst_tpu_torch/kernels/csrc/*.cu with nvcc (sm_90a), one
   nvcc per source, all at once.
2. check  — each kernel against its plain PyTorch version on the card at the
   main paths' shapes: K1 (fused BERT layer, MiniLM width, f32 and bf16),
   K4 (bucket maxima, f32/bf16/int8, N = 65,536 + 77, with and without
   n_real), K5 (winning-bucket rescore, pairs grouped by bucket and each
   pair its own block), topk_v2 against reference_topk, then both kernels'
   edges (Q = 3,000, 300 and 8, D = 64 and 768, a ragged last bucket, all
   scores negative, shared and out-of-range bucket ids);
   the dropout masks bit for bit, K1 with dropout, K2 (the layer's
   backward, with and without dropout) at B = 128, S = 128, K3 (the fused
   quadruplet loss, forward and backward: the three reductions, a scalar and
   a per-example upstream gradient, one and many blocks, two calls bit for
   bit, forwards overlapping on two streams), and K6 (the IVF probed-cell scorer, f32 and
   bf16, D = 384, C = 1024, L = 1152 / 1160 / 2048, P = 8, Q = 1 / 11 / 256
   / 1100, pairs grouped by cell and a pair a block, with and without fill
   counts, empty and full cells, repeats and ids outside [0, C)), then
   IVFIndex.search through K6 against the probe scan, before and after
   compact(), which must leave one copy of the cells on the card;
   the bf16 GEMM behind K1 and K2 alone in its four operand layouts (ragged
   M, every N the layer uses, split-K), K1 and K2 at sequence lengths that
   are no multiple of 16 and at head widths 32 and 64, at head width 16
   (EncoderConfig.tiny()'s shapes, f32 and bf16), and K2's 16 gradients
   bit-equal between two calls.
3. serve  — random-init MiniLM-L6 with use_fused_layer, a bfloat16 Retriever
   over 65,536 synthetic docs (so "auto" search takes K4 + K5), a
   RetrievalServer on port 0 answering concurrent POST /search, POST /encode
   and GET /healthz; answers held against the plain path; every kernel's
   launch count must rise.
4. train  — Trainer.train on a synthetic quadruplet dataset at the training
   configuration (MiniLM-L6, batch 32 quadruplets, S = 128, bf16, dropout
   0.1, fused γ loss, AdamW): finite losses, 6 K1 and 6 K2 launches and one
   K3 forward and backward per step; the first step's gradients at dropout
   0 against the plain versions; one step at EncoderConfig.tiny() (head
   width 16) through the kernels against the plain versions; a falling loss
   on a repeated batch.
5. ivf    — qst_tpu_torch.cli.index_main as a user calls it: ``build
   --index_dtype ivf --use_fused_layer`` over 65,536 synthetic docs, the
   ``serve`` command's retriever and server on port 0 answering concurrent
   POST /search (held against the index's probe scan and, at full probe,
   against an exact index), one POST /docs + DELETE /docs round on a
   ``serve --updatable`` server, and ``query``; K1's and K6's launch counts
   must rise, and the only library GEMM in a request is the centroid product.
6. times  — kernel against plain at the main paths' shapes, each with the
   least time the card could take (bytes over memory rate or operations over
   peak rate); encode sentences/s at B=256, S=128; a 32,768-text encode to
   numpy at dispatch_depth 1 and 4; search QPS over 1M x 384
   bf16 at Q=4096 and Q=256, with K4 on int8, the product alone through
   torch.matmul as K4's yardstick, and K5's two forms around the pair count
   where the wrapper changes over; train steps/s of the kernel path against
   the nn.Module path;
   K6 (with and without fill counts, each beside its bound) and whole IVF
   searches at Q = 8 /
   64 / 256 over a 1M x 384 bf16 clustered index beside the exact K4 + K5
   search, with recall@10; K6's two forms around the pair count where the
   wrapper changes over; the searches again over 4M rows; K1's and
   K2's device time by piece (GEMMs, attention, LayerNorm).
7. profile — where the time goes: device time per kernel and the device's
   busy share for encode, a train step and search (no library GEMM or
   attention kernel may run on the fused encode and train paths or in
   topk_v2; K3's two kernels must follow each other in the step's
   timeline), the launches of one IVF search, and served
   req/s with p50/p99 latency at 1, 8 and 64 closed-loop clients.
8. evaluate — training with validation and negative mining, and IR
   evaluation, from the command line: a synthetic quadruplet dataset of
   11,200 instances (66,200 IR docs) and its first 960; train_main on the
   960 (MiniLM-L6, batch 32, fused layer and loss, hard-contrastive mode 1,
   then random mode -1; IR + quadruplet + loss evaluation every 15 steps):
   the evaluations at epoch -1 and each evaluation step, finite losses, and
   K1 / K2 / K3 launches exactly the steps', the miner's and the
   evaluators'; the evaluators on the trained model against their plain
   versions (IR metrics and accuracies within 0.005, the loss within 2e-2
   relative) and the logged validation loss recomputed; ir_eval_main over
   the 11,200 (cos and dot, k up to 128) for baseline and trained through
   the exact index (one K4 and one K5 a dot search), for the baseline
   through the IVF index (K6), and the trained model's evaluation through
   the plain versions; the trained experiment reloaded from its config
   (load_config of its experiment_config.json equal to the configs
   train_main built, the default MeshConfig's shape through make_mesh, the
   best weights' SentenceEncoder encoding the 66,200 docs and 1,000 queries
   through K1 and searching them through K4 + K5: top-10 equal to
   ir_eval_main's trained run up to ties, launches by wrapper and by name);
   one evaluation timed by part; the miner's table refresh, steps/s with
   and without the miner, the device's busy share.
9. dataset — qst_tpu_torch.cli.dataset_main as a user calls it: 2,000
   synthetic images (10,000 captions, the ablation's recipe), positives
   mined by MiniLM-L6 on the card, adaptive-crop partial positives, chunks
   of 500, the verbose check; the four chunks and the metadata read back;
   wall time, images/s, encode calls and the encoder's share.
10. capture — the captured train step on those chunks at the training
   configuration: four steps a call as one CUDA graph (the first call runs
   eagerly and captures) against eager steps from the same state, bit for
   bit in losses, parameters and Adam moments, at dropout 0.1, at dropout 0
   and with accumulation 2, with K1 / K2 / K3 launches exact across
   replays; train_main at --steps_per_call 1 and 4, with and without the
   miner (steps/s, equal final weights, busy share).
11. ablation — the port's quadruplet-vs-triplet ablation at the JAX run's
   decisive configuration (WordPiece, MiniLM-L6 through the fused layer,
   hard mining), four steps a call, 500 steps an arm (the JAX script's
   default: the ordering bars) or, with --ablation_steps 2000 (its own call:
   --phases build,ablation), the decisive run and all its quality bars; the
   RESULTS.md table beside the JAX rows. Then the γ × margin sweep
   (--gammas 0.3,0.6) at 64 steps an arm beside the default mode at the
   same arguments: its γ = 0.6 / 1.0:0.5:0.5 cell is the default mode's
   quadruplet arm and its triplet arm the default mode's, bit for bit.

12. mpnet — MPNet-base and sequences past 128: K1 with rel_bias and K2 with
   drel at MPNet-base width, S = 128, 200, 384 and 512, f32 and bf16,
   dropout 0 and 0.1, against their plain versions, K2 bit-equal between
   two calls; BERT K1/K2 at MiniLM-L6 width at S = 256; the kernels each
   path launches, by name (BERT at S <= 128: the kernels of earlier
   slices). Two random-init checkpoint directories written by the port's
   exporter (MPNet-base with model.safetensors and max_seq_length 384,
   MiniLM-L6 with pytorch_model.bin and 256), loaded and encoded in the
   256 and 384 buckets, fused against nn.Module (cosine >= 0.999); on the
   MPNet-base directory one train step's launches, the first step's
   gradients against the plain versions, four captured steps a call
   against eager steps, train_main --hf_checkpoint_dir (12 steps at
   S = 384) and ir_eval_main --hf_checkpoint_dir over the evaluate phase's
   11,200 instances (one K4 and one K5); K1/K2 times at MPNet-base S = 128
   and 384 and MiniLM-L6 S = 128 and 256 beside their bounds, encode
   sentences/s and the MPNet-base train step with its busy share (no
   library GEMM or attention kernel in a profiled encode or train step).

13. flash — the long-document path (use_flash_attention): ptxas's
   registers and spills for K7/K8's bf16 kernels; K7 and K8 against their
   plain versions at hd 16 / 32 / 64, S 128 / 256 / 512 / 2,048, f32 and
   bf16, with a padded and an all-padding sequence and (S = 256) seg_q !=
   seg_kv rows that match no key, K8 bit-equal between calls; MiniLM-L6 at
   full width and max_seq_length 512
   behind load_tokenizer's native WordPiece tokenizer (the phase fails
   without it): 65,536 documents of 300-450 words through Retriever.build
   (6 K7 launches an encode batch) and 256 queries through Retriever.search
   (K4 + K5) against the plain scan, the embeddings against the einsum
   path's (cosine >= 0.999), no library attention kernel and no GEMM for
   attention in a profiled encode batch; Trainer.train for 10 steps of 8
   quadruplets at S = 512 (attention dropout 0; K7 and K8 six times a
   step, their CUDA kernels by name in a profiled step), the first step's
   gradients against the plain versions, a falling loss, two captured calls
   of 2 steps against 4 eager ones; times of K7 and K8 (padded and all-real
   rows), their plain versions and scaled_dot_product_attention with the
   same mask (forward; backward alone) beside the bounds, encode
   sentences/s at S = 256 and 512 flash
   against einsum, tokenization docs/s native against Python, and one IR
   evaluation by part with each tokenizer.

14. roberta — RoBERTa, byte-level BPE, the cross-encoder and the MLM head:
   a random RoBERTa-large cross-encoder (the reference labeler's width, H
   1,024, 24 layers, 16 heads of 64) written from a seed as an HF
   RobertaForSequenceClassification directory with a BPE vocabulary learned
   from seeded text, loaded through load_cross_encoder_dir and
   load_tokenizer; K7 at its (128, 16, 128, 64) view (sequence stride
   1,024) against its plain version first, f32 and bf16; CrossEncoder.predict
   at batch 128, S = 128 over 1,024 pairs of 300-450 characters, einsum
   bf16, flash bf16 (24 K7 a batch) and f32 (bf16 within 1e-2 of f32, on the
   same side of 0.4 away from near ties; f32 within 1e-4 of the CPU on 8
   pairs), pairs/s; K7's time there beside plain, SDPA and its bound; a
   Retriever (MiniLM-L6, bf16 index, dot_score: K4 + K5) over 65,536 docs
   with the cross-encoder as reranker, 32 queries at k = 10, rerank_k = 100,
   answers equal to predict over the first stage's candidates, ms a query;
   ir_eval_main --use_cross_encoder --cross_encoder_dir labeling 16 queries
   x 256 docs (relevant sets equal to the thresholded scores), its wall
   time; an all-distilroberta-v1-width directory (H 768, 6 layers) loaded
   through load_hf_checkpoint_dir, bf16 encode held to f32, two flash
   Trainer steps at S = 256 (K7 and K8 6 a step), the first step's
   gradients against the einsum path; MLMAugmenter (substitute and insert)
   at MiniLM-L6 width over 1,024 captions, texts/s, its mask-slot logits
   held to f32.

15. marian — Marian seq2seq and the on-card backtranslator at opus-mt width
   (d_model 512, 6 + 6 layers, 8 heads, FFN 2,048, vocab 58,101; no kernel
   of the port runs on this path): en->fr and fr->en directories written
   from two seeds with the published generation settings (4 beams,
   max_length 512, PAD as a bad word, forced EOS), read back through
   load_marian_dir bit for bit; 64 caption pairs of 8-24 words through a
   hashing word-level tokenizer, encode + full-prefix decode logits on the
   card against the CPU and decode_token against the full decode (1e-4 of
   the largest magnitude); greedy and 4-beam decode at max_length 128,
   cached against uncached on 8 rows, and the card's beams on 8 rows
   scored on the CPU against the CPU's own beam search (near ties counted);
   get_backtranslator(backend="jax") over 128 captions at batch 32:
   translations/s a hop and round trip, ms a decode step, busy share and
   launches a step; dataset_main with adaptive_crop_augment over 8 images,
   every part-positive a Marian roundtrip on the card.

16. train_mesh — training on meshes of positions of one card (bf16 MiniLM-L6
   at full width, batch 32 quadruplets, S = 128): a data-parallel step on a
   4 x 1 mesh and a data- and tensor-parallel one on 4 x 2 through the fused
   path (6 K1 and 6 K2 a data shard, K3 once on the gathered embeddings, by
   wrapper count and the attention kernels by name) against the unsharded
   step (loss, first-step gradients: cosine >= 0.999, each tensor within
   5e-2), two calls at dropout 0.1 bit-equal and the shards' layer seeds
   distinct, a 1 x 1 mesh the unsharded step bit for bit; tensor parallelism
   on the nn.Module path in f32 on 1 x 2 and 4 x 2 (parameters after a step
   within 1e-4); make_multi_step(K = 4) on 4 x 1 (fused, dropout 0.1) and on
   the nn.Module path with dropout 0.1 and no mesh, two calls against eight
   eager steps bit for bit; the pipeline (2 x 2 GPipe and 3 stages x 2
   rounds circular, M = 4; nn.Module layers, K3) in f32 against the
   unpipelined step (1e-4) and bit-equal at dropout 0.1; train_main
   --mesh_data 4 --mesh_model 2 --use_fused_layer and --pp_stages 2 under
   $QST_TORCH_VIRTUAL_DEVICES=8, each best artifact encoding; each form's ms
   a step beside its unsharded self, launches and busy share.

17. dist  — meshes across processes on one card: two processes of the port
   (this script with --dist_child) in a gloo group over cuda:0, four
   positions each (NCCL refuses two ranks on one card). DP 4 x 1 and DP +
   TP 4 x 2 training at the training configuration, two steps at dropout
   0.1: losses equal on both ranks, parameters and moments bit-equal
   between the ranks and to one process's mesh of the same shape, 12 K1 +
   12 K2 and K3 1 + 1 a step in each process, by the wrappers' counts and
   by kernel name in a profile in each child; bench.py's exact search (1M
   x 384 bf16, k = 10, Q = 256) and IVF (1,024 cells of 2,048, n_probe 8)
   over 4 x 2: both ranks' answers one process's bit for bit and the
   unsharded search's up to ties, 4 K4 + 4 K5 and 4 K6 in each process,
   counted both ways; ms a step and a search beside one process's mesh,
   and, in a pass of their own under a clock that syncs around each
   gather, the gathers' share (the structure's cost on one card, not
   scaling). Then the layouts whose hand-offs cross the processes, each
   two steps at MiniLM-L6 (batch 32 quadruplets, S = 128, bf16): (d) GPipe
   2 x 1, one stage a process, M = 4, nn.Module layers at dropout 0.1 (K9,
   K3); (e) circular 3 x 1 over ranks [0, 0, 1], v = 2, M = 4,
   use_flash_attention, hidden dropout 0.1 (K7, K8, K9, K3); (f) the fused
   step with a mesh row split across the processes, TP 1 x 2 over [0, 1]
   and DP + TP 2 x 2 over [0, 1, 1, 1] (K1 / K2 on the row's gathered
   slices, K3); (g) context and ring attention at (4, 12, 4,096, 32) over
   [0, 1], forward and q / k / v gradients. Each: losses (outputs) equal on
   both ranks, parameters and moments gathered bit-equal between the ranks
   and to one process's mesh of the same shape, each child's launches by
   wrapper and by kernel name those of the stages or rows it runs, ms
   beside one process's mesh. A child that fails or runs past 180 s fails
   the phase.

18. mesh  — the sharded serving path on a 4 x 2 mesh of eight positions of
   one card (core/meshes.py): ExactIndex over 1M x 384 bf16 and int8 at Q =
   4,096 through K4 + K5 in every shard (8 launches each a search, 8 of each
   by name in a profile) against the unsharded search, a 129-row index with
   six empty shards against the plain scan; IVF over 1,024 bf16 cells of
   2,048 x 384 with K6 in every shard at Q = 256 / 64 / 8, before and after
   compact(); PQ, IVF-PQ (8 and 4 bits) and the streamed index over 1M
   clustered rows against their unsharded selves; the data-parallel
   MiniLM-L6 encode (4 data shards, 24 K1 a batch of 256); a sharded
   Retriever built, saved and reloaded; ir_eval_main --mesh_data 4
   --mesh_model 2 against the run without; context-parallel and ring
   attention at (8, 12, 4,096, 32) f32 with a backward; each sharded time
   beside its unsharded one (the shard structure's cost on one card).

19. pq    — the compressed and streamed indexes, last (run before the
   profiled phases, it made their torch.profiler traces lose kernels,
   although it tears down what it opened: kineto drops the records it
   timestamps before a window's start, and late in a run a window's first
   records, or all of them, come back timestamped early; a probe of ten K4
   launches before pq and after each part counts the records beside
   kineto's own accounting, with its buffer limit raised and behind
   lead_in):
   index_main build |
   serve | query for --index_dtype pq (m 48, refine rows), ivfpq at 8 and 4 bits
   and streaming over the ivf phase's 65,536 docs, 256 queries a batch (pq
   and streaming through K4 + K5, launches exactly one of each a search a
   slice or tile), each saved index reloaded and queried in a fresh
   process; then over 4,194,304 clustered rows of D = 384 made on the card
   (ivfpq_bench.py's generator): PQIndex's kernels' path (two 2M-row
   slices through topk_local) against its plain scan at Q = 256 and 4,096,
   IVFPQIndex (4,096 cells, int8 refine rows) at 8 and 4 bits with recall@10
   raw and refined x8 against a bf16 ExactIndex, ms and QPS at n_probe 8 /
   16 / 32, the full probe against the exact top-10 over the
   reconstructions; StreamingExactIndex over a 2,618,440-row f32 memmap at
   tile_rows 2^21 and 2^19 (bf16 cast on the host, pre-quantized int8, and
   at 2^19 int8 per tile) against its plain path and the top-k over the rows it
   sends held on the card at once, with GB/s beside a pinned copy;
   K4 and K5 over a decoded 2M-row slice beside their bounds.

The last lines are the card's name and power limit (nvidia-smi), one JSON
object with a row per kernel, and {"ok": true, "device": {...}}.

Imports torch, numpy, the standard library and qst_tpu_torch only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

PHASES = ("build", "check", "serve", "ivf", "train", "times", "profile", "evaluate", "dataset",
          "capture", "ablation", "mpnet", "flash", "roberta", "marian", "train_mesh", "dist",
          "mesh", "pq")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def ids_match_up_to_ties(s_a, i_a, s_b, i_b, true_scores, tol: float) -> bool:
    """Two top-k answers agree when their sorted scores agree within tol,
    every returned id's true score matches its returned score within tol,
    and ids above the k-th score (plus tol) appear in both."""
    s_a, i_a, s_b, i_b = (np.asarray(x) for x in (s_a, i_a, s_b, i_b))
    if not np.allclose(s_a, s_b, atol=tol, rtol=0):
        return False
    for row in range(s_a.shape[0]):
        for s, i in ((s_a, i_a), (s_b, i_b)):
            if not np.allclose(true_scores[row, i[row]], s[row], atol=tol, rtol=0):
                return False
        kth = min(s_a[row, -1], s_b[row, -1])
        sure_a = {int(j) for j, v in zip(i_a[row], s_a[row]) if v > kth + tol}
        sure_b = {int(j) for j, v in zip(i_b[row], s_b[row]) if v > kth + tol}
        if not sure_a <= set(map(int, i_b[row])) or not sure_b <= set(map(int, i_a[row])):
            return False
    return True


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clocks_under(fn, launches: int) -> dict:
    """The card's SM clock and power draw (nvidia-smi, sampled every 50 ms)
    while ``fn`` is launched ``launches`` times back to back."""
    import torch

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True)
            if r.returncode == 0:
                samples.append([float(x) for x in r.stdout.strip().splitlines()[0].split(",")])
            time.sleep(0.05)

    torch.cuda.synchronize()
    thread = threading.Thread(target=sample)
    thread.start()
    time.sleep(1.0)                           # the card at rest first
    n_idle = len(samples)
    ms = cuda_ms(fn, launches, warmup=0)
    stop.set()
    thread.join()
    idle, busy = samples[:n_idle] or [[None, None]], samples[n_idle:] or [[None, None]]
    return {"ms": ms, "rest_sm_mhz": idle[-1][0], "rest_watts": idle[-1][1],
            "min_sm_mhz": min(b[0] for b in busy), "max_watts": max(b[1] for b in busy)}


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): the yardstick
# of every kernel's bound, whatever power limit the card runs at.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, dtype: str) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move over the memory rate and its operations over the
    peak rate of their type."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def bf16_ulp(t):
    """The spacing of bfloat16 numbers (8 significant bits) at |t|."""
    import torch

    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)


def random_layer(H, F, dtype, gen, device):
    import torch

    def mat(r, c):
        return (torch.randn((r, c), generator=gen) * 0.05).to(device, dtype).contiguous()

    def vec(n, base=0.0):
        return (base + torch.randn((1, n), generator=gen) * 0.05).to(device).contiguous()

    return dict(wq=mat(H, H), bq=vec(H), wk=mat(H, H), bk=vec(H), wv=mat(H, H),
                bv=vec(H), wo=mat(H, H), bo=vec(H), ln1_g=vec(H, 1.0), ln1_b=vec(H),
                w1=mat(H, F), b1=vec(F), w2=mat(F, H), b2=vec(H), ln2_g=vec(H, 1.0),
                ln2_b=vec(H))


def check_topk_shape(name: str, base, qbase, k: int, n_real, negative: bool):
    """K4, K5 (pairs grouped by bucket, and each pair its own block) and
    topk_v2 against their plain versions for one dtype on unit-norm rows
    ``base`` (N, D) and ``qbase`` (Q, D) → (K4's, K5's max|err|)."""
    import torch

    from qst_tpu_torch.ops import topk

    dev = torch.device("cuda")
    (N, D), Q = base.shape, qbase.shape[0]
    if name == "int8":
        corpus = torch.round(base * 127).to(torch.int8).to(dev)
        queries = torch.round(qbase * 127).to(torch.int8).to(dev)
        tol = 0.0
    else:
        dt = getattr(torch, name)
        corpus, queries = base.to(dev, dt), qbase.to(dev, dt)
        tol = 1e-4
    what = f"{name:8s} N={N} D={D} Q={Q}" + (" all scores < 0" if negative else "")
    k4_err = 0.0
    for nr in dict.fromkeys((None, n_real)):
        bm = topk.bucket_maxima(queries, corpus, nr)
        torch.cuda.synchronize()
        bm_ref = topk.bucket_maxima_plain(queries, corpus, nr)
        fin = torch.isfinite(bm_ref)
        if not torch.equal(torch.isfinite(bm), fin):
            fail(f"K4 {what} n_real={nr}: -inf pattern differs")
        err = (bm[fin] - bm_ref[fin]).abs().max().item()
        log(f"K4 {what} n_real={nr}: max|err| {err:.3e} (limit {tol:.0e})")
        if not err <= tol:
            fail(f"K4 {what}: max|err| {err} > {tol}")
        k4_err = max(k4_err, err)
    # the winners of the last maxima; half the queries on one bucket, one id
    # past the end and one negative: both must read -inf
    ids = topk._hierarchical_top_buckets(bm_ref, k)
    ids[: Q // 2, 0] = ids[0, 0]
    ids[:, -1] = bm_ref.shape[1] + 3
    ids[0, -1] = -2
    rs_ref = topk.rescore_buckets_plain(queries, corpus, ids, k)
    fin = torch.isfinite(rs_ref)
    k5_err = 0.0
    group_from = topk._GROUP_MIN_PAIRS
    try:
        for form, min_pairs in (("grouped", 0), ("a block a pair", Q * k + 1)):
            topk._GROUP_MIN_PAIRS = min_pairs
            rs = topk.rescore_buckets(queries, corpus, ids, k)
            torch.cuda.synchronize()
            if not torch.equal(torch.isfinite(rs), fin):
                fail(f"K5 {what} {form}: -inf pattern differs")
            err = (rs[fin] - rs_ref[fin]).abs().max().item()
            log(f"K5 {what} k={k} {form}: max|err| {err:.3e} (limit {tol:.0e})")
            if not err <= tol:
                fail(f"K5 {what} {form}: max|err| {err} > {tol}")
            k5_err = max(k5_err, err)
    finally:
        topk._GROUP_MIN_PAIRS = group_from
    s, i = topk.topk_v2(queries, corpus, k)
    gs, gi = topk.reference_topk(queries, corpus, k)
    true = (queries.float() @ corpus.float().T).cpu().numpy()
    if not ids_match_up_to_ties(s.cpu(), i.cpu(), gs.cpu(), gi.cpu(), true, max(tol, 1e-6)):
        fail(f"topk_v2 {what}: answers differ from reference_topk")
    log(f"topk_v2 {what}: matches reference_topk (ids up to ties)")
    return k4_err, k5_err


def check_kernels(report: dict) -> None:
    import torch

    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import topk

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(14)
    H, F, NH = 384, 1536, 12

    # K1 — tolerances: f32 1e-4 absolute (only the f32 summation order
    # differs). bf16, where a different summation order flips a rounding at
    # a bf16 cast point: max|err| <= 2e-2 of max|ref|; every element within
    # 2 (ulp(ref) + 2^-7), two bf16 ulps with a floor of one ulp at 1 for
    # outputs near 0; and mean|err| <= 2^-10 of mean|ref|. The mean bound is
    # the one a subtle fault breaks: dropping any one bf16 rounding point
    # raises it about tenfold over what the summation order alone gives
    k1_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        w = random_layer(H, F, dtype, gen, dev)
        for S in (32, 128):
            B = 32
            x = torch.randn((B, S, H), generator=gen).to(dev, dtype)
            lens = torch.randint(1, S + 1, (B,), generator=gen)
            mask = (torch.arange(S)[None, :] < lens[:, None])
            mask[-1] = False   # one fully padded row
            bias = torch.where(mask, 0.0, fl.MASK_BIAS).float().to(dev)
            out = fl.fused_bert_layer(x, bias, w, num_heads=NH).float()
            ref = fl.fused_bert_layer_plain(x, bias, w, num_heads=NH).float()
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"K1 {dtype} S={S}: non-finite output (padded row?)")
            diff = (out - ref).abs()
            err = diff.max().item()
            what = f"K1 {str(dtype)[6:]:8s} B={B} S={S:3d}"
            if dtype == torch.float32:
                log(f"{what}: max|err| {err:.3e} (limit 1e-4)")
                if not err <= 1e-4:
                    fail(f"{what}: max|err| {err} > 1e-4")
                continue
            lim = 2e-2 * ref.abs().max().item()
            ulps = (diff / (bf16_ulp(ref) + 2.0 ** -7)).max().item()
            mean_rel = (diff.mean() / ref.abs().mean()).item()
            log(f"{what}: max|err| {err:.3e} (limit {lim:.3e}); worst element "
                f"{ulps:.2f} x (ulp + 2^-7) (limit 2); mean|err|/mean|ref| "
                f"{mean_rel:.3e} (limit {2.0 ** -10:.3e})")
            if not (err <= lim and ulps <= 2.0 and mean_rel <= 2.0 ** -10):
                fail(f"{what}: outside the bf16 limits")
            k1_err = max(k1_err, err)
    report["K1"] = {"max_abs_err": k1_err}

    # K4 / K5 / topk_v2 — tolerances: f32 and bf16 1e-4 absolute on unit-norm
    # vectors (exact products, f32 sums in another order); int8 exactly equal.
    # First the serving shape, then the edges of the tensor-core K4 and the
    # grouped K5: Q = 3,000 (24 query tiles, which K4 walks in two passes of 12
    # and K5 groups by bucket without being told), D = 64 and 768 beside 384,
    # Q = 8 and Q no multiple of 128, a ragged last bucket, n_real inside a
    # bucket, and the small ones once more with every score negative, where a
    # zero-filled row would win a maximum
    k4_err = k5_err = 0.0
    for N, D, Q, k, n_real in ((65536 + 77, 384, 256, 10, 65536 + 77 - 300),
                               (65536 + 77, 384, 3000, 10, 65536 + 77 - 300),
                               (128 * 300 + 5, 64, 300, 10, 128 * 300 - 195),
                               (128 * 8 + 13, 768, 200, 5, 987),
                               (128 * 40 + 1, 384, 8, 10, None)):
        for negative in (False, True):
            if negative and N > 65536:
                continue
            base = torch.nn.functional.normalize(torch.randn((N, D), generator=gen), dim=1)
            qbase = torch.nn.functional.normalize(torch.randn((Q, D), generator=gen), dim=1)
            if negative:
                base, qbase = base.abs(), -qbase.abs()
            for name in ("float32", "bfloat16", "int8"):
                e4, e5 = check_topk_shape(name, base, qbase, k, n_real, negative)
                if name == "bfloat16":
                    k4_err, k5_err = max(k4_err, e4), max(k5_err, e5)
    report["K4"] = {"max_abs_err": k4_err}
    report["K5"] = {"max_abs_err": k5_err}
    check_training_kernels(report)
    check_layer_edges(report)
    check_module_keep(report)
    check_ivf(report)


def bf16_limits(what: str, out, ref) -> float:
    """K1's bf16 limits (see check_kernels): max|err| <= 2e-2 max|ref|, every
    element within 2 (ulp(ref) + 2^-7), mean|err| <= 2^-10 mean|ref|."""
    diff = (out - ref).abs()
    err = diff.max().item()
    lim = 2e-2 * ref.abs().max().item()
    ulps = (diff / (bf16_ulp(ref) + 2.0 ** -7)).max().item()
    mean_rel = (diff.mean() / ref.abs().mean()).item()
    log(f"{what}: max|err| {err:.3e} (limit {lim:.3e}); worst element {ulps:.2f} x "
        f"(ulp + 2^-7) (limit 2); mean|err|/mean|ref| {mean_rel:.3e} (limit {2.0 ** -10:.3e})")
    if not (err <= lim and ulps <= 2.0 and mean_rel <= 2.0 ** -10):
        fail(f"{what}: outside the bf16 limits")
    return err


def grad_errors(out: dict, ref: dict):
    """(worst (max|err|/max|ref|, name), worst (mean|err|/mean|ref|, name),
    worst max|err|) over the tensors. bk's gradient is zero up to rounding
    (softmax ignores a constant added to a row of scores, so each row of dS
    sums to 0 before its bf16 cast): it is noise, and is held to the scale
    of bq's gradient instead of its own."""
    worst_max, worst_mean, worst_abs = (0.0, ""), (0.0, ""), 0.0
    for n, r in ref.items():
        d = (out[n].float() - r.float()).abs()
        scale = (ref["bq"] if n == "bk" else r).float().abs()
        worst_abs = max(worst_abs, d.max().item())
        worst_max = max(worst_max, (d.max().item() / scale.max().item(), n))
        worst_mean = max(worst_mean, (d.mean().item() / scale.mean().item(), n))
    return worst_max, worst_mean, worst_abs


# the nn.Module train step's dropout sites at MiniLM-L6 width (batch 32
# quadruplets, S = 128): the attention probabilities, a model shard's heads
# of them (TP over 2), the hidden states, and a ragged size
KEEP_SHAPES = (((128, 12, 128, 128), None), ((128, 6, 128, 128), (6, 12)),
               ((128, 128, 384), None), ((3, 5, 7), None))


def check_module_keep(report: dict) -> None:
    """K9, the nn.Module path's dropout keep-mask (one launch a mask):
    bit for bit its plain version (the same hash in PyTorch integer ops) at
    the train step's shapes, under a key and a folded key; ms against the
    plain version and against the torch.rand draw it replaced, at the
    attention probabilities' (128, 12, 128, 128)."""
    import torch

    from qst_tpu_torch.ops import fused_layer as fl

    dev = torch.device("cuda")
    key = torch.tensor([14, 3], dtype=torch.int64, device=dev)
    err = 0.0
    for shape, heads in KEEP_SHAPES:
        for k in (key, fl.fold_key(key, 2)):
            got = fl.module_keep_mask(k, 3, 1, shape, 0.1, dev, heads)
            want = fl.module_keep_mask_plain(k, 3, 1, shape, 0.1, dev, heads)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != torch.bool:
                fail(f"K9 {shape}: {got.dtype} {tuple(got.shape)}, want bool {shape}")
            err = max(err, (got.float() - want.float()).abs().max().item())
    kept = fl.module_keep_mask(key, 3, 1, KEEP_SHAPES[0][0], 0.1, dev).float().mean().item()
    log(f"K9 module_keep_mask at {[s for s, _ in KEEP_SHAPES]} (heads (6, 12) on the second): "
        f"max|err| {err} against the plain version (limit 0: the same bits); kept share "
        f"{kept:.5f} at rate 0.1")
    if err != 0.0 or abs(kept - 0.9) > 1e-3:
        fail("K9: the keep-mask differs from its plain version")
    shape = KEEP_SHAPES[0][0]
    n = shape[0] * shape[1] * shape[2] * shape[3]
    ms = cuda_ms(lambda: fl.module_keep_mask(key, 3, 1, shape, 0.1, dev), 20, warmup=2)
    plain_ms = cuda_ms(lambda: fl.module_keep_mask_plain(key, 3, 1, shape, 0.1, dev), 5)
    rand_ms = cuda_ms(lambda: torch.rand(shape, device=dev) < 0.9, 20, warmup=2)
    # one bool written an element and the key read; 11 integer operations an
    # element (the hash, its mask and the compare), counted at the table's
    # float32 rate outside the tensor cores (the table has no int32 rate)
    b = bound(n + 16, 11.0 * n, "float32")
    report["K9"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms, torch_rand_ms=rand_ms,
                        shape=list(shape), **b)
    log(f"K9 at {shape}: {ms:.4f} ms (bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
        f"{b['bound_ms'] / ms:.0%}); plain {plain_ms:.3f} ms; torch.rand < 0.9 {rand_ms:.4f} ms")


def add_keep_launches(report: dict, n: int) -> None:
    report["K9"]["launches"] = report["K9"].get("launches", 0) + n


def check_training_kernels(report: dict) -> None:
    """K1 with dropout, K2 and K3 against their plain versions, and the
    dropout masks bit for bit, at the training path's shapes: B = 4 x 32
    quadruplet rows, S = 128, MiniLM widths."""
    import torch

    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import quadruplet as qd

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(15)
    H, F, NH, B, S, NB = 384, 1536, 12, 128, 128, 8

    # the dropout masks: the kernels' device function against the plain hash
    for seed, rate, tag, shape in ((0, 0.1, 0, (1024, 384)), (123456789, 0.1, 1, (1024, 384)),
                                   (fl.step_seed(2**31 - 2, 7), 0.1, 16 + 95, (128, 128)),
                                   (-5, 0.5, 40, (37, 129))):
        got = fl.drop_mask(shape, seed, rate, tag, device=dev).cpu()
        want = fl.drop_mask_plain(shape, seed, rate, tag)
        if not torch.equal(got, want):
            fail(f"drop_mask seed={seed} rate={rate} tag={tag}: "
                 f"{int((got != want).sum())} bits differ from drop_mask_plain")
    log("drop_mask: the kernels' masks equal drop_mask_plain bit for bit (4 cases)")

    # K1 with dropout; K2 with and without. K1: its own limits. K2, per
    # gradient tensor (grad_errors): f32 max|err| <= 1e-4 max|ref| and
    # mean|err| <= 2e-5 mean|ref| (f32 summation order; 3.6e-6 and 1.6e-6
    # measured), the check that holds the algorithm. bf16 max 2e-2, mean
    # 2^-7: summation order alone gives a mean of 2.4e-3 on the CPU (f64
    # against f32 sums, B=16) and 2.9e-3 on the card, as much as dropping
    # one bf16 rounding point would (1.7e-3 to 4.8e-3), so the bf16 bound
    # shows that the bf16 kernels run right, not where they round
    k1_err = k2_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        w = random_layer(H, F, dtype, gen, dev)
        x = torch.randn((B, S, H), generator=gen).to(dev, dtype)
        lens = torch.randint(1, S + 1, (B,), generator=gen)
        mask = torch.arange(S)[None, :] < lens[:, None]
        mask[-1] = False
        bias = torch.where(mask, 0.0, fl.MASK_BIAS).float().to(dev)
        g = torch.randn((B, S, H), generator=gen).to(dev, dtype)
        name = str(dtype)[6:]
        for rate in (0.0, 0.1):
            kw = dict(num_heads=NH, attn_dropout=rate, hidden_dropout=rate,
                      seed=torch.tensor([987654321], dtype=torch.int32, device=dev) if rate else None,
                      nb=NB)
            if rate:
                out = fl.fused_bert_layer(x, bias, w, **kw).float()
                ref = fl.fused_bert_layer_plain(x, bias, w, **kw).float()
                if not torch.isfinite(out).all():
                    fail(f"K1 dropout {name}: non-finite output")
                what = f"K1 dropout 0.1 {name:8s} B={B} S={S}"
                if dtype == torch.float32:
                    err = (out - ref).abs().max().item()
                    log(f"{what}: max|err| {err:.3e} (limit 1e-4)")
                    if not err <= 1e-4:
                        fail(f"{what}: max|err| {err} > 1e-4")
                else:
                    k1_err = max(k1_err, bf16_limits(what, out, ref))
            dx, dw = fl.fused_bert_layer_bwd(x, bias, w, g, **kw)
            rdx, rdw = fl.fused_bert_layer_bwd_plain(x, bias, w, g, **kw)
            torch.cuda.synchronize()
            grads, refs = dict(dw, dx=dx), dict(rdw, dx=rdx)
            if not all(torch.isfinite(t).all() for t in grads.values()):
                fail(f"K2 {name} dropout {rate}: non-finite gradients")
            (mx, mx_n), (mean, mean_n), ab = grad_errors(grads, refs)
            lim_max, lim_mean = (1e-4, 2e-5) if dtype == torch.float32 else (2e-2, 2.0 ** -7)
            log(f"K2 {name:8s} dropout {rate} B={B} S={S}, over dx and 16 weight gradients: "
                f"worst max|err|/max|ref| {mx:.3e} ({mx_n}; limit {lim_max:.0e}), worst "
                f"mean|err|/mean|ref| {mean:.3e} ({mean_n}; limit {lim_mean:.2e})")
            if not (mx <= lim_max and mean <= lim_mean):
                fail(f"K2 {name} dropout {rate}: outside the limits")
            if dtype == torch.bfloat16:
                k2_err = max(k2_err, ab)
    report["K1"]["dropout_max_abs_err"] = k1_err
    report["K2"] = {"max_abs_err": k2_err}

    # K3 forward and backward, f32, 1e-5 absolute (summation order only): the
    # three reductions the forward kernel writes itself, the backward from a
    # per-example and from a scalar upstream gradient (not 1), two calls bit
    # for bit, and forwards that overlap on two streams
    Bq, D = 32, 384
    emb = [torch.nn.functional.normalize(torch.randn((Bq, D), generator=gen), dim=1).to(dev)
           for _ in range(4)]
    consts = dict(gamma=0.6, m_pn=1.0, m_pt=0.5, m_tn=0.5)
    err = 0.0
    for B3 in (Bq, 1000):     # one block, and 32 blocks with the last one adding up
        x3 = [e[:B3] if B3 <= Bq else torch.nn.functional.normalize(
            torch.randn((B3, D), generator=gen), dim=1).to(dev) for e in emb]
        for reduction in ("none", "sum", "mean"):
            up = (torch.rand((B3,), generator=gen) if reduction == "none"
                  else torch.tensor(0.37)).to(dev)
            runs = []
            for _ in range(2):
                loss, dists = qd.fused_gamma_quadruplet_loss_fwd(*x3, reduction=reduction,
                                                                 **consts)
                grads = qd.fused_gamma_quadruplet_loss_bwd(*x3, dists, up, reduction=reduction,
                                                           **consts)
                runs.append([loss.clone(), dists.clone(), *[g.clone() for g in grads]])
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                fail(f"K3 B={B3} {reduction}: two calls differ")
            rloss, rdists = qd.fused_gamma_quadruplet_loss_plain(*x3, reduction=reduction,
                                                                 **consts)
            rgrads = qd.fused_gamma_quadruplet_loss_bwd_plain(*x3, rdists, up,
                                                              reduction=reduction, **consts)
            # a sum of B losses is held relative to its size
            scale = max(1.0, rloss.abs().max().item())
            err = max(err, (loss - rloss).abs().max().item() / scale,
                      (dists - rdists).abs().max().item(),
                      *[(a - b).abs().max().item() for a, b in zip(grads, rgrads)])
    # launches on two streams share nothing: each mean is the one its inputs
    # give alone
    big = [torch.nn.functional.normalize(torch.randn((1000, D), generator=gen), dim=1).to(dev)
           for _ in range(4)]
    for xs in (emb, big):
        other = [x.flip(0).contiguous() for x in xs]
        alone = [qd.fused_gamma_quadruplet_loss_fwd(*v, reduction="mean", **consts)[0].clone()
                 for v in (xs, other)]
        torch.cuda.synchronize()
        streams, got = [torch.cuda.Stream(), torch.cuda.Stream()], [[], []]
        for _ in range(100):
            for i, v in enumerate((xs, other)):
                with torch.cuda.stream(streams[i]):
                    got[i].append(qd.fused_gamma_quadruplet_loss_fwd(*v, reduction="mean",
                                                                     **consts)[0])
        torch.cuda.synchronize()
        if not all(torch.equal(g, alone[i]) for i in (0, 1) for g in got[i]):
            fail(f"K3 B={xs[0].shape[0]}: a mean taken while another stream's forward ran "
                 f"differs from the one taken alone")
    log(f"K3 f32 B={Bq} and 1000, D={D}, reductions none / sum / mean: max|err| over loss, "
        f"distances and 4 gradients {err:.3e} (limit 1e-5), two calls bit-equal, means on two "
        f"streams equal to those taken alone")
    if not err <= 1e-5:
        fail(f"K3: max|err| {err} > 1e-5")
    report["K3"] = {"max_abs_err": err}


def masked_batch(B, S, H, dtype, gen, dev):
    """x (B, S, H), the mask bias of random lengths with the last sequence
    fully padded, and an upstream gradient, from ``gen``."""
    import torch

    from qst_tpu_torch.ops import fused_layer as fl

    x = torch.randn((B, S, H), generator=gen).to(dev, dtype)
    lens = torch.randint(1, S + 1, (B,), generator=gen)
    mask = torch.arange(S)[None, :] < lens[:, None]
    mask[-1] = False
    bias = torch.where(mask, 0.0, fl.MASK_BIAS).float().to(dev)
    g = torch.randn((B, S, H), generator=gen).to(dev, dtype)
    return x, bias, g


def check_layer_edges(report: dict) -> None:
    """The bf16 GEMM behind K1 and K2 alone, then the two kernels at the
    edges of their tensor-core attention, then K2's determinism."""
    import torch

    from qst_tpu_torch.ops import fused_layer as fl

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(18)

    def rnd(*shape):
        return (torch.randn(shape, generator=gen) * 0.5).to(dev, torch.bfloat16)

    # each operand layout against the plain product: bf16 products are exact
    # in f32, so only the order of the f32 sums differs — 2e-5 of max|ref|
    # (7e-6 measured at K = 5,000); a wrong shared-memory descriptor or
    # swizzle gives errors of the size of the result. Ragged M, every N the
    # layer uses, K = H, F and a token count cut by split-K
    worst = 0.0
    shapes = [(1000, n, 384) for n in (128, 256, 384, 1152, 1536)] + [
        (520, 384, 1536), (384, 1536, 5000)]
    for M, N, K in shapes:
        for ta in (False, True):
            for tb in (False, True):
                a = rnd(K, M) if ta else rnd(M, K)
                b = rnd(N, K) if tb else rnd(K, N)
                ref = fl.layer_gemm_plain(a, b, trans_a=ta, trans_b=tb)
                for splits in (1, 3):
                    out = fl.layer_gemm(a, b, trans_a=ta, trans_b=tb, splits=splits)
                    torch.cuda.synchronize()
                    rel = ((out - ref).abs().max() / ref.abs().max()).item()
                    worst = max(worst, rel)
                    if not rel <= 2e-5:
                        fail(f"layer_gemm M={M} N={N} K={K} trans_a={ta} trans_b={tb} "
                             f"splits={splits}: max|err|/max|ref| {rel} > 2e-5")
    log(f"layer_gemm bf16, 4 operand layouts x {len(shapes)} shapes x splits 1 and 3: worst "
        f"max|err|/max|ref| {worst:.3e} (limit 2e-5)")
    report["K1"]["gemm_max_rel_err"] = worst

    # K1 and K2 where the attention pads: S no multiple of 16, head widths 32
    # and 64, a fully padded sequence, dropout on; K1's and K2's own limits
    for B, S, H, F, NH in ((5, 24, 128, 256, 4), (3, 40, 128, 256, 2), (9, 77, 384, 1536, 12),
                           (4, 128, 768, 3072, 12)):
        w = random_layer(H, F, torch.bfloat16, gen, dev)
        x, bias, g = masked_batch(B, S, H, torch.bfloat16, gen, dev)
        kw = dict(num_heads=NH, attn_dropout=0.1, hidden_dropout=0.1, nb=8,
                  seed=torch.tensor([24681357], dtype=torch.int32, device=dev))
        what = f"B={B} S={S} H={H} F={F} head width {H // NH} dropout 0.1"
        out = fl.fused_bert_layer(x, bias, w, **kw).float()
        if not torch.isfinite(out).all():
            fail(f"K1 bf16 {what}: non-finite output")
        bf16_limits(f"K1 bf16 {what}", out, fl.fused_bert_layer_plain(x, bias, w, **kw).float())
        dx, dw = fl.fused_bert_layer_bwd(x, bias, w, g, **kw)
        rdx, rdw = fl.fused_bert_layer_bwd_plain(x, bias, w, g, **kw)
        torch.cuda.synchronize()
        (mx, mx_n), (mean, mean_n), _ = grad_errors(dict(dw, dx=dx), dict(rdw, dx=rdx))
        log(f"K2 bf16 {what}: worst max|err|/max|ref| {mx:.3e} ({mx_n}; limit 2e-2), worst "
            f"mean|err|/mean|ref| {mean:.3e} ({mean_n}; limit {2.0 ** -7:.2e})")
        if not (mx <= 2e-2 and mean <= 2.0 ** -7):
            fail(f"K2 bf16 {what}: outside the limits")

    # head width 16: EncoderConfig.tiny()'s shapes (H = 64, 4 heads, F = 128,
    # S = 32), f32 and bf16, with and without dropout; K1's and K2's limits
    for dtype in (torch.float32, torch.bfloat16):
        B, S, H, F, NH = 6, 32, 64, 128, 4
        w = random_layer(H, F, dtype, gen, dev)
        x, bias, g = masked_batch(B, S, H, dtype, gen, dev)
        name = str(dtype)[6:]
        for rate in (0.0, 0.1):
            kw = dict(num_heads=NH, attn_dropout=rate, hidden_dropout=rate, nb=8,
                      seed=torch.tensor([13579], dtype=torch.int32, device=dev) if rate else None)
            what = f"B={B} S={S} H={H} F={F} head width 16 dropout {rate}"
            out = fl.fused_bert_layer(x, bias, w, **kw).float()
            ref = fl.fused_bert_layer_plain(x, bias, w, **kw).float()
            if not torch.isfinite(out).all():
                fail(f"K1 {name} {what}: non-finite output")
            if dtype == torch.float32:
                err = (out - ref).abs().max().item()
                log(f"K1 {name} {what}: max|err| {err:.3e} (limit 1e-4)")
                if not err <= 1e-4:
                    fail(f"K1 {name} {what}: max|err| {err} > 1e-4")
            else:
                bf16_limits(f"K1 {name} {what}", out, ref)
            dx, dw = fl.fused_bert_layer_bwd(x, bias, w, g, **kw)
            rdx, rdw = fl.fused_bert_layer_bwd_plain(x, bias, w, g, **kw)
            torch.cuda.synchronize()
            (mx, mx_n), (mean, mean_n), _ = grad_errors(dict(dw, dx=dx), dict(rdw, dx=rdx))
            lim_max, lim_mean = (1e-4, 2e-5) if dtype == torch.float32 else (2e-2, 2.0 ** -7)
            log(f"K2 {name} {what}: worst max|err|/max|ref| {mx:.3e} ({mx_n}; limit "
                f"{lim_max:.0e}), worst mean|err|/mean|ref| {mean:.3e} ({mean_n}; limit "
                f"{lim_mean:.2e})")
            if not (mx <= lim_max and mean <= lim_mean):
                fail(f"K2 {name} {what}: outside the limits")

    # no atomics: two calls give the same bits (training shape, dropout 0.1)
    B, S, H, F, NH = 128, 128, 384, 1536, 12
    w = random_layer(H, F, torch.bfloat16, gen, dev)
    x, bias, g = masked_batch(B, S, H, torch.bfloat16, gen, dev)
    kw = dict(num_heads=NH, attn_dropout=0.1, hidden_dropout=0.1, nb=8,
              seed=torch.tensor([5], dtype=torch.int32, device=dev))
    runs = []
    for _ in range(2):
        dx, dw = fl.fused_bert_layer_bwd(x, bias, w, g, **kw)
        torch.cuda.synchronize()
        runs.append(dict(dw, dx=dx))
    differ = [n for n in runs[0] if not torch.equal(runs[0][n], runs[1][n])]
    if differ:
        fail(f"K2 is not deterministic: {differ} differ between two calls")
    log(f"K2 bf16 B={B} S={S}: dx and the 16 weight gradients are bit-equal between two calls")


def rows_match_up_to_ties(a, b, true_scores, tol: float) -> bool:
    """ids_match_up_to_ties for IVF answers (scores (Q, k), positions (Q, k)
    with -1 and -inf where the probed cells ran out): the tails must sit in
    the same places, the rest agree row by row."""
    (s_a, i_a), (s_b, i_b) = ((np.asarray(s), np.asarray(i)) for s, i in (a, b))
    if s_a.shape != s_b.shape or not np.array_equal(i_a < 0, i_b < 0):
        return False
    if not (np.isneginf(s_a[i_a < 0]).all() and np.isneginf(s_b[i_b < 0]).all()):
        return False
    for row in range(s_a.shape[0]):
        n = int((i_a[row] >= 0).sum())
        if n and not ids_match_up_to_ties(s_a[row:row + 1, :n], i_a[row:row + 1, :n],
                                          s_b[row:row + 1, :n], i_b[row:row + 1, :n],
                                          true_scores[row:row + 1], tol):
            return False
    return True


def clustered_corpus(n: int, n_centers: int, dim: int, seed: int, spread: float = 0.05):
    """(n, dim) unit-norm f32 rows on the card in ``n_centers`` planted
    clusters (a unit center + N(0, spread^2) per coordinate, normalized),
    and the row → center assignment; made from ``seed`` on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    unit = torch.nn.functional.normalize
    centers = unit(torch.randn((n_centers, dim), device="cuda", generator=gen), dim=1)
    assign = torch.randint(0, n_centers, (n,), device="cuda", generator=gen)
    rows = torch.empty((n, dim), device="cuda")
    for lo in range(0, n, 1 << 18):
        a = assign[lo:lo + (1 << 18)]
        noise = torch.randn((a.shape[0], dim), device="cuda", generator=gen)
        rows[lo:lo + a.shape[0]] = unit(centers[a] + spread * noise, dim=1)
    return rows, centers, assign


def check_ivf(report: dict) -> None:
    """K6 against its plain version at the IVF path's width, then
    IVFIndex.search through K6 against the probe scan on one index.
    Tolerance 1e-4 absolute on unit vectors (exact products, f32 sums in
    another order), K4/K5's."""
    import torch

    from qst_tpu_torch.ops import ivf as ops_ivf
    from qst_tpu_torch.retrieval import IVFIndex

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(16)
    unit = torch.nn.functional.normalize
    C, D, P = 1024, 384, 8
    k6_err, n_cases = 0.0, 0
    group_line = ops_ivf._GROUP_MIN_PAIRS
    for name in ("float32", "bfloat16"):
        for L in (1152, 1160, 2048):
            cells = unit(torch.randn((C, L, D), device=dev, generator=gen), dim=2).to(
                getattr(torch, name))
            # fill counts: an empty cell, one row, all but one, a full cell, the rest random
            fill = torch.randint(0, L + 1, (C,), device=dev, generator=gen, dtype=torch.int32)
            fill[:2] = torch.tensor([0, 1], dtype=torch.int32)
            fill[-2:] = torch.tensor([L - 1, L], dtype=torch.int32)
            for Q in (1, 11, 256, 1100):
                queries = unit(torch.randn((Q, D), device=dev, generator=gen), dim=1)
                probe = torch.randint(0, C, (Q, P), device=dev, generator=gen, dtype=torch.int32)
                # the first and last cells, repeated; the cells of the planted fills
                probe[0] = torch.tensor([0, C - 1, 0, C - 1, 1, C - 2, 1, C - 2],
                                        dtype=torch.int32)
                outside = torch.zeros((Q, P), dtype=torch.bool, device=dev)
                if Q > 2:   # ids outside [0, C): one below, one above, a whole query's
                    probe[1, 0], probe[1, 1], probe[2] = -1, C, C + 5
                    outside[1, :2] = outside[2] = True
                inside = probe.clamp(0, C - 1)
                for counts in (None, fill):
                    ref = ops_ivf.ivf_cell_scores_plain(queries, cells, inside, counts)
                    ref = torch.where(outside.repeat_interleave(L, dim=1), float("-inf"), ref)
                    worst = 0.0
                    for form, line in (("grouped", 1), ("a block a pair", 1 << 62)):
                        ops_ivf._GROUP_MIN_PAIRS = line
                        try:
                            out = ops_ivf.ivf_cell_scores(queries, cells, probe, counts)
                        finally:
                            ops_ivf._GROUP_MIN_PAIRS = group_line
                        torch.cuda.synchronize()
                        what = (f"K6 {name} L={L} Q={Q} {form}, "
                                f"{'with' if counts is not None else 'without'} fill")
                        if out.shape != (Q, P * L) or torch.isnan(out).any():
                            fail(f"{what}: shape {tuple(out.shape)} or NaN scores")
                        if not torch.equal(torch.isneginf(out), torch.isneginf(ref)):
                            fail(f"{what}: -inf in other places than the plain version")
                        err = torch.where(torch.isneginf(ref), 0.0, out - ref).abs().max().item()
                        if not err <= 1e-4:
                            fail(f"{what}: max|err| {err} > 1e-4")
                        worst = max(worst, err)
                        n_cases += 1
                    k6_err = max(k6_err, worst)
                log(f"K6 {name:8s} C={C} L={L} P={P} Q={Q:4d}: both forms, with and without "
                    f"fill (cells of 0, 1, L - 1 and L rows), repeats and ids outside [0, C): "
                    f"max|err| {worst:.3e} (limit 1e-4), -inf where the plain version has it")
            del cells
    log(f"K6: {n_cases} cases, worst max|err| {k6_err:.3e}")
    # an id outside [0, C) reads nothing and scores -inf
    cells = unit(torch.randn((4, 64, D), device=dev, generator=gen), dim=2)
    probe = torch.tensor([[0, 4, 3, -1]], dtype=torch.int32, device=dev)
    out = ops_ivf.ivf_cell_scores(queries[:1], cells, probe).reshape(4, 64)
    if not (torch.isfinite(out[[0, 2]]).all() and torch.isneginf(out[[1, 3]]).all()):
        fail("K6: out-of-range probe ids must score -inf")
    report["K6"]["max_abs_err"] = k6_err

    # IVFIndex.search: K6 path against the probe scan, f32 and bf16 cells,
    # with tails (n_probe = 1 and k = the cell budget leaves -1 / -inf)
    rows, _, _ = clustered_corpus(65536, 256, D, seed=17)
    queries = unit(rows[torch.randint(0, 65536, (64,), device=dev, generator=gen)]
                   + 0.02 * torch.randn((64, D), device=dev, generator=gen), dim=1)
    for name in ("float32", "bfloat16"):
        idx = IVFIndex(rows, n_clusters=256, dtype=name, seed=0)
        stored = torch.from_numpy(idx.reconstruct_rows()).to(dev)
        true = (queries.to(idx.cells.dtype).float() @ stored.T).cpu().numpy()
        for n_probe, k in ((8, 10), (1, idx.cell_budget), (256, 10)):
            got, want = (tuple(t.cpu().numpy() for t in idx._device_search(queries, k, n_probe, b))
                         for b in ("pallas", "xla"))
            if not rows_match_up_to_ties(got, want, true, 1e-4):
                fail(f"IVFIndex.search {name} n_probe={n_probe} k={k}: the K6 path and the "
                     f"probe scan disagree")
        # compact() moves the cells: the same answers, and one copy on the card
        first = [t.clone() for t in idx._device_search(queries, 10, 8, "pallas")]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        idx.compact()
        again = idx._device_search(queries, 10, 8, "pallas")
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"IVFIndex {name}: a search after compact() differs from the one before")
        del again
        if torch.cuda.memory_allocated(dev) > held:
            fail(f"IVFIndex {name}: compact() left {torch.cuda.memory_allocated(dev) - held} "
                 f"more bytes on the card than before")
        near = idx._device_search(queries, 10, 8, "pallas")[1].cpu().tolist()
        recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(near, got[1].tolist())]))
        if not recall >= 0.8:
            fail(f"IVFIndex {name}: recall@10 {recall} < 0.8 at n_probe 8 of 256 on clustered rows")
        log(f"IVFIndex.search {name:8s} {idx.n_docs} docs, {idx.centroids.shape[0]} cells, "
            f"budget {idx.cell_budget}, recall@10 {recall:.4f} at n_probe 8 (limit 0.8), "
            f"spilled {idx.spilled}: the K6 path matches the probe scan at n_probe 8, 1 "
            f"(k = the budget, -1 tails in the same places) and 256")
        del idx, stored


def served_ids(answers, n: int, k: int):
    """(scores (n, k), ids (n, k)) of POST /search answers (one query each)."""
    return (np.array([[r[1] for r in answers[j]["results"][0]] for j in range(n)]),
            np.array([[r[0] for r in answers[j]["results"][0]] for j in range(n)]))


def ask_concurrently(port: int, queries, k: int) -> dict:
    answers, errors = {}, []

    def ask(j):
        try:
            answers[j] = post(port, "/search", {"queries": [queries[j]], "k": k})
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=ask, args=(j,)) for j in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or len(answers) != len(queries):
        fail(f"/search failed: {errors}")
    return answers


LIBRARY_GEMM_MARKS = ("gemm", "gemv", "nvjet", "cutlass", "cublas", "xmma")
LIBRARY_ATTENTION_MARKS = ("flash", "fmha", "sdpa", "attention")
LIBRARY_KERNEL_MARKS = LIBRARY_GEMM_MARKS + LIBRARY_ATTENTION_MARKS


def library_kernels(prof) -> dict:
    """{name: launches} of the profiled device kernels that are a library's
    GEMM or attention (none of the port's own, which live in qst::)."""
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type.name == "CUDA" and "qst::" not in e.key
            and any(b in e.key.lower() for b in LIBRARY_KERNEL_MARKS)}


def ivf(report: dict) -> None:
    """The IVF path through the CLI: build, serve (static and updatable)
    and query over 65,536 synthetic docs with random-init MiniLM-L6."""
    import io
    import tempfile

    import torch
    from torch.profiler import profile

    from qst_tpu_torch.cli import index_main
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import ivf as ops_ivf
    from qst_tpu_torch.retrieval import ExactIndex, IVFIndex, UpdatableIndex

    docs = synthetic_docs(65536, seed=14)
    rng = np.random.default_rng(15)
    queries = [docs[j] for j in rng.integers(0, len(docs), 32)] + synthetic_docs(32, seed=99)
    k = 10
    with tempfile.TemporaryDirectory() as tmp:
        texts, index_dir = f"{tmp}/docs.txt", f"{tmp}/ivf_index"
        with open(texts, "w") as f:
            f.write("\n".join(docs) + "\n")
        encoder_flags = ["--encoder_preset", "minilm-l6", "--use_fused_layer", "--seed", "14"]
        counts = (fl.fused_bert_layer, ops_ivf.ivf_cell_scores)
        for fn in counts:
            fn.launches = 0
        t0 = time.perf_counter()
        if index_main.main(["build", "--texts", texts, "--index_dir", index_dir, "--index_dtype",
                            "ivf", "--ivf_clusters", "256", "--ivf_probe", "8",
                            *encoder_flags]) != 0:
            fail("index_main build failed")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        serve_argv = ["serve", "--index_dir", index_dir, "--index_dtype", "ivf", "--port", "0",
                      *encoder_flags]
        args = index_main.build_parser().parse_args(serve_argv)
        retr = index_main.serving_retriever(args)
        index = retr.index
        if not (isinstance(index, IVFIndex) and index.device.type == "cuda"
                and index.n_docs == len(docs) and index.default_n_probe == 8):
            fail(f"serve loaded {type(index).__name__} on {getattr(index, 'device', None)}")
        log(f"index_main build: {len(docs)} docs encoded (K1) and clustered into "
            f"{index.centroids.shape[0]} cells of "
            f"budget {index.cell_budget} (f32 cells, {index.cells.numel() * 4 / 1e6:.0f} MB) "
            f"and saved in {build_s:.1f} s; 'auto' takes K6: {index._pallas_eligible()}")
        if not index._pallas_eligible():
            fail("the built index is not eligible for K6 under backend='auto'")

        # record the query embeddings the server computes, so its answers
        # are held against searches over the very same vectors
        seen = {}
        encode = retr.encoder.encode

        def recording_encode(texts, batch_size=256, convert_to_numpy=True):
            out = encode(texts, batch_size=batch_size, convert_to_numpy=convert_to_numpy)
            for t, row in zip(texts, out):
                seen.setdefault(t, row)
            return out

        retr.encoder.encode = recording_encode
        server = index_main.serving_server(args, retr)
        port = server.start()
        try:
            answers = ask_concurrently(port, queries, k)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            server.stop()
        retr.encoder.encode = encode
        if health != {"ok": True, "n_docs": len(docs)}:
            fail(f"/healthz answered {health}")

        # the query command, as the user runs it, on its own stdout
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = index_main.main(["query", "--index_dir", index_dir, "--index_dtype", "ivf",
                                  "--k", str(k), "--queries", *queries[:3], *encoder_flags])
        printed = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
        launches = {n: fn.launches for n, fn in zip(("K1", "K6"), counts)}
        log(f"launches during index_main build + serve + query: {launches}")
        for n, c in launches.items():
            if c <= 0:
                fail(f"{n} was never launched on the IVF path")
        report["K1"]["launches"] = report["K1"].get("launches", 0) + launches["K1"]
        report["K6"]["launches"] = launches["K6"]

        # served answers == the index's probe scan over the same embeddings
        ss, si = served_ids(answers, len(queries), k)
        if ss.shape != (len(queries), k):
            fail(f"served rows have shape {ss.shape}: the probed cells ran out of documents")
        q_emb = torch.stack([seen[q] for q in queries])
        stored = torch.from_numpy(index.reconstruct_rows()).cuda()
        true = (q_emb @ stored.T).cpu().numpy()
        xs, xi = index.search(q_emb, k=k, n_probe=8, backend="xla")
        if not ids_match_up_to_ties(ss, si, xs, np.array(xi), true, 1e-4):
            fail("served IVF answers differ from the index's 'xla' backend")
        log(f"/search answers ({len(queries)} concurrent requests) match the probe scan "
            f"('xla' backend) over the same embeddings")
        if rc != 0 or [p["query"] for p in printed] != queries[:3]:
            fail(f"index_main query: rc {rc}, printed {len(printed)} rows")
        for j, p in enumerate(printed):
            if len(p["hits"]) != k or not np.allclose([h["score"] for h in p["hits"]], ss[j],
                                                      atol=1e-4 + 5e-5, rtol=0):
                fail(f"index_main query's hits for query {j} differ from the served ones")
        log("index_main query: 3 queries, hits equal to the served ones (scores to 1e-4)")

        # recall@10 against an exact index over the same embeddings
        exact = ExactIndex(stored, device="cuda")
        es, ei = exact.search(q_emb, k=k, score="dot_score", backend="xla")
        recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(si.tolist(),
                                                                          ei.tolist())]))
        fs, fi = index.search(q_emb, k=k, n_probe=256, backend="pallas")
        full_ok = ids_match_up_to_ties(fs, np.array(fi), es, ei, true, 1e-4)
        # no bar on this corpus: random words through a random-init encoder
        # have no cluster structure for k-means to find (the 0.8 bar is held
        # on the clustered indexes of `check` and `times`)
        log(f"IVF recall@10 against ExactIndex over the same embeddings: {recall:.4f} at "
            f"n_probe 8 of {index.centroids.shape[0]} (reported; the corpus is unclustered); "
            f"full probe through K6 equals the exact search: {full_ok}")
        report["ivf"] = {"build_s": build_s, "recall_at_10": recall,
                         "cell_budget": index.cell_budget}
        if not full_ok:
            fail("the full-probe IVF search differs from the exact search")

        # one request under the profiler: the centroid product is the only
        # library GEMM (it is a plain matmul in the JAX package too). The
        # trace sometimes loses most of a window's kernels (seen once in PR
        # 9: 10 of a request's 36, none of the product's): a window pair in
        # which the product alone shows no kernel at all, or the request
        # none of its library ones, is taken again, up to three times
        qn = torch.nn.functional.normalize(q_emb[:4].float(), dim=1)
        for attempt in range(3):
            with profile(activities=device_activity()) as prof:
                for _ in range(3):   # the trace may miss the first kernel after it starts
                    qn @ index.centroids.T
                torch.cuda.synchronize()
            centroid_kernels = set(library_kernels(prof))
            with profile(activities=device_activity()) as prof:
                retr.search(queries[:4], k=k)
                torch.cuda.synchronize()
            names = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
            lib = library_kernels(prof)
            if centroid_kernels and lib:
                break
            log(f"the profiler lost the window's kernels (attempt {attempt + 1} of 3: "
                f"{len(names)} distinct in the request)")
        log(f"profiled IVF request: {len(names)} distinct device kernels; K6 among them: "
            f"{any('ivf_cell_scores_kernel' in n for n in names)}; library GEMM/attention "
            f"kernels: {lib}; the centroid product alone runs {sorted(centroid_kernels)}")
        if not any("ivf_cell_scores_kernel" in n for n in names):
            fail("the profiler did not see K6 in an IVF request")
        if not lib or set(lib) - centroid_kernels or set(lib.values()) != {1}:
            fail(f"library kernels on the IVF path other than one centroid product: {lib}")

        # serve --updatable: one POST /docs + DELETE /docs round
        args = index_main.build_parser().parse_args(serve_argv + ["--updatable"])
        retr_u = index_main.serving_retriever(args)
        if not isinstance(retr_u.index, UpdatableIndex) or retr_u.index.device.type != "cuda":
            fail("serve --updatable did not convert the IVF index to an UpdatableIndex")
        server = index_main.serving_server(args, retr_u)
        port = server.start()
        new_doc = "w4242 w17 an entirely new document w9 w9 w9"
        try:
            before = post(port, "/search", {"queries": [queries[0]], "k": k})["results"][0]
            added = post(port, "/docs", {"texts": [new_doc], "ids": ["new-doc"]})
            hit = post(port, "/search", {"queries": [new_doc], "k": 1,
                                         "return_texts": True})["results"][0][0]
            req = urllib.request.Request(f"http://127.0.0.1:{port}/docs", method="DELETE",
                                         data=json.dumps({"ids": ["new-doc"]}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                removed = json.loads(r.read())
            after = post(port, "/search", {"queries": [new_doc], "k": k})["results"][0]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            server.stop()
        if (added != {"ids": ["new-doc"]} or hit[0] != "new-doc" or hit[2] != new_doc
                or abs(hit[1] - 1.0) > 1e-3 or removed != {"removed": 1}
                or "new-doc" in [r[0] for r in after] or len(after) != k
                or health != {"ok": True, "n_docs": len(docs)}):
            fail(f"updatable round: added {added}, hit {hit}, removed {removed}, health {health}")
        # the exact buffer holds the IVF cells' rows: its answers are the
        # exact index's (scores 1e-4; the query rides in another batch)
        if not np.allclose([r[1] for r in before], es[0], atol=1e-4, rtol=0):
            fail("the updatable server's answers differ from the exact search")
        log(f"serve --updatable: capacity {retr_u.index.capacity}, POST /docs added 'new-doc' "
            f"(found at score {hit[1]:.4f}), DELETE /docs removed it, {health['n_docs']} docs "
            f"after")


def query_batches(rows, Q: int, gen, n: int = 8):
    """``n`` batches of Q noisy copies of random corpus rows, unit-norm: a
    search in turn over them does not find the last one's cells in the 50 MB
    L2."""
    import torch

    out = []
    for _ in range(n):
        pick = torch.randint(0, rows.shape[0], (Q,), device=rows.device, generator=gen)
        noise = torch.randn((Q, rows.shape[1]), device=rows.device, generator=gen)
        out.append(torch.nn.functional.normalize(rows[pick] + 0.02 * noise, dim=1))
    return out


def in_turn(fn, n: int):
    """fn(0), fn(1), ... fn(n - 1), fn(0), ...: one more on each call."""
    turn = [0]

    def run():
        turn[0] = (turn[0] + 1) % n
        return fn(turn[0])
    return run


def searches_beside_exact(idx, rows, corpus, Q: int, P: int, k: int, gen, reps: int) -> dict:
    """One IVF search through K6 beside the exact K4 + K5 search over the
    same rows, with the recall@10 of the IVF answers."""
    import torch

    from qst_tpu_torch.ops import topk

    batches = query_batches(rows, Q, gen)
    search = in_turn(lambda j: idx._device_search(batches[j], k, P, "pallas"), len(batches))
    # whole searches are host-bound at small Q, and the first twenty or
    # so calls after a build run about twice slower than the rest (0.93
    # against 0.48 ms at Q = 8; not investigated): a long warm-up
    ivf_ms = cuda_ms(search, reps, warmup=reps // 2)
    exact_ms = cuda_ms(in_turn(lambda j: topk.topk_v2(batches[j].to(torch.bfloat16), corpus, k),
                               len(batches)), reps, warmup=reps // 2)
    _, ivf_ids = idx._device_search(batches[0], k, P, "pallas")
    _, exact_ids = topk.topk_v2(batches[0].to(torch.bfloat16), corpus, k)
    recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(
        ivf_ids.cpu().tolist(), exact_ids.cpu().tolist())]))
    if not recall >= 0.8:
        fail(f"IVF recall@10 {recall} < 0.8 on the clustered index at Q={Q}")
    return {"batches": batches, "ivf_pallas_ms": ivf_ms,
            "ivf_pallas_qps": Q / ivf_ms * 1e3, "exact_ms": exact_ms,
            "exact_qps": Q / exact_ms * 1e3, "recall_at_10": recall}


def times_ivf(report: dict) -> None:
    """K6 and whole IVF searches over a 1M x 384 bf16 clustered index
    (1,024 cells) beside the exact K4 + K5 search over the same rows; K6's
    two forms around the pair count where the wrapper changes over; the
    searches again over 4M rows (4,096 cells)."""
    import torch

    from qst_tpu_torch.ops import ivf as ops_ivf
    from qst_tpu_torch.retrieval import IVFIndex
    from qst_tpu_torch.retrieval.ivf import _probe

    dev = torch.device("cuda")
    N, C, D, P, k = 1 << 20, 1024, 384, 8, 10
    rows, _, _ = clustered_corpus(N, C, D, seed=21)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = IVFIndex(rows, n_clusters=C, dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    corpus = rows.to(torch.bfloat16)
    L = idx.cell_budget
    mean_fill = idx.fill.float().mean().item()
    log(f"IVF index over {N} x {D} clustered rows: {C} cells of budget {L} (mean fill "
        f"{mean_fill:.0f} rows), bf16 cells {idx.cells.numel() * 2 / 1e9:.2f} GB, "
        f"{idx.spilled} docs spilled, built in {build_s:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(22)
    out = {"build_s": build_s, "cell_budget": L, "cells_gb": idx.cells.numel() * 2 / 1e9,
           "mean_fill": mean_fill}
    for Q in (8, 64, 256):
        whole = searches_beside_exact(idx, rows, corpus, Q, P, k, gen, reps=48)
        batches = whole.pop("batches")
        probes = [_probe(q, idx.centroids, P) for q in batches]
        k6 = {}
        for key, fn, reps in (
                ("k6_ms", lambda j: ops_ivf.ivf_cell_scores(probes[j][0], idx.cells,
                                                            probes[j][1], idx.fill), 16),
                ("k6_all_slots_ms", lambda j: ops_ivf.ivf_cell_scores(
                    probes[j][0], idx.cells, probes[j][1]), 16),
                ("k6_plain_ms", lambda j: ops_ivf.ivf_cell_scores_plain(
                    probes[j][0], idx.cells, probes[j][1], idx.fill), 8)):
            k6[key] = cuda_ms(in_turn(fn, len(batches)), reps, warmup=2)
        xla_ms = cuda_ms(in_turn(lambda j: idx._device_search(batches[j], k, P, "xla"),
                                 len(batches)), 8, warmup=2)
        # the bound, from this run's probes: the filled rows of each distinct
        # probed cell read once, the queries and ids read and the scores
        # written once; without fill every slot of those cells (beside it the
        # whole gather: one read per pair)
        cells_hit = [p[1].unique() for p in probes]
        unique_cells = float(np.mean([c.numel() for c in cells_hit]))
        filled_rows = float(np.mean([idx.fill[c].sum().item() for c in cells_hit]))
        scored_rows = float(np.mean([idx.fill[p[1].reshape(-1)].sum().item() for p in probes]))
        fixed = Q * D * 2 + Q * P * 4 + Q * P * L * 4
        b = bound(filled_rows * D * 2 + C * 4 + fixed, 2.0 * scored_rows * D, "bfloat16")
        b_all = bound(unique_cells * L * D * 2 + fixed, 2.0 * Q * P * L * D, "bfloat16")
        gather_bytes = Q * P * L * D * 2
        out[f"Q{Q}"] = {**k6, **b, "all_slots_bound_ms": b_all["bound_ms"],
                        "gather_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
                        "unique_cells": unique_cells, "filled_rows": filled_rows,
                        "ivf_xla_ms": xla_ms, "ivf_xla_qps": Q / xla_ms * 1e3, **whole}
        log(f"IVF Q={Q:3d} P={P} over {N} x {D} bf16: K6 {k6['k6_all_slots_ms']:.3f} ms "
            f"without fill (every slot of {unique_cells:.0f} distinct cells: bound "
            f"{b_all['bound_ms']:.4f} ms, {b_all['bound_ms'] / k6['k6_all_slots_ms']:.0%}; the "
            f"whole gather's {gather_bytes / 1e6:.0f} MB would take "
            f"{gather_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), {k6['k6_ms']:.3f} ms with fill "
            f"({filled_rows:.0f} filled rows: bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
            f"{b['bound_ms'] / k6['k6_ms']:.0%}; plain {k6['k6_plain_ms']:.3f}); search through "
            f"K6 {whole['ivf_pallas_ms']:.3f} ms = {whole['ivf_pallas_qps']:.0f} QPS, probe scan "
            f"{xla_ms:.3f} ms, exact K4 + K5 {whole['exact_ms']:.3f} ms = "
            f"{whole['exact_qps']:.0f} QPS; recall@10 {whole['recall_at_10']:.4f}")
        if b["bound_ms"] > k6["k6_ms"] or b_all["bound_ms"] > k6["k6_all_slots_ms"]:
            fail(f"K6 at Q={Q} reads faster than its bound: the bound's count is wrong")

    # K6 by form, with fill: pairs sorted by cell against a pair a block
    group_line = ops_ivf._GROUP_MIN_PAIRS
    by_form = {}
    for Q in (8, 64, 256, 1024):
        probes = [_probe(q, idx.centroids, P) for q in query_batches(rows, Q, gen)]
        forms = {}
        for form, line in (("grouped", 1), ("ungrouped", 1 << 62)):
            ops_ivf._GROUP_MIN_PAIRS = line
            try:
                forms[form] = cuda_ms(in_turn(lambda j: ops_ivf.ivf_cell_scores(
                    probes[j][0], idx.cells, probes[j][1], idx.fill), len(probes)), 16, warmup=2)
            finally:
                ops_ivf._GROUP_MIN_PAIRS = group_line
        by_form[Q * P] = forms
    out["k6_by_form"] = by_form
    log(f"K6 by form (pairs: grouped / a block a pair, ms; the wrapper groups from "
        f"{group_line} pairs on): " + "; ".join(
            f"{n}: {f['grouped']:.3f} / {f['ungrouped']:.3f}" for n, f in by_form.items()))
    report["ivf_times"] = out
    big = out["Q256"]
    report["K6"].update(ms=big["k6_ms"], plain_ms=big["k6_plain_ms"],
                        bound_ms=big["bound_ms"], bound_by=big["bound_by"])

    # the same searches over 4M rows: 4,096 cells, the exact search reads 3.1 GB
    del idx, corpus, rows
    torch.cuda.empty_cache()
    N4, C4 = 1 << 22, 4096
    rows, _, _ = clustered_corpus(N4, C4, D, seed=23)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = IVFIndex(rows, n_clusters=C4, dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    corpus = rows.to(torch.bfloat16)
    big = {"build_s": build_s, "cell_budget": idx.cell_budget,
           "cells_gb": idx.cells.numel() * 2 / 1e9, "mean_fill": idx.fill.float().mean().item()}
    log(f"IVF index over {N4} x {D} clustered rows: {C4} cells of budget {idx.cell_budget} "
        f"(mean fill {big['mean_fill']:.0f} rows), bf16 cells {big['cells_gb']:.2f} GB, "
        f"corpus {corpus.numel() * 2 / 1e9:.2f} GB, built in {build_s:.1f} s")
    for Q in (8, 64, 256):
        whole = searches_beside_exact(idx, rows, corpus, Q, P, k, gen, reps=24)
        del whole["batches"]
        big[f"Q{Q}"] = whole
        log(f"IVF Q={Q:3d} P={P} over {N4} x {D} bf16: search through K6 "
            f"{whole['ivf_pallas_ms']:.3f} ms; exact K4 + K5 "
            f"{whole['exact_ms']:.3f} ms; recall@10 {whole['recall_at_10']:.4f}")
    report["ivf_times_4m"] = big


def synthetic_docs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(5000)]
    lens = rng.integers(4, 40, n)
    picks = rng.integers(0, len(words), int(lens.sum()))
    out, pos = [], 0
    for L in lens:
        out.append(" ".join(words[j] for j in picks[pos:pos + L]))
        pos += L
    return out


def post(port: int, path: str, obj) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def serve(report: dict) -> None:
    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, embed_fn, init_params
    from qst_tpu_torch.models.tokenizer import HashTokenizer
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import topk
    from qst_tpu_torch.retrieval import Retriever
    from qst_tpu_torch.serve import RetrievalServer

    cfg = EncoderConfig.minilm_l6(use_fused_layer=True)
    params = init_params(cfg, torch.Generator().manual_seed(14), device="cuda")
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    enc = SentenceEncoder(cfg, params, tok)
    docs = synthetic_docs(65536, seed=14)
    queries = [docs[j] for j in (3, 777, 4096, 30000, 65535)] + [
        "w1 w2 w3 w4", "w4999 w17 w17 w300 w12", "a query of unknown words"]

    # whole-encoder check at f32: K1 path against the nn.Module path
    # (tolerance 1e-4 absolute on unit-norm embeddings: f32 summation order)
    cfg32 = EncoderConfig.minilm_l6(use_fused_layer=True, dtype="float32")
    enc32 = SentenceEncoder(cfg32, params, tok)
    ids, mask = tok.batch_encode(docs[:64], max_length=128)
    ids_t = torch.from_numpy(ids.astype(np.int64)).cuda()
    mask_t = torch.from_numpy(mask.astype(np.int64)).cuda()
    e_k = enc32.encode_ids(ids_t, mask_t)
    e_p = embed_fn(EncoderConfig.minilm_l6(dtype="float32"))(enc32.model, ids_t, mask_t)
    err = (e_k - e_p).abs().max().item()
    log(f"encode f32 K1 vs nn.Module path: max|err| {err:.3e} (limit 1e-4)")
    if not err <= 1e-4:
        fail(f"encode f32: max|err| {err} > 1e-4")

    counts = (fl.fused_bert_layer, topk.bucket_maxima, topk.rescore_buckets)
    for fn in counts:
        fn.launches = 0
    t0 = time.perf_counter()
    # dot_score on the encoder's unit-norm embeddings (= cos): "auto" takes
    # the kernels for cos only on a normalized index, as in qst_tpu
    retr = Retriever(enc, score="dot_score", index_dtype="bfloat16").build(docs)
    torch.cuda.synchronize()
    log(f"built bf16 index: {retr.index.n_docs} docs in {time.perf_counter() - t0:.1f} s")
    # record the query embeddings the server computes, so its answers are
    # held against the plain scan over the very same vectors
    seen = {}
    encode = enc.encode

    def recording_encode(texts, batch_size=256, convert_to_numpy=True):
        out = encode(texts, batch_size=batch_size, convert_to_numpy=convert_to_numpy)
        for t, row in zip(texts, out):
            seen.setdefault(t, row)
        return out

    enc.encode = recording_encode
    server = RetrievalServer(retr, port=0)
    port = server.start()
    try:
        answers = ask_concurrently(port, queries, 10)
        enc_resp = post(port, "/encode", {"texts": queries[:3]})
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.stop()
    launches = {n: fn.launches for n, fn in zip(("K1", "K4", "K5"), counts)}
    log(f"launches during build + serve: {launches}")
    for n, c in launches.items():
        if c <= 0:
            fail(f"{n} was never launched on the serving path")
        report[n]["launches"] = c
    if health != {"ok": True, "n_docs": 65536}:
        fail(f"/healthz answered {health}")

    # the answers against the plain path over the same embeddings: the
    # plain bucket-max scan over the index (scores 1e-4, ids up to ties)
    enc.encode = encode
    q_emb = torch.stack([seen[q] for q in queries])
    ps, pi = retr.index.search(q_emb, k=10, backend="xla")
    true = (q_emb.to(torch.bfloat16).float() @ retr.index.embeddings.float().T).cpu().numpy()
    ss, si = served_ids(answers, len(queries), 10)
    if not ids_match_up_to_ties(ss, si, ps, pi, true, 1e-4):
        fail("server /search answers differ from the plain path")
    log(f"/search answers ({len(queries)} concurrent requests) match the plain scan")

    # /encode (bf16, K1) against the nn.Module path in bf16: cosine >= 0.99
    # (the two round to bf16 at different points inside each layer)
    e_srv = torch.tensor(enc_resp["embeddings"], device="cuda")
    e_mod = embed_fn(EncoderConfig.minilm_l6())(enc.model, *[
        torch.from_numpy(a.astype(np.int64)).cuda()
        for a in tok.batch_encode(queries[:3], max_length=128)])
    cos = torch.nn.functional.cosine_similarity(e_srv, e_mod, dim=1).min().item()
    log(f"/encode bf16 vs nn.Module bf16 path: min cosine {cos:.5f} (limit 0.99)")
    if not (np.isfinite(cos) and cos >= 0.99):
        fail(f"/encode: min cosine {cos}")

    # one request under the profiler: no library GEMM or attention kernel
    from torch.profiler import profile

    with profile(activities=device_activity()) as prof:
        retr.search(queries[:4], k=10)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not names:
        fail("the profiler saw no device kernels in a served request")
    banned = sorted(library_kernels(prof))
    log(f"profiled request: {len(names)} distinct device kernels; library GEMM/attention: {banned}")
    if banned:
        fail(f"library kernels on the serving path: {banned}")


def write_quadruplet_chunks(root: str, n: int, seed: int, per_chunk: int = 64) -> None:
    """A synthetic quadruplet dataset in the chunk format, written with the
    port's write_chunk: each reference is 8-20 words from a seeded word
    list, its positives swap three words, its part-positives keep half."""
    from qst_tpu_torch.data import write_chunk, write_meta

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(5000)]

    def text(ws):
        return " ".join([words[j] for j in ws.tolist()])

    insts = []
    for i in range(n):
        ref = rng.integers(0, len(words), int(rng.integers(8, 21)))
        pos, part = [], []
        for _ in range(3):
            v = ref.copy()
            v[rng.integers(0, len(v), 3)] = rng.integers(0, len(words), 3)
            pos.append(text(v))
        for _ in range(2):
            half = ref[: len(ref) // 2]
            part.append(text(np.concatenate([half, rng.integers(0, len(words), 4)])))
        insts.append({"id": i, "reference": text(ref), "positive": pos, "part_positive": part})
    for c in range(0, n, per_chunk):
        write_chunk(root, c // per_chunk, insts[c:c + per_chunk], dataset_name="synthetic")
    write_meta(root, (n + per_chunk - 1) // per_chunk)


def quadruplet_set(n: int, seed: int) -> str:
    """``write_quadruplet_chunks(root, n, seed)`` into this run's scratch tree,
    once for the phases that read it (none writes there): → its root."""
    root = os.path.join(work_dir("quadruplets"), f"{n}_{seed}")
    if not os.path.isdir(root):
        write_quadruplet_chunks(root, n, seed)
    return root


class plain_kernels:
    """Within the block, the training path's kernel wrappers are their plain
    versions (so the same step runs through K1/K2/K3's, or K7/K8's, plain
    versions on the card, for the gradient comparison); restored on exit."""

    def __enter__(self):
        from qst_tpu_torch.ops import flash_attention as fa
        from qst_tpu_torch.ops import fused_layer as fl
        from qst_tpu_torch.ops import quadruplet as qd

        self.saved = [(fl, "fused_bert_layer", fl.fused_bert_layer_plain),
                      (fl, "fused_bert_layer_bwd", fl.fused_bert_layer_bwd_plain),
                      (qd, "fused_gamma_quadruplet_loss_fwd", qd.fused_gamma_quadruplet_loss_plain),
                      (qd, "fused_gamma_quadruplet_loss_bwd",
                       qd.fused_gamma_quadruplet_loss_bwd_plain),
                      (fa, "flash_attention", fa.flash_attention_plain),
                      (fa, "flash_attention_bwd", fa.flash_attention_bwd_plain)]
        self.saved = [(m, n, getattr(m, n), plain) for m, n, plain in self.saved]
        for m, n, _, plain in self.saved:
            setattr(m, n, plain)
        return self

    def __exit__(self, *exc):
        for m, n, orig, _ in self.saved:
            setattr(m, n, orig)
        return False


def train_config():
    """The training path's configuration: what ``train_main
    --use_fused_layer --use_fused_loss_kernel`` builds — MiniLM-L6 at full
    width (bf16 compute, f32 params, dropout 0.1), the fused γ loss, batch
    32 quadruplets, AdamW on warmuplinear, clip 1.0, S = 128."""
    from qst_tpu_torch.core.config import EncoderConfig, LossConfig, TrainConfig

    return (EncoderConfig.minilm_l6(use_fused_layer=True),
            LossConfig(kind="gamma", use_fused_kernel=True), TrainConfig())


def collated_batch(enc_cfg, seed: int, root: str):
    from qst_tpu_torch.data import QuadrupletCollator, QuadrupletDataset
    from qst_tpu_torch.models.tokenizer import HashTokenizer

    ds = QuadrupletDataset(root, seed=seed)
    collator = QuadrupletCollator(HashTokenizer(vocab_size=enc_cfg.vocab_size),
                                  max_length=enc_cfg.max_seq_length)
    return collator(ds.sample_batch(range(32), step=0))


def train(report: dict) -> None:
    """Trainer.train at the training path's configuration through K1 (with
    dropout), K2 and K3; then the first step's gradients at dropout 0
    against the plain versions, and a falling loss on a repeated batch."""
    import dataclasses
    import tempfile

    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.core.telemetry import JsonLogSink
    from qst_tpu_torch.data import QuadrupletCollator, QuadrupletDataset
    from qst_tpu_torch.models.tokenizer import HashTokenizer
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import quadruplet as qd
    from qst_tpu_torch.train import Trainer, create_train_state, dropout_key, make_train_step
    from qst_tpu_torch.train.train_step import encoder_apply_fn, loss_from_config

    enc_cfg, loss_cfg, base = train_config()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        root = f"{tmp}/chunks"
        write_quadruplet_chunks(root, 320, seed=14)
        ds = QuadrupletDataset(root, seed=14)
        collator = QuadrupletCollator(HashTokenizer(vocab_size=enc_cfg.vocab_size),
                                      max_length=enc_cfg.max_seq_length)
        cfg = dataclasses.replace(base, epochs=1, evaluation_steps=1, checkpoint_save_steps=0,
                                  save_best_model=False, experiment_dir=f"{tmp}/exp")
        trainer = Trainer(enc_cfg, loss_cfg, cfg, ds, collator, device=dev)
        counters = (fl.fused_bert_layer, fl.fused_bert_layer_bwd,
                    qd.fused_gamma_quadruplet_loss_fwd, qd.fused_gamma_quadruplet_loss_bwd)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        result = trainer.train()
        wall = time.perf_counter() - t0
        launches = [c.launches for c in counters]
        losses = [e["loss"] for e in JsonLogSink(f"{cfg.experiment_dir}/train_loss.json").read()]
        steps = result.state.step
        log(f"Trainer.train: {steps} steps of MiniLM-L6 (batch 32 quadruplets, S=128, bf16, "
            f"dropout 0.1) in {wall:.1f} s, {result.steps_per_sec:.2f} steps/s in the loop; "
            f"launches K1 {launches[0]}, K2 {launches[1]}, K3 forward {launches[2]}, "
            f"backward {launches[3]}; losses {['%.4f' % v for v in losses]}")
        if steps != 10 or len(losses) != steps or not all(np.isfinite(losses)):
            fail(f"Trainer.train: {steps} steps, losses {losses}")
        if launches != [6 * steps, 6 * steps, steps, steps]:
            fail(f"kernel launches {launches}, want 6, 6, 1 and 1 per step of {steps}")
        report["K1"]["launches"] = report["K1"].get("launches", 0) + launches[0]
        report["K2"]["launches"] = launches[1]
        report["K3"]["launches"] = launches[2] + launches[3]
        report["train"] = {"trainer_steps_per_s": result.steps_per_sec}
        batch = collated_batch(enc_cfg, 3, root)

    # the first step's gradients at dropout 0: kernels against plain versions
    cfg0 = dataclasses.replace(enc_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    state, _ = create_train_state(cfg0, base, torch.Generator().manual_seed(14), 10, loss_cfg,
                                  device=dev)
    ids = torch.from_numpy(batch.input_ids.reshape(128, -1).astype(np.int64)).to(dev)
    mask = torch.from_numpy(batch.attention_mask.reshape(128, -1).astype(np.int64)).to(dev)
    grads = []
    for plain in (False, True):
        state.model.zero_grad(set_to_none=True)
        with plain_kernels() if plain else contextlib.nullcontext():
            emb = encoder_apply_fn(cfg0)(state.model, ids, mask, None).reshape(4, 32, -1)
            loss_from_config(loss_cfg)(*emb.unbind(0)).backward()
        torch.cuda.synchronize()
        grads.append({n: p.grad.detach().clone() for n, p in state.model.named_parameters()})
    kern, ref = grads
    flat_k = torch.cat([g.flatten() for g in kern.values()])
    flat_r = torch.cat([g.flatten() for g in ref.values()])
    cos = torch.nn.functional.cosine_similarity(flat_k, flat_r, dim=0).item()
    worst = (0.0, "")
    for n, g in ref.items():
        # the key bias's gradient is rounding noise (see grad_errors): held
        # to the query bias's norm
        den = ref[n.replace("key", "query")] if n.endswith("self.key.bias") else g
        rel = ((kern[n] - g).norm() / den.norm().clamp_min(1e-30)).item()
        worst = max(worst, (rel, n))
    log(f"first step's gradients, dropout 0, kernels against plain versions: cosine "
        f"{cos:.6f} (limit 0.999), worst per-tensor |g_k - g_p|/|g_p| {worst[0]:.3e} "
        f"({worst[1]}; limit 5e-2)")
    if not (cos >= 0.999 and worst[0] <= 5e-2):
        fail("the kernel path's gradients disagree with the plain versions")
    report["train"]["grad_cosine"] = cos

    # one train step at EncoderConfig.tiny() (head width 16, f32, dropout
    # 0.1) through K1, K2 and K3, and its loss against the same step through
    # the plain versions (the same dropout masks): 1e-4 absolute
    tiny = EncoderConfig.tiny(use_fused_layer=True)
    ids = torch.randint(5, tiny.vocab_size, (4, 8, 32), generator=torch.Generator().manual_seed(4))
    tiny_mask = torch.ones_like(ids)
    tiny_mask[:, :, 20:] = 0
    tiny_losses = []
    for plain in (False, True):
        state, _ = create_train_state(tiny, base, torch.Generator().manual_seed(5), 10, loss_cfg,
                                      device=dev)
        for c in counters:
            c.launches = 0
        with plain_kernels() if plain else contextlib.nullcontext():
            state, loss = make_train_step(tiny, loss_cfg)(
                state, ids, tiny_mask, dropout_key(6, 1))
        tiny_losses.append(loss.item())
        if not plain:
            tiny_launches = [c.launches for c in counters]
    log(f"one train step at EncoderConfig.tiny() (head width 16): loss {tiny_losses[0]:.6f} "
        f"through the kernels, {tiny_losses[1]:.6f} through the plain versions (limit 1e-4); "
        f"launches K1 {tiny_launches[0]}, K2 {tiny_launches[1]}, K3 {tiny_launches[2:]}")
    if not (np.isfinite(tiny_losses[0]) and abs(tiny_losses[0] - tiny_losses[1]) <= 1e-4
            and tiny_launches == [2, 2, 1, 1]):
        fail("the tiny train step through the kernels")

    # a falling loss: 20 steps on one repeated batch, warmup 4
    state, _ = create_train_state(enc_cfg, dataclasses.replace(base, learning_rate=1e-4,
                                                               warmup_steps=4),
                                  torch.Generator().manual_seed(15), 20, loss_cfg, device=dev)
    step = make_train_step(enc_cfg, loss_cfg)
    losses = []
    for i in range(20):
        state, loss = step(state, batch.input_ids, batch.attention_mask, dropout_key(1000, i + 1))
        losses.append(loss.item())
    log(f"20 steps on one repeated batch (lr 1e-4, warmup 4): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {['%.3f' % v for v in losses]}")
    if not (all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3])):
        fail(f"the loss did not fall: {losses}")


class plain_search:
    """Within the block, ExactIndex's "auto" takes the plain scan for every
    search (``backend="xla"``): with ``plain_kernels`` the IR evaluator's
    path through the plain versions alone."""

    def __enter__(self):
        from qst_tpu_torch.retrieval.index import ExactIndex

        self.saved = ExactIndex.PALLAS_MIN_DOCS
        ExactIndex.PALLAS_MIN_DOCS = 1 << 62
        return self

    def __exit__(self, *exc):
        from qst_tpu_torch.retrieval.index import ExactIndex

        ExactIndex.PALLAS_MIN_DOCS = self.saved
        return False


class logged:
    """Collects the records of one logger (a CLI's own summary line)."""

    def __init__(self, name: str):
        import logging

        self.logger, self.records = logging.getLogger(name), []
        self.handler = logging.Handler()
        self.handler.emit = self.records.append

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        return False


def batches_of(n: int, size: int = 256) -> int:
    """The encode batches (SentenceEncoder.encode's default size) of n texts."""
    return -(-n // size)


EVAL_STEPS = 15
IR_GRID = ["--accuracy_at_k", "1", "3", "5", "10", "--precision_recall_at_k", "1", "3", "5",
           "10", "--mrr_at_k", "10", "--ndcg_at_k", "10", "--map_at_k", "100"]


def read_csv(path: str) -> list:
    import csv

    with open(path) as f:
        return list(csv.reader(f))[1:]


def train_main_run(report: dict, small: str, exp: str, mode: str) -> dict:
    """``train_main`` as a user calls it on ``small``; its launches, held to
    what the steps, the miner and the evaluators account for exactly."""
    from qst_tpu_torch.cli import train_main
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import ivf as ops_ivf
    from qst_tpu_torch.ops import quadruplet as qd
    from qst_tpu_torch.ops import topk

    counters = {"K1": fl.fused_bert_layer, "K2": fl.fused_bert_layer_bwd,
                "K3 forward": qd.fused_gamma_quadruplet_loss_fwd,
                "K3 backward": qd.fused_gamma_quadruplet_loss_bwd,
                "K4": topk.bucket_maxima, "K5": topk.rescore_buckets,
                "K6": ops_ivf.ivf_cell_scores}
    argv = ["--dataset_root", small, "--experiment_dir", exp, "--use_fused_layer",
            "--use_fused_loss_kernel", "--hard_contrastive_mode", mode, "--use_ir_evaluator",
            "--epochs", "1", "--evaluation_steps", str(EVAL_STEPS), "--warmup_steps", "5",
            "--learning_rate", "5e-5", "--early_stopping_patience", "100", "--seed", "14"]
    for c in counters.values():
        c.launches = 0
    built, build_trainer = {}, train_main.build_trainer

    def recording(args):        # the configs train_main builds from its flags, kept
        trainer = build_trainer(args)
        built.update(encoder=trainer.encoder_cfg, loss=trainer.loss_cfg,
                     train=trainer.train_cfg)
        return trainer

    train_main.build_trainer = recording
    t0 = time.perf_counter()
    try:
        with logged("qst_tpu_torch.cli.train") as records:
            if train_main.main(argv) != 0:
                fail(f"train_main --hard_contrastive_mode {mode} failed")
    finally:
        train_main.build_trainer = build_trainer
    import torch

    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    done = [r for r in records if r.msg.startswith("done:")]
    if not done:
        fail("train_main logged no summary")
    best, _, n_evals, steps_per_s, _ = done[0].args

    # what the run did, from its own files
    from qst_tpu_torch.data import ChunkStore

    n_inst = len(ChunkStore(small))
    steps = n_inst // 32
    n_val = min(max(1, int(n_inst * 0.1)), 1000)
    val_rows = min(n_val, 256)
    val_batches = -(-val_rows // 32)
    with open(f"{exp}/ir_eval_set.json") as f:
        ir_set = json.load(f)
    evals = [(-1, -1)] + [(0, s) for s in range(EVAL_STEPS, steps + 1, EVAL_STEPS)] + [(0, steps)]
    quad_rows = [(int(r[0]), int(r[1])) for r in read_csv(f"{exp}/quadruplet_results.csv")]
    ir_rows = read_csv(f"{exp}/ir_results.csv")
    with open(f"{exp}/val_quadruplet_loss_eval.json") as f:
        loss_log = json.load(f)
    with open(f"{exp}/train_loss.json") as f:
        train_losses = [e["loss"] for e in json.load(f)]
    if (quad_rows != evals or [(e["epoch"], e["steps"]) for e in loss_log] != evals
            or sorted({(int(r[0]), int(r[1])) for r in ir_rows}) != sorted(set(evals))
            or len(ir_rows) != len(evals) * 3 * 44 or n_evals != len(evals)):
        fail(f"train_main mode {mode}: evaluations {quad_rows}, want {evals}")
    if not (len(train_losses) == len(evals) - 2 and all(np.isfinite(train_losses))
            and all(np.isfinite(e["average_loss"]) for e in loss_log)):
        fail(f"train_main mode {mode}: losses {train_losses}, validation {loss_log}")

    # the launches each part accounts for: 6 layers a forward
    pool = len(ChunkStore(small).all_positive_captions())    # the miner's table
    miner = 6 * (batches_of(pool) + batches_of(val_rows) + val_batches + steps)
    per_eval = 6 * (batches_of(len(ir_set["queries"])) + batches_of(len(ir_set["corpus"]))
                    + batches_of(4 * val_rows) + val_batches)
    want = {"K1": 6 * steps + miner + len(evals) * per_eval, "K2": 6 * steps,
            "K3 forward": steps + len(evals) * val_batches, "K3 backward": steps,
            "K4": 0, "K5": 0, "K6": 0}
    log(f"train_main --hard_contrastive_mode {mode}: {steps} steps of MiniLM-L6 over {n_inst} "
        f"instances, {len(evals)} evaluations (IR {len(ir_set['queries'])} queries x "
        f"{len(ir_set['corpus'])} docs, 3 score functions, k up to 900: the plain scan; "
        f"quadruplet {val_rows}; validation loss {val_batches} batches) in {wall:.1f} s, "
        f"{steps_per_s:.2f} steps/s in the loop (evaluations included); best {best:.6f}; "
        f"train losses {['%.4f' % v for v in train_losses]}; launches {launches}; K1 = "
        f"steps {6 * steps} + miner {miner} + evaluators {len(evals) * per_eval}")
    if launches != want:
        fail(f"train_main mode {mode}: launches {launches}, want {want}")
    for n in ("K1", "K2"):
        report[n]["launches"] = report[n].get("launches", 0) + launches[n]
    report["K3"]["launches"] = (report["K3"].get("launches", 0) + launches["K3 forward"]
                                + launches["K3 backward"])
    return {"wall_s": wall, "steps_per_s": steps_per_s, "evaluations": len(evals),
            "miner_k1": miner, "steps_k1": 6 * steps, "evaluators_k1": len(evals) * per_eval,
            "configs": built}


def compare_evaluators(exp: str, small: str, tmp: str) -> dict:
    """The run's evaluators rebuilt (``train_main.build_trainer``: the same
    val batches, eval set and miner draws), each called on the run's final
    model through the kernels and through the plain versions; and the
    logged final validation loss recomputed apart from the evaluator."""
    import torch

    from qst_tpu_torch.cli import train_main
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
    from qst_tpu_torch.train.train_step import make_eval_loss_fn

    args = train_main.build_parser().parse_args([
        "--dataset_root", small, "--experiment_dir", f"{tmp}/recheck", "--use_fused_layer",
        "--use_fused_loss_kernel", "--hard_contrastive_mode", "1", "--use_ir_evaluator",
        "--seed", "14"])
    trainer = train_main.build_trainer(args)
    evaluators = dict(trainer.evaluator.evaluators)
    steps = len(trainer.dataset) // 32
    final = torch.load(f"{exp}/checkpoints/periodic/{steps}/state.pt", map_location="cuda",
                       weights_only=True)["model"]
    enc = SentenceEncoder(trainer.encoder_cfg, final, trainer.collator.tokenizer)
    out = {}
    for plain in (False, True):
        ctx = contextlib.ExitStack()
        if plain:
            ctx.enter_context(plain_kernels())
            ctx.enter_context(plain_search())
        with ctx:
            loss = -evaluators["loss"](enc.model)
            evaluators["quadruplet"](enc.encode)
            evaluators["ir"](enc.encode)
            torch.cuda.synchronize()
        out[plain] = (loss, dict(evaluators["quadruplet"].last_scores),
                      {f: dict(m) for f, m in evaluators["ir"].last_results.items()})
    # the logged value of the last evaluation against the same model, recomputed
    # here batch by batch through the kernels
    with open(f"{exp}/val_quadruplet_loss_eval.json") as f:
        logged_loss = json.load(f)[-1]["average_loss"]
    loss_fn = make_eval_loss_fn(trainer.encoder_cfg, trainer.loss_cfg)
    total = 0.0
    for batch in evaluators["loss"].batches:
        qb = evaluators["loss"].collator(batch)
        total += float(loss_fn(enc.model, qb.input_ids, qb.attention_mask))
    recomputed = total / len(evaluators["loss"].batches)
    (k_loss, k_quad, k_ir), (p_loss, p_quad, p_ir) = out[False], out[True]
    quad_err = max(abs(k_quad[n] - p_quad[n]) for n in k_quad)
    ir_err = max(abs(k_ir[f][m] - p_ir[f][m]) for f in k_ir for m in k_ir[f])
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    log(f"evaluators on the trained model, kernels against plain versions: validation loss "
        f"{k_loss:.6f} / {p_loss:.6f} (rel {loss_rel:.2e}, limit 2e-2); quadruplet "
        f"accuracies {k_quad} / {p_quad} (max diff {quad_err:.4f}, limit 0.005); IR "
        f"map@100 cos {k_ir['cos_sim']['map@100']:.4f} / {p_ir['cos_sim']['map@100']:.4f}, "
        f"max diff over 3 x 44 metrics {ir_err:.4f} (limit 0.005); the logged final "
        f"validation loss {logged_loss:.6f}, recomputed {recomputed:.6f}")
    if not (loss_rel <= 2e-2 and quad_err <= 0.005 and ir_err <= 0.005):
        fail("an evaluator through the kernels disagrees with its plain versions")
    if not abs(recomputed - logged_loss) <= 1e-6 * abs(logged_loss):
        fail(f"the logged validation loss {logged_loss} != recomputed {recomputed}")
    return {"loss_rel_err": loss_rel, "quadruplet_max_err": quad_err, "ir_max_err": ir_err}


def ir_eval_run(report: dict, big: str, exp, out_root: str, index: str,
                extra=()) -> dict:
    """``ir_eval_main`` on ``big`` for the baseline and, given ``exp``, the
    trained model (cos and dot, k up to 128) → its results.json; the K4 + K5
    (exact: one each a dot_score search) or K6 (ivf: one a search) launches
    held to the searches."""
    import torch

    from qst_tpu_torch.cli import ir_eval_main
    from qst_tpu_torch.ops import ivf as ops_ivf
    from qst_tpu_torch.ops import topk

    counters = {"K4": topk.bucket_maxima, "K5": topk.rescore_buckets,
                "K6": ops_ivf.ivf_cell_scores}
    for c in counters.values():
        c.launches = 0
    argv = ["--dataset_root", big, "--output_root", out_root, "--use_fused_layer",
            "--score_functions", "cos_sim", "dot_score", "--eval_index", index, *IR_GRID,
            *extra]
    if exp:
        argv += ["--model_path", exp]
    from qst_tpu_torch.retrieval.index import ExactIndex

    answers, search = [], ExactIndex.search

    def recording(self, queries, k=10, score="cos_sim", *a, **kw):    # the answers, kept
        s, i = search(self, queries, k, score, *a, **kw)
        answers.append((score, np.asarray(s)[:, :10].copy(), np.asarray(i)[:, :10].copy()))
        return s, i

    ExactIndex.search = recording
    t0 = time.perf_counter()
    try:
        if ir_eval_main.main(argv) != 0:
            fail(f"ir_eval_main --eval_index {index} failed")
    finally:
        ExactIndex.search = search
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    [out] = [d for d in os.listdir(out_root)]
    with open(f"{out_root}/{out}/results.json") as f:
        results = json.load(f)
    with open(f"{out_root}/{out}/ir_eval_set.json") as f:
        ir_set = json.load(f)
    models = ["baseline"] + (["trained"] if exp else [])
    searches = len(models) * (1 if index == "exact" else 2)   # dot only, or cos and dot
    want = ({"K4": searches, "K5": searches, "K6": 0} if index == "exact"
            else {"K4": 0, "K5": 0, "K6": searches})
    log(f"ir_eval_main --eval_index {index}: {len(ir_set['queries'])} queries x "
        f"{len(ir_set['corpus'])} docs, {' and '.join(models)}, cos and dot, k up to 128, "
        f"in {wall:.1f} s; map@100 "
        + ", ".join(f"{m} {f} {results[m]['metrics'][f]['map@100']:.4f}"
                    for m in results for f in results[m]['metrics'])
        + f"; launches {launches}")
    if launches != want or set(results) != set(models):
        fail(f"ir_eval_main {index}: launches {launches}, want {want}; results {set(results)}")
    for n in ("K4", "K5", "K6"):
        report[n]["launches"] = report[n].get("launches", 0) + launches[n]
    return {"results": results, "wall_s": wall, "eval_set": f"{out_root}/{out}/ir_eval_set.json",
            "answers": answers}


def plain_ir_trained(big_eval_set: str, exp: str) -> dict:
    """ir_eval_main's evaluation of the trained model again, on its eval
    set, through the plain versions (K1's, and the plain scan for K4 + K5)
    → the metrics."""
    from qst_tpu_torch.cli.common import load_best_params
    from qst_tpu_torch.core.config import EncoderConfig, IREvalConfig
    from qst_tpu_torch.evals import InformationRetrievalEvaluator, IREvaluationSet
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
    from qst_tpu_torch.models.tokenizer import HashTokenizer

    with open(big_eval_set) as f:
        ir_set = IREvaluationSet.from_json(json.load(f))
    cfg = EncoderConfig.minilm_l6(use_fused_layer=True)
    ev = InformationRetrievalEvaluator(
        ir_set.queries, ir_set.corpus, ir_set.relevant,
        cfg=IREvalConfig(accuracy_at_k=(1, 3, 5, 10), precision_recall_at_k=(1, 3, 5, 10),
                         mrr_at_k=(10,), ndcg_at_k=(10,), map_at_k=(100,),
                         score_functions=("cos_sim", "dot_score")))
    enc = SentenceEncoder(cfg, load_best_params(exp), HashTokenizer(cfg.vocab_size),
                          device="cuda")
    with plain_kernels(), plain_search():
        ev(enc.encode)
    return ev.last_results


def evaluation_times(big: str, exp: str) -> dict:
    """One full IR evaluation of the trained model over ``big`` as the
    evaluator runs it, timed by part (host clock, synchronised): the encode
    of queries and corpus, each score function's search (with the id lists)
    and the metrics on the host; at ir_eval_main's grid above (k up to 128,
    cos and dot) and at the default grid (k up to 900, three functions)."""
    import torch

    from qst_tpu_torch.cli.common import load_best_params
    from qst_tpu_torch.core.config import EncoderConfig, IREvalConfig
    from qst_tpu_torch.data import ChunkStore
    from qst_tpu_torch.evals import create_ir_evaluation_set, ir_metrics
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
    from qst_tpu_torch.models.tokenizer import HashTokenizer
    from qst_tpu_torch.retrieval.index import ExactIndex

    cfg = EncoderConfig.minilm_l6(use_fused_layer=True)
    enc = SentenceEncoder(cfg, load_best_params(exp), HashTokenizer(cfg.vocab_size),
                          device="cuda")
    ir_set = create_ir_evaluation_set(list(ChunkStore(big).iter_instances()))
    qids = [q for q in ir_set.queries if ir_set.relevant.get(q)]
    queries, cids = [ir_set.queries[q] for q in qids], list(ir_set.corpus)
    corpus = [ir_set.corpus[c] for c in cids]
    rel = [ir_set.relevant[q] for q in qids]
    enc.encode(queries, convert_to_numpy=False)            # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_emb = enc.encode(queries, convert_to_numpy=False)
    c_emb = enc.encode(corpus, convert_to_numpy=False)
    index = ExactIndex(c_emb, ids=cids)
    torch.cuda.synchronize()
    out = {"encode_s": time.perf_counter() - t0, "n_queries": len(queries),
           "n_docs": len(corpus)}
    # the host's share: tokenizing a quarter of the corpus alone
    sample = corpus[: len(corpus) // 4]
    t0 = time.perf_counter()
    for i in range(0, len(sample), 256):
        enc.tokenizer.batch_encode(sample[i:i + 256], max_length=cfg.max_seq_length)
    out["tokenize_per_1k_texts_s"] = (time.perf_counter() - t0) / len(sample) * 1e3
    grids = {"k<=128": (IREvalConfig(accuracy_at_k=(1, 3, 5, 10),
                                     precision_recall_at_k=(1, 3, 5, 10), mrr_at_k=(10,),
                                     ndcg_at_k=(10,), map_at_k=(100,),
                                     score_functions=("cos_sim", "dot_score"))),
             "default": IREvalConfig()}
    for name, grid in grids.items():
        k = max((*grid.accuracy_at_k, *grid.precision_recall_at_k, *grid.mrr_at_k,
                 *grid.ndcg_at_k, *grid.map_at_k))
        for fn in grid.score_functions:
            index.search_ids(q_emb, k=k, score=fn)          # warm
            t0 = time.perf_counter()
            _, ranked = index.search_ids(q_emb, k=k, score=fn)
            t1 = time.perf_counter()
            ir_metrics(ranked, rel, accuracy_at_k=grid.accuracy_at_k,
                       precision_recall_at_k=grid.precision_recall_at_k,
                       mrr_at_k=grid.mrr_at_k, ndcg_at_k=grid.ndcg_at_k,
                       map_at_k=grid.map_at_k)
            out[f"{name} {fn} search_s"] = t1 - t0
            out[f"{name} {fn} metrics_s"] = time.perf_counter() - t1
    log(f"one IR evaluation of the trained model, {len(queries)} queries x {len(corpus)} docs "
        f"(host clock, synchronised): encode {out['encode_s']:.3f} s (of it tokenization "
        f"{out['tokenize_per_1k_texts_s'] * (len(queries) + len(corpus)) / 1e3:.3f} s at "
        f"{out['tokenize_per_1k_texts_s']:.3f} s per 1,000 texts); "
        + "; ".join(f"{k} {v:.3f} s" for k, v in out.items() if k.endswith("search_s")
                    or k.endswith("metrics_s")))
    return out


def mining_times(small: str, big: str, tmp: str) -> dict:
    """The miner's cost: the EmbeddingTable's refresh (its whole pool through
    the frozen encoder) at the small and the big dataset's pool; train steps/s
    of train_main's trainer (no evaluator) with the miner and without it, in
    turns (mined, plain, plain, mined); the device's busy share over steps
    with and without the miner (torch.profiler: device time of the kernels
    over the window's wall time)."""
    import torch
    from torch.profiler import profile

    from qst_tpu_torch.cli import train_main
    from qst_tpu_torch.data import ChunkStore, EmbeddingTable, PrefetchIterator
    from qst_tpu_torch.train import dropout_key

    args = train_main.build_parser().parse_args([
        "--dataset_root", small, "--experiment_dir", f"{tmp}/timing", "--use_fused_layer",
        "--use_fused_loss_kernel", "--hard_contrastive_mode", "1", "--epochs", "1",
        "--evaluation_steps", "0", "--checkpoint_save_steps", "0", "--no-save_best_model",
        "--seed", "14"])
    trainer = train_main.build_trainer(args)
    trainer.evaluator = None
    miner = trainer.dataset.miner
    out = {}
    for name, captions in (("small", miner.table.captions),
                           ("big", ChunkStore(big).all_positive_captions())):
        table = EmbeddingTable(captions, miner.encode_fn)
        if name == "small":
            table.refresh(0)                  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table.refresh(0)
        torch.cuda.synchronize()
        out[f"refresh_{name}_s"] = time.perf_counter() - t0
        out[f"pool_{name}"] = len(captions)
    # how many candidates the threshold leaves (cos <= 0.2 to the anchor):
    # with no valid candidate both modes take the sub-pool's first, as in
    # qst_tpu
    refs = [inst["reference"] for _, inst in zip(range(256), ChunkStore(small).iter_instances())]
    a = torch.nn.functional.normalize(miner.encode_fn(refs, convert_to_numpy=False).float(), dim=1)
    t = torch.nn.functional.normalize(miner.table.embeddings.float(), dim=1)
    cos = a @ t.T
    out["valid_share"] = (cos <= miner.threshold).float().mean().item()
    out["cos_min"] = cos.min().item()
    rates = {"mined": [], "plain": []}
    for name in ("mined", "plain", "plain", "mined"):
        trainer.dataset.miner = miner if name == "mined" else None
        rates[name].append(trainer.train().steps_per_sec)
    out["steps_per_s"] = rates

    # busy share over 20 steps after 5, the batches sampled (and mined) on
    # the prefetch thread as in Trainer.train
    from qst_tpu_torch.train import create_train_state, make_train_step

    busy, dev = {}, torch.device("cuda")
    for name in ("mined", "plain"):
        trainer.dataset.miner = miner if name == "mined" else None
        state, _ = create_train_state(trainer.encoder_cfg, trainer.train_cfg,
                                      torch.Generator().manual_seed(14), 100, trainer.loss_cfg,
                                      device=dev)
        step = make_train_step(trainer.encoder_cfg, trainer.loss_cfg)
        batches = PrefetchIterator(trainer.dataset.iter_batches(32, epoch=0),
                                   transform=trainer.collator, depth=2)
        for i in range(5):
            qb = next(batches)
            state, _ = step(state, qb.input_ids, qb.attention_mask, dropout_key(14, i + 1))
        torch.cuda.synchronize()
        with profile(activities=device_activity()) as prof:
            t0 = time.perf_counter()
            for i in range(5, 25):
                qb = next(batches)
                state, _ = step(state, qb.input_ids, qb.attention_mask, dropout_key(14, i + 1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        for _ in batches:        # the rest of the epoch: the thread ends here
            pass
        dev_ms = sum(device_us(e) for e in prof.key_averages()
                     if e.device_type.name == "CUDA"
                     and not getattr(e, "is_user_annotation", False)
                     and not e.key.startswith("Optimizer.")) / 1e3
        busy[name] = {"wall_ms_per_step": wall * 1e3 / 20, "device_ms_per_step": dev_ms / 20,
                      "busy": dev_ms / (wall * 1e3)}
    out["busy"] = busy
    log(f"mining: EmbeddingTable refresh {out['refresh_small_s']:.3f} s over a pool of "
        f"{out['pool_small']} captions, {out['refresh_big_s']:.3f} s over {out['pool_big']}; "
        f"candidates with cos <= {miner.threshold} to 256 anchors: {100 * out['valid_share']:.2f}% "
        f"(least cos {out['cos_min']:.3f}); "
        f"train_main's trainer without evaluator, steps/s mined {rates['mined']} against "
        f"no miner {rates['plain']}; over 20 steps: "
        + "; ".join(f"{n} {b['wall_ms_per_step']:.2f} ms a step, device "
                    f"{b['device_ms_per_step']:.2f} ms, busy {100 * b['busy']:.1f}%"
                    for n, b in busy.items()))
    return out


def config_reload(report: dict, exp: str, built: dict, exact: dict) -> dict:
    """The trained experiment reloaded from its config, as a user reloads
    it: ``load_config`` of the run's ``experiment_config.json`` (its encoder,
    loss and train configs equal to those train_main built from its flags,
    every other section the default; the same hash twice), the default
    ``MeshConfig``'s shape for the cards given to ``make_mesh``, and a
    ``SentenceEncoder`` of the loaded encoder config and the best weights
    (``load_best_params``) on that mesh encoding ir_eval_main's 1,000 queries
    and 66,200 docs into an ``ExactIndex`` (K1 6 a batch; K4 + K5 once each
    a dot search, the corpus above ``PALLAS_MIN_DOCS``): its top-10 equal to
    ir_eval_main's trained dot search up to ties. The launches by wrapper
    over the whole path, and by kernel name in a profiled encode batch and
    search."""
    import torch

    from qst_tpu_torch.cli.common import load_best_params
    from qst_tpu_torch.core import (DataConfig, IREvalConfig, MeshConfig, config_hash,
                                    load_config, make_mesh)
    from qst_tpu_torch.core.config import DEFAULT_GAMMA
    from qst_tpu_torch.evals import IREvaluationSet
    from qst_tpu_torch.models import HashTokenizer, SentenceEncoder
    from qst_tpu_torch.retrieval import ExactIndex

    t0 = time.perf_counter()
    path = f"{exp}/experiment_config.json"
    cfg = load_config(path)
    flags = (cfg.encoder.use_fused_layer, cfg.loss.use_fused_kernel, cfg.loss.gamma,
             cfg.loss.margin_pos_neg, cfg.loss.margin_pos_part, cfg.loss.margin_part_neg,
             cfg.train.scheduler, cfg.train.warmup_steps, cfg.train.learning_rate,
             cfg.train.evaluation_steps)
    equal = {"encoder": cfg.encoder == built["encoder"], "loss": cfg.loss == built["loss"],
             "train": cfg.train == built["train"],
             "defaults": (cfg.data, cfg.ir_eval, cfg.mesh) == (DataConfig(), IREvalConfig(),
                                                               MeshConfig()),
             "flags": flags == (True, True, DEFAULT_GAMMA, 1.0, 0.5, 0.5, "warmuplinear", 5,
                                5e-5, EVAL_STEPS),
             "hash": config_hash(cfg) == config_hash(load_config(path))}
    shape = cfg.mesh.shape(torch.cuda.device_count())
    mesh = make_mesh(*shape)
    with open(exact["eval_set"]) as f:
        ir_set = IREvaluationSet.from_json(json.load(f))
    queries = [ir_set.queries[q] for q in ir_set.queries if ir_set.relevant.get(q)]
    cids = list(ir_set.corpus)
    corpus = [ir_set.corpus[c] for c in cids]
    enc = SentenceEncoder(cfg.encoder, load_best_params(exp),
                          HashTokenizer(cfg.encoder.vocab_size), mesh=mesh)
    reset_counts()
    q_emb = enc.encode(queries, convert_to_numpy=False)
    c_emb = enc.encode(corpus, convert_to_numpy=False)
    index = ExactIndex(c_emb, ids=cids, mesh=mesh)
    s, i = index.search(q_emb, k=10, score="dot_score")
    torch.cuda.synchronize()
    launches = {n: c for n, c in read_counts().items() if n in ("K1", "K4", "K5", "K6")}
    # one card: a 1 x 1 mesh, which runs the unsharded paths; on more, K1
    # runs once a layer and data shard, K4 and K5 once a shard
    n_data, n_shards = shape[0], shape[0] * shape[1]
    want = {"K1": 6 * n_data * (batches_of(len(queries)) + batches_of(len(corpus))),
            "K4": n_shards, "K5": n_shards, "K6": 0}
    wall = time.perf_counter() - t0
    [(_, s_ref, i_ref)] = [r for r in exact["answers"] if r[0] == "dot_score"][-1:]
    rows = np.unique(np.concatenate([i.ravel(), i_ref.ravel()]))
    true = np.full((len(queries), len(corpus)), -np.inf, np.float32)
    true[:, rows] = (q_emb.float() @ c_emb[torch.from_numpy(rows).cuda()].float().T).cpu().numpy()
    ids_equal = ids_match_up_to_ties(s, i, s_ref, i_ref, true, 1e-4)

    ids, mask = enc.tokenizer.batch_encode(corpus[:256], max_length=cfg.encoder.max_seq_length)
    ids = torch.from_numpy(ids.astype(np.int64)).cuda()
    mask = torch.from_numpy(mask.astype(np.int64)).cuda()
    k1_names = kernel_counts(lambda: enc.encode_ids(ids, mask),
                             done=lambda c: by_mark(c, "::attention_mma_kernel") >= 6 * n_data)
    search_names = kernel_counts(lambda: index.search(q_emb, k=10, score="dot_score"),
                                 done=lambda c: by_mark(c, "bucket_max") >= n_shards
                                 and by_mark(c, "rescore_") >= n_shards)
    by_name = {"K1 (::attention_mma_kernel) a batch": by_mark(k1_names, "::attention_mma_kernel"),
               "K4 (bucket_max) a search": by_mark(search_names, "bucket_max"),
               "K5 (rescore_) a search": by_mark(search_names, "rescore_")}
    out = {"equal": equal, "ids_equal_up_to_ties": ids_equal, "mesh": list(shape),
           "launches": launches, "launches_want": want, "by_name": by_name,
           "queries": len(queries), "docs": len(corpus), "wall_s": wall,
           "with_profiles_s": time.perf_counter() - t0}
    log("config_reload: " + json.dumps(out))
    if not all(equal.values()):
        fail(f"the reloaded experiment config differs from train_main's: {equal}")
    if not ids_equal:
        fail("the reloaded encoder's top-10 differ from ir_eval_main's trained run")
    if launches != want or list(by_name.values()) != [6 * n_data, n_shards, n_shards]:
        fail(f"config reload: launches {launches}, want {want}; by name {by_name}")
    for n in ("K1", "K4", "K5"):
        report[n]["launches"] = report[n].get("launches", 0) + launches[n]
    return out


def evaluate(report: dict) -> None:
    """Training with validation and negative mining, and IR evaluation, from
    the command line: a synthetic dataset of 11,200 instances (66,200 IR
    docs from 1,000 queries) and its first 960 instances; train_main on the
    960 in modes 1 and -1 with every evaluator each 15 steps; the
    evaluators against their plain versions on the trained model;
    ir_eval_main over the 11,200 through the exact index (K4 + K5 in the
    dot searches) for baseline and trained, and the IVF index (K6) for the
    baseline; the trained model's evaluation again through the plain
    versions; then the times of one evaluation and of the miner."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        big, small = quadruplet_set(11200, 21), f"{tmp}/small"
        write_quadruplet_chunks(small, 960, seed=21)      # the first 960 of the same draws
        runs = {mode: train_main_run(report, small, f"{tmp}/exp{mode}", mode)
                for mode in ("1", "-1")}
        parity = compare_evaluators(f"{tmp}/exp1", small, tmp)
        exact = ir_eval_run(report, big, f"{tmp}/exp1", f"{tmp}/ir_exact", "exact")
        ivf_run = ir_eval_run(report, big, None, f"{tmp}/ir_ivf", "ivf")
        reload = config_reload(report, f"{tmp}/exp1", runs["1"].pop("configs"), exact)
        runs["-1"].pop("configs")
        t0 = time.perf_counter()
        plain = plain_ir_trained(exact["eval_set"], f"{tmp}/exp1")
        plain_s = time.perf_counter() - t0
        kern = exact["results"]["trained"]["metrics"]
        err = max(abs(kern[f][k] - plain[f][k]) for f in kern for k in kern[f])
        recall = (ivf_run["results"]["baseline"]["metrics"]["dot_score"]["recall@10"]
                  - exact["results"]["baseline"]["metrics"]["dot_score"]["recall@10"])
        log(f"ir_eval_main's evaluation of the trained model through the kernels against the "
            f"plain versions ({plain_s:.1f} s; cos and dot, {len(kern['cos_sim'])} metrics "
            f"each): max diff {err:.4f} (limit 0.005); IVF recall@10 minus exact (baseline, "
            f"n_probe 8 of 256 cells): {recall:.4f}")
        if not err <= 0.005:
            fail("ir_eval_main's metrics through the kernels disagree with the plain versions")
        report["evaluate"] = {
            "train_main": runs, "evaluators_vs_plain": dict(parity, ir_eval_main_max_err=err),
            "ir_eval_main_s": {"exact": exact["wall_s"], "ivf_baseline": ivf_run["wall_s"],
                               "plain_trained": plain_s},
            "config_reload": reload,
            "evaluation_times": evaluation_times(big, f"{tmp}/exp1"),
            "mining": mining_times(small, big, tmp)}


_WORK: dict = {}          # one scratch directory for the phases of a run


def work_dir(name: str) -> str:
    """A directory of this run's scratch tree (removed when the run ends)."""
    import tempfile

    if "tree" not in _WORK:
        _WORK["tree"] = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    path = os.path.join(_WORK["tree"].name, name)
    os.makedirs(path, exist_ok=True)
    return path


DATASET_IMAGES = 2000     # the ablation's recipe: five captions an image, chunks of 500
DATASET_CHUNKS = DATASET_IMAGES // 500


def dataset(report: dict) -> None:
    """dataset_main as a user calls it on the card: MiniLM-L6 (random init,
    its nn.Module path, as the JAX CLI leaves the fused flag off) mining the
    positives of 2,000 synthetic images (10,000 captions) at cos >= 0.6,
    adaptive-crop partial positives, chunks of 500 and the verbose check;
    then the four chunks and the metadata read back through
    QuadrupletDataset, wall time, images/s, encode calls and the share of
    the time spent in the encoder."""
    from qst_tpu_torch.cli import dataset_main
    from qst_tpu_torch.data import QuadrupletDataset
    from qst_tpu_torch.data.chunks import discover_chunks, read_meta
    from qst_tpu_torch.experiments.ablation import make_coco_annotations
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder

    tmp = work_dir("dataset")
    ann = f"{tmp}/captions.json"
    make_coco_annotations(ann, DATASET_IMAGES, np.random.default_rng(14))
    with open(ann) as f:
        captions = {}
        for a in json.load(f)["annotations"]:
            captions.setdefault(a["image_id"], set()).add(a["caption"])
    encode, spent = SentenceEncoder.encode, {"calls": 0, "s": 0.0}

    def timed_encode(self, texts, *a, **kw):         # host numpy out: synchronised
        t0 = time.perf_counter()
        out = encode(self, texts, *a, **kw)
        spent["s"] += time.perf_counter() - t0
        spent["calls"] += 1
        return out

    SentenceEncoder.encode = timed_encode
    try:
        with logged("qst_tpu_torch.cli.dataset") as records:
            t0 = time.perf_counter()
            code = dataset_main.main(["--ann_file", ann, "--output_root", f"{tmp}/out",
                                      "--chunk_dim", "500", "--part_pos_algorithm",
                                      "adaptive_crop", "--verbose_check"])
            wall = time.perf_counter() - t0
    finally:
        SentenceEncoder.encode = encode
    root = f"{tmp}/out/CoCoCaptionDataset"
    ds = QuadrupletDataset(root, seed=14)
    insts = list(ds.store.iter_instances())
    first_try = np.mean([set(i["positive"]) <= captions[i["id"]] for i in insts])
    checked = [r.getMessage() for r in records if r.getMessage().startswith("cache stats")]
    log(f"dataset_main: {DATASET_IMAGES} images ({sum(map(len, captions.values()))} captions), "
        f"MiniLM-L6 on the card, in {wall:.1f} s = {DATASET_IMAGES / wall:.1f} images/s; "
        f"{spent['calls']} encode calls, {spent['s']:.1f} s in the encoder "
        f"({100 * spent['s'] / wall:.1f}% of the wall); chunks {discover_chunks(root)}, "
        f"metadata {read_meta(root)}, {len(ds)} instances; positives from the image's own "
        f"captions (the first-try branch) for {100 * first_try:.1f}%; {checked}")
    if (code != 0 or read_meta(root) != DATASET_CHUNKS
            or discover_chunks(root) != list(range(DATASET_CHUNKS))
            or len(ds) != DATASET_IMAGES or not checked
            or any(len(i["positive"]) != 4 or len(i["part_positive"]) != 8 for i in insts)):
        fail(f"dataset_main did not write the expected {DATASET_CHUNKS} chunks")
    report["dataset"] = {"wall_s": wall, "images_per_s": DATASET_IMAGES / wall,
                         "encode_calls": spent["calls"], "encoder_s": spent["s"],
                         "encoder_share": spent["s"] / wall, "first_try_share": first_try,
                         "root": root}


COUNTED = ("K1", "K2", "K3 forward", "K3 backward")


def train_counters():
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import quadruplet as qd

    return (fl.fused_bert_layer, fl.fused_bert_layer_bwd, qd.fused_gamma_quadruplet_loss_fwd,
            qd.fused_gamma_quadruplet_loss_bwd)


def add_train_launches(report: dict, launches) -> None:
    """Add K1, K2 and K3 (forward + backward) launches to the kernel rows."""
    for name, n in (("K1", launches[0]), ("K2", launches[1]),
                    ("K3", launches[2] + launches[3])):
        report[name]["launches"] = report[name].get("launches", 0) + n


def window(run, steps: int) -> dict:
    """Wall time (host clock, synchronised) and device time (torch.profiler's
    kernels) of ``run()``, per step, the device's busy share, and each
    kernel's (launches, device ms) over the run."""
    import torch
    from torch.profiler import profile

    with profile(activities=device_activity()) as prof:
        lead_in()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {e.key: (e.count, device_us(e) / 1e3)
               for e in prof.key_averages() if is_kernel(e)}
    dev_ms = sum(ms for _, ms in kernels.values())
    return {"wall_ms_per_step": wall * 1e3 / steps, "device_ms_per_step": dev_ms / steps,
            "busy": dev_ms / (wall * 1e3), "kernels": kernels}


def capture(report: dict) -> None:
    """The captured train step on the dataset phase's chunks, at the training
    configuration (MiniLM-L6, fused layer and loss, batch 32 quadruplets,
    S = 128): K = 4 steps a call, two calls (the first runs its steps
    eagerly and captures, the second replays) against eight eager steps from
    the same state — losses, parameters and Adam moments bit for bit — at
    dropout 0.1, at dropout 0 and with accumulation 2, and K1 / K2 / K3
    launches exactly the steps'. Then train_main at --steps_per_call 1 and
    4, with the miner and without, over 1,000 instances (31
    steps): steps/s, the final weights of the two equal bit for bit (the
    capture runs while the miner's thread encodes), and over 20 steps the
    wall and device time a step and the busy share."""
    import dataclasses
    import shutil

    import torch

    from qst_tpu_torch.cli import train_main
    from qst_tpu_torch.data import PrefetchIterator, QuadrupletCollator, QuadrupletDataset
    from qst_tpu_torch.data import write_meta
    from qst_tpu_torch.models.tokenizer import HashTokenizer
    from qst_tpu_torch.train import (create_train_state, dropout_key, make_multi_step,
                                     make_train_step)

    if "dataset" not in report:
        dataset(report)
    root = report["dataset"]["root"]
    enc_cfg, loss_cfg, base = train_config()
    dev, K = torch.device("cuda"), 4
    ds = QuadrupletDataset(root, seed=14)
    collator = QuadrupletCollator(HashTokenizer(vocab_size=enc_cfg.vocab_size),
                                  max_length=enc_cfg.max_seq_length)
    batches = [collator(ds.sample_batch(range(32 * i, 32 * (i + 1)), step=i))
               for i in range(2 * K)]
    ids = np.stack([b.input_ids for b in batches])
    mask = np.stack([b.attention_mask for b in batches])
    keys = torch.stack([dropout_key(14, s) for s in range(1, 2 * K + 1)])
    counters = train_counters()
    out = {"bit_for_bit": {}}
    for label, rate, accum in (("dropout 0.1", 0.1, 1), ("dropout 0", 0.0, 1),
                               ("dropout 0.1, accumulation 2", 0.1, 2)):
        cfg = dataclasses.replace(enc_cfg, hidden_dropout=rate, attention_dropout=rate)
        tcfg = dataclasses.replace(base, learning_rate=1e-4, warmup_steps=2,
                                   gradient_accumulation_steps=accum)
        graph_st, eager_st = (create_train_state(cfg, tcfg, torch.Generator().manual_seed(14),
                                                 100, loss_cfg, device=dev)[0]
                              for _ in range(2))
        multi = make_multi_step(cfg, loss_cfg, None, K)
        graph_losses, launches = [], []
        for call in range(2):
            before = [c.launches for c in counters]
            part = slice(call * K, (call + 1) * K)
            graph_st, losses = multi(graph_st, ids[part], mask[part], keys[part])
            torch.cuda.synchronize()
            launches.append([c.launches - b for c, b in zip(counters, before)])
            graph_losses.append(losses)
        if multi._graph is None:
            fail(f"{label}: no graph was captured")
        step = make_train_step(cfg, loss_cfg)
        eager_losses = []
        before = [c.launches for c in counters]
        for j in range(2 * K):
            eager_st, loss = step(eager_st, ids[j], mask[j], keys[j])
            eager_losses.append(loss)
        torch.cuda.synchronize()
        eager_launches = [c.launches - b for c, b in zip(counters, before)]
        graph_losses, eager_losses = torch.cat(graph_losses), torch.stack(eager_losses)
        tensors = list(zip(graph_st.optimizer.state_tensors(), eager_st.optimizer.state_tensors()))
        unequal = [(a - b).abs().max().item() for a, b in tensors if not torch.equal(a, b)]
        want = [6 * K, 6 * K, K, K]
        log(f"captured steps ({label}, MiniLM-L6, batch 32, S=128): 2 calls of {K} (eager + "
            f"capture, then one replay) against {2 * K} eager steps: losses "
            f"{'bit-equal' if torch.equal(graph_losses, eager_losses) else 'DIFFER'} "
            f"({['%.5f' % v for v in graph_losses.tolist()]}), {len(tensors) - len(unequal)} of "
            f"{len(tensors)} parameter and optimizer-state tensors bit-equal (largest "
            f"difference {max(unequal, default=0.0):.3e}); launches a call {launches} (want "
            f"{want}: {', '.join(COUNTED)})")
        if not torch.equal(graph_losses, eager_losses) or unequal:
            fail(f"{label}: the captured steps differ from the eager ones")
        if launches != [want, want]:
            fail(f"{label}: launches {launches} across the replay, want {want} a call")
        if eager_launches != [2 * n for n in want]:
            fail(f"{label}: the {2 * K} eager steps launched {eager_launches}, want "
                 f"{[2 * n for n in want]}")
        add_train_launches(report, [sum(c) for c in zip(*launches)])
        add_train_launches(report, eager_launches)
        out["bit_for_bit"][label] = {"losses": graph_losses.tolist(), "tensors": len(tensors)}
        del graph_st, eager_st, multi

    # train_main over the first two chunks (1,000 instances: 31 steps)
    small = work_dir("capture_small")
    for c in (0, 1):
        shutil.copy(f"{root}/chunk_{c}.json", small)
    write_meta(small, 2)

    def trainer_for(K_call: int, mined: bool, name: str):
        args = train_main.build_parser().parse_args([
            "--dataset_root", small, "--experiment_dir", work_dir(f"capture_{name}"),
            "--use_fused_layer", "--use_fused_loss_kernel", "--hard_contrastive_mode", "1",
            "--epochs", "1", "--evaluation_steps", "0", "--checkpoint_save_steps", "0",
            "--no-save_best_model", "--seed", "14", "--steps_per_call", str(K_call)])
        trainer = train_main.build_trainer(args)
        trainer.evaluator = None
        if not mined:
            trainer.dataset.miner = None
        return trainer

    rates, finals = {}, {}
    for mined in (True, False):
        for K_call in (1, K):
            name = f"{'mined' if mined else 'plain'} K={K_call}"
            before = [c.launches for c in counters]
            result = trainer_for(K_call, mined, name.replace(" ", "_")).train()
            rates.setdefault(name, []).append(result.steps_per_sec)
            finals.setdefault(name, {n: t.detach().clone() for n, t in
                                     result.state.model.state_dict().items()})
            add_train_launches(report, [c.launches - b for c, b in zip(counters, before)])
    same = {m: all(torch.equal(finals[f"{m} K=1"][n], t) for n, t in finals[f"{m} K={K}"].items())
            for m in ("mined", "plain")}
    log(f"train_main, 31 steps at --steps_per_call 1 and {K} (steps/s in the loop, "
        f"the {K}-step runs' first call eager + capture): {rates}; final weights of the "
        f"{K}-step run equal the 1-step run's bit for bit: {same}")
    if not all(same.values()):
        fail("train_main at --steps_per_call 4 ends with other weights than at 1")

    # 20 steps after warm-up, the batches sampled (and mined) on the
    # prefetch thread as in Trainer.train
    busy = {}
    for mined in (True, False):
        trainer = trainer_for(1, mined, "busy")
        for K_call in (1, K):
            state, _ = create_train_state(trainer.encoder_cfg, trainer.train_cfg,
                                          torch.Generator().manual_seed(14), 100,
                                          trainer.loss_cfg, device=dev)
            batches = iter(PrefetchIterator(trainer.dataset.iter_batches(32, epoch=0),
                                            transform=trainer.collator, depth=2 * K_call))
            before = [c.launches for c in counters]
            step_no = [0]
            if K_call == 1:
                step = make_train_step(trainer.encoder_cfg, trainer.loss_cfg)

                def run(n):
                    for _ in range(n):
                        qb = next(batches)
                        step_no[0] += 1
                        step(state, qb.input_ids, qb.attention_mask, dropout_key(14, step_no[0]))
                warm = 5
            else:
                multi = make_multi_step(trainer.encoder_cfg, trainer.loss_cfg, None, K_call)

                def run(n):
                    for _ in range(n // K_call):
                        qbs = [next(batches) for _ in range(K_call)]
                        ks = torch.stack([dropout_key(14, step_no[0] + 1 + j)
                                          for j in range(K_call)])
                        step_no[0] += K_call
                        multi(state, np.stack([b.input_ids for b in qbs]),
                              np.stack([b.attention_mask for b in qbs]), ks)
                warm = 2 * K_call
            run(warm)
            torch.cuda.synchronize()
            w = window(lambda: run(20), 20)
            if w["device_ms_per_step"] == 0.0:
                fail(f"the profiler saw no kernel of the K={K_call} steps")
            for _ in batches:            # the rest of the epoch: the thread ends here
                pass
            add_train_launches(report, [c.launches - b for c, b in zip(counters, before)])
            busy[f"{'mined' if mined else 'plain'} K={K_call}"] = {
                k: w[k] for k in ("wall_ms_per_step", "device_ms_per_step", "busy")}
            del state
    log("captured against eager, 20 steps of train_main's trainer after warm-up: " + "; ".join(
        f"{n}: {b['wall_ms_per_step']:.2f} ms a step ({1e3 / b['wall_ms_per_step']:.1f} "
        f"steps/s), device {b['device_ms_per_step']:.2f} ms, busy {100 * b['busy']:.1f}%"
        for n, b in busy.items()))
    out.update(train_main_steps_per_s=rates, busy=busy)
    report["capture"] = out


ABLATION_STEPS = 500      # the JAX script's default; --ablation_steps 2000: the decisive run


def ablation(report: dict) -> None:
    """The port's quadruplet-vs-triplet ablation at the JAX package's
    decisive configuration (WordPiece from the corpus, MiniLM-L6 through the
    fused layer with in-kernel dropout, the γ arm's loss through K3, hard
    mining on the topic hash embedder), four steps a call, for
    ``ABLATION_STEPS`` an arm (``--ablation_steps``; the decisive run is
    2,000); the RESULTS.md table with the JAX run's rows beside it, the
    quality bars held (below 2,000 steps the ordering bars only), K2 and K3
    launches exactly the steps'."""
    import tempfile

    from qst_tpu_torch.experiments import ablation as abl

    counters = train_counters()
    args = abl.build_parser().parse_args([
        "--steps", str(ABLATION_STEPS), "--wordpiece", "--use_fused_layer",
        "--preset", "minilm_l6", "--steps_per_call", "4"])
    before = [c.launches for c in counters]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        out = abl.run(args, work)
    wall = time.perf_counter() - t0
    launches = [c.launches - b for c, b in zip(counters, before)]
    steps = out["steps_per_arm"]
    total = steps["quadruplet"] + steps["triplet"]
    log(f"ablation ({ABLATION_STEPS} steps an arm, MiniLM-L6, WordPiece, fused layer, K3 in "
        f"the γ arm, 4 steps a call): {wall:.1f} s, of it {out['seconds']}; steps/s in the "
        f"loop {out['steps_per_sec']}; launches K1 {launches[0]} (training {6 * total}, "
        f"evaluation the rest), K2 {launches[1]}, K3 {launches[2:]}\n"
        + abl.markdown_table(out["results"]))
    if launches[1] != 6 * total or launches[2:] != [steps["quadruplet"]] * 2 \
            or launches[0] < 6 * total:
        fail(f"ablation launches {launches} for {steps} steps")
    failed = abl.quality_bars(out["results"], ordering_only=ABLATION_STEPS < 2000)
    if failed:
        fail("the ablation's quality bars: " + "; ".join(failed))
    add_train_launches(report, launches)
    report["ablation"] = {"wall_s": wall, "seconds": out["seconds"],
                          "steps_per_sec": out["steps_per_sec"], "steps_per_arm": steps,
                          "table": {k: abl.table_row(v) for k, v in out["results"].items()},
                          "sweep": ablation_sweep(abl)}


SWEEP_STEPS = 64           # the sweep's check at reduced depth (the decisive sweep: 2,000)
SWEEP_IMAGES = 1000


def ablation_sweep(abl) -> dict:
    """``--gammas 0.3,0.6`` (the JAX script's sweep mode) at ``SWEEP_STEPS``
    an arm on the fused path, four steps a call, beside the default mode at
    the same arguments: the cell γ = 0.6 / 1.0:0.5:0.5 is the default
    mode's quadruplet arm and the triplet arms are one another, bit for bit
    (weights and metrics); the sweep table."""
    import tempfile

    import torch

    small = ["--steps", str(SWEEP_STEPS), "--n_images", str(SWEEP_IMAGES), "--n_eval", "200",
             "--wordpiece", "--use_fused_layer", "--preset", "minilm_l6", "--steps_per_call", "4"]
    t0 = time.perf_counter()
    outs = {}
    for mode, extra in (("sweep", ["--gammas", "0.3,0.6"]), ("default", [])):
        with tempfile.TemporaryDirectory() as work:
            outs[mode] = abl.run(abl.build_parser().parse_args(small + extra), work)
    wall = time.perf_counter() - t0
    sweep, default = outs["sweep"], outs["default"]
    cell = "gamma=0.6 margins=1.0/0.5/0.5"
    same = {}
    for mine, theirs in ((cell, "quadruplet"), ("triplet", "triplet")):
        a, b = sweep["arms"][mine], default["arms"][theirs]
        same[mine] = (a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
                      and sweep["results"][mine] == default["results"][theirs])
    log(f"ablation sweep (--gammas 0.3,0.6, {SWEEP_STEPS} steps an arm, {SWEEP_IMAGES} images, "
        f"fused, 4 steps a call): {wall:.1f} s with the default mode beside it; the cell {cell} "
        f"is the default mode's quadruplet arm bit for bit {same[cell]}, the triplet arms "
        f"{same['triplet']}\n" + abl.sweep_table(sweep["results"]))
    if not all(same.values()):
        fail(f"ablation sweep: arms differ from the default mode's: {same}")
    return {"wall_s": wall, "bit_equal": same, "steps_per_arm": sweep["steps_per_arm"],
            "results": sweep["results"]}


def times(report: dict) -> None:
    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule, embed_fn, init_params
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import quadruplet as qd
    from qst_tpu_torch.ops import topk
    from qst_tpu_torch.retrieval.index import exact_topk

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    # K1: one MiniLM layer at B=256, S=128, bf16
    B, S, H, F = 256, 128, 384, 1536
    w = random_layer(H, F, torch.bfloat16, gen, dev)
    # the QKV operands cached, as layer_weights_from_module holds them on
    # the encode path
    w.update(wqkv=torch.cat([w["wq"], w["wk"], w["wv"]], 1),
             bqkv=torch.cat([w["bq"], w["bk"], w["bv"]], 1))
    x = torch.randn((B, S, H), generator=gen).to(dev, torch.bfloat16)
    bias = torch.zeros((B, S), device=dev)
    report["K1"]["ms"] = cuda_ms(lambda: fl.fused_bert_layer(x, bias, w, num_heads=12), 20)
    report["K1"]["plain_ms"] = cuda_ms(
        lambda: fl.fused_bert_layer_plain(x, bias, w, num_heads=12), 5)
    # bounds: the layer's products (QKV, out, FFN: 2·M·(4H² + 2HF); attention:
    # 2 products of 2·B·S²·H) against x in, y out and the weights once
    M = B * S
    layer_ops = 2.0 * M * (4 * H * H + 2 * H * F) + 4.0 * B * S * S * H
    weight_bytes = 2 * (4 * H * H + 2 * H * F) + 4 * (9 * H + F)
    report["K1"].update(bound(2 * M * H * 2 + weight_bytes + B * S * 4, layer_ops, "bfloat16"))

    # the training path's layer: B = 4 x 32 = 128, S = 128, bf16, dropout
    # 0.1 — K1 with and without dropout, K2 against its plain version
    xt = x[:128].contiguous()
    bt = bias[:128].contiguous()
    gt = torch.randn((128, S, H), generator=gen).to(dev, torch.bfloat16)
    drop = dict(num_heads=12, attn_dropout=0.1, hidden_dropout=0.1, nb=8,
                seed=torch.tensor([5], dtype=torch.int32, device=dev))
    report["K1"]["train_ms"] = cuda_ms(lambda: fl.fused_bert_layer(xt, bt, w, **drop), 20)
    report["K1"]["train_no_dropout_ms"] = cuda_ms(
        lambda: fl.fused_bert_layer(xt, bt, w, num_heads=12), 20)
    report["K2"]["ms"] = cuda_ms(lambda: fl.fused_bert_layer_bwd(xt, bt, w, gt, **drop), 10)
    report["K2"]["plain_ms"] = cuda_ms(
        lambda: fl.fused_bert_layer_bwd_plain(xt, bt, w, gt, **drop), 3)
    # the backward from x alone: the forward's products once more (remat),
    # then dX and dW of each (2x), and 4 attention products beside the
    # forward's 2; x and dy in, dx out, weights in, 16 f32 gradients out
    Mt = 128 * S
    k2_ops = 3 * 2.0 * Mt * (4 * H * H + 2 * H * F) + 6 * 2.0 * 128 * S * S * H
    grad_bytes = 4 * (4 * H * H + 2 * H * F + 9 * H + F)
    report["K2"].update(bound(3 * Mt * H * 2 + weight_bytes + grad_bytes, k2_ops, "bfloat16"))
    # where K1's and K2's device time goes, by piece
    for name, fn in (("K1", lambda: fl.fused_bert_layer(x, bias, w, num_heads=12)),
                     ("K2", lambda: fl.fused_bert_layer_bwd(xt, bt, w, gt, **drop))):
        k = device_ms(fn, 10)
        report[name]["pieces_ms"] = layer_pieces(k)
        log(f"{name} device time by piece ({'B=256' if name == 'K1' else 'B=128, dropout 0.1'}, "
            f"S=128, bf16): " + ", ".join(f"{p} {ms:.3f} ms" for p, ms in
                                          report[name]["pieces_ms"].items()))
        ban_library_kernels(k, f"{name} alone")
    # the GEMMs' rates: K1's products from its profile, and the GEMM alone on
    # a deep product of the same tile (f32 out, device time of the GEMM
    # kernel only), which shows what ring fill and epilogue cost at K = 384
    k1 = device_ms(lambda: fl.fused_bert_layer(x, bias, w, num_heads=12), 10)
    rates = {}
    for label, mark, ops in (("QKV (N=3H, K=H)", "gemm_bf16_kernel<0,", 2.0 * M * H * 3 * H),
                             ("FFN-up + GELU (N=F, K=H)", "gemm_bf16_kernel<1,", 2.0 * M * H * F),
                             ("out-proj + FFN-down, residual (N=H, K=H and F)",
                              "gemm_bf16_kernel<2,", 2.0 * M * H * (H + F))):
        ms = sum(v for n, v in k1.items() if mark in n)
        rates[label] = {"ms": ms, "tflops": ops / ms / 1e9}
    Mg = Ng = Kg = 8192
    a = torch.randn((Mg, Kg), device=dev).to(torch.bfloat16)
    b = torch.randn((Kg, Ng), device=dev).to(torch.bfloat16)
    ms = sum(v for n, v in device_ms(lambda: fl.layer_gemm(a, b), 5).items()
             if "gemm_bf16_kernel" in n)
    rates[f"alone, M=N=K={Kg}"] = {"ms": ms, "tflops": 2.0 * Mg * Ng * Kg / ms / 1e9}
    del a, b
    report["layer_gemm"] = rates
    log("bf16 GEMM device time: " + ", ".join(
        f"{n} {r['ms']:.3f} ms = {r['tflops']:.0f} TFLOP/s" for n, r in rates.items()))
    # K3, forward + backward, B = 32 quadruplets, D = 384
    emb = [torch.nn.functional.normalize(torch.randn((32, 384), generator=gen), dim=1).to(dev)
           for _ in range(4)]
    consts = dict(gamma=0.6, m_pn=1.0, m_pt=0.5, m_tn=0.5)
    scale = torch.full((32,), 1.0 / 32, device=dev)

    def k3(fwd, bwd):
        _, dists = fwd(*emb, **consts)
        bwd(*emb, dists, scale, **consts)

    report["K3"]["ms"] = cuda_ms(lambda: k3(qd.fused_gamma_quadruplet_loss_fwd,
                                            qd.fused_gamma_quadruplet_loss_bwd), 200)
    report["K3"]["plain_ms"] = cuda_ms(lambda: k3(qd.fused_gamma_quadruplet_loss_plain,
                                                  qd.fused_gamma_quadruplet_loss_bwd_plain), 50)
    # 4 embeddings read by each pass, distances and 4 gradients written;
    # ~10 operations per element of each pass
    report["K3"].update(bound(4 * 32 * 384 * 4 * 3 + 32 * 4 * 4, 2 * 10.0 * 4 * 32 * 384,
                              "float32"))
    k3_dev = device_ms(lambda: k3(qd.fused_gamma_quadruplet_loss_fwd,
                                  qd.fused_gamma_quadruplet_loss_bwd), 20)
    # through autograd, as a train step calls it (mean): from four leaves, and
    # from the four parts of the (4, B, D) embeddings a train step unbinds
    leaves = [e.clone().requires_grad_(True) for e in emb]
    stacked = torch.stack(emb).requires_grad_(True)
    one = torch.ones((), device=dev)
    auto_ms = cuda_ms(lambda: torch.autograd.grad(
        qd.fused_gamma_quadruplet_loss(*leaves, 0.6, 1.0, 0.5, 0.5), leaves, one), 200)

    def unbound():
        return torch.autograd.grad(
            qd.fused_gamma_quadruplet_loss(*stacked.unbind(0), 0.6, 1.0, 0.5, 0.5), stacked, one)

    unbound_ms = cuda_ms(unbound, 200)
    # one call's device operations, counted exactly; an operation of no
    # account goes first because a trace may miss the first kernel after it
    # starts, and another trace is taken when this one lost the forward too
    for attempt in range(3):
        seq = device_sequence(lambda: (one.clone(), unbound()))
        while seq and "quadruplet_" not in seq[0]:
            seq.pop(0)
        if seq and "quadruplet_fwd_kernel" in seq[0]:
            break
        log(f"the trace lost K3's forward (attempt {attempt + 1} of 3): {seq}")
    report["K3"].update(autograd_ms=auto_ms, autograd_unbound_ms=unbound_ms)
    log(f"K3 forward + backward: {1e3 * report['K3']['ms']:.1f} us per call on CUDA events, "
        f"of which {1e3 * sum(k3_dev.values()):.1f} us on the device (the rest is launch "
        f"and host time); loss (mean) and gradients through autograd {1e3 * auto_ms:.1f} us, "
        f"from the unbound (4, B, D) embeddings {1e3 * unbound_ms:.1f} us in {len(seq)} device "
        f"operations: {[n.split('(')[0][-40:] for n in seq]}")
    if (len(seq) != 3 or "quadruplet_fwd_kernel" not in seq[0]
            or "quadruplet_bwd_kernel" not in seq[1]):
        fail(f"K3 through autograd: want its forward, its backward and the stack of the four "
             f"gradients, got {seq}")

    # train steps/s at the training configuration: the kernel path against
    # the nn.Module path with the plain loss, in turns
    report["train_steps_per_s"] = train_step_rates(gen, report)

    # encode sentences/s, B=256, S=128: fused (K1) against the nn.Module path
    cfg = EncoderConfig.minilm_l6(use_fused_layer=True)
    model = SentenceEncoderModule(cfg).to(dev).eval()
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(14), device=dev))
    ids = torch.randint(5, cfg.vocab_size, (B, S), generator=gen).to(dev)
    mask = torch.ones((B, S), dtype=torch.int64, device=dev)
    fused, plain = embed_fn(cfg), embed_fn(EncoderConfig.minilm_l6())
    enc_ms = cuda_ms(lambda: fused(model, ids, mask), 10)
    mod_ms = cuda_ms(lambda: plain(model, ids, mask), 10)
    # one layer of the nn.Module path (a chain of cuBLAS and elementwise
    # calls, so no single library call): K1's yardstick in PERF.md
    with torch.no_grad():
        pos = torch.arange(S, device=dev)[None, :].expand(B, S)
        hid = model.embeddings(ids, torch.zeros_like(ids), pos, None)
        zero_bias = torch.zeros((B, 1, 1, S), device=dev)
        report["K1"]["module_layer_ms"] = cuda_ms(
            lambda: model.encoder.layer[0](hid, zero_bias), 20)
    report["encode"] = {"sentences_per_s": B / enc_ms * 1e3,
                        "module_path_sentences_per_s": B / mod_ms * 1e3}

    # SentenceEncoder.encode of 32,768 texts to numpy, the evaluators' and the
    # miner's call: dispatch_depth 1 (each batch's copy waited for) against 4,
    # in turns (1, 4, 4, 1), host clock
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
    from qst_tpu_torch.models.tokenizer import HashTokenizer

    sent = SentenceEncoder(cfg, model.state_dict(), HashTokenizer(cfg.vocab_size))
    docs = synthetic_docs(32768, seed=31)
    sent.encode(docs[:4096])
    depth = {1: [], 4: []}
    arrays = {}
    for d in (1, 4, 4, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays[d] = sent.encode(docs, dispatch_depth=d)
        depth[d].append(time.perf_counter() - t0)
    if not np.array_equal(arrays[1], arrays[4]):
        fail("encode to numpy: dispatch_depth 1 and 4 give different arrays")
    log(f"encode of 32,768 texts to numpy (fused MiniLM-L6, batches of 256): dispatch_depth 1 "
        f"{['%.3f' % t for t in depth[1]]} s, 4 {['%.3f' % t for t in depth[4]]} s "
        f"(identical arrays)")
    report["encode_depth"] = {"texts": 32768, "depth1_s": depth[1], "depth4_s": depth[4]}

    # search over 1M x 384 bf16, k = 10: Q = 4096 (a search chunk: the kernels'
    # rows in the last lines) and Q = 256 (the server's largest batch)
    N, D, k = 1 << 20, 384, 10
    unit = torch.nn.functional.normalize
    corpus = unit(torch.randn((N, D), device=dev), dim=1).to(torch.bfloat16)
    for Q in (4096, 256):
        queries = unit(torch.randn((Q, D), device=dev), dim=1).to(torch.bfloat16)
        k4 = {"ms": cuda_ms(lambda: topk.bucket_maxima(queries, corpus), 10)}
        k4.update(bound(N * D * 2 + Q * D * 2 + Q * (N // 128) * 4, 2.0 * Q * N * D, "bfloat16"))
        bm = topk.bucket_maxima(queries, corpus)
        bids = topk._hierarchical_top_buckets(bm, k)
        # K5 with the sort of its pairs. Bound: each distinct winning bucket
        # read once (the gather's whole volume, Q·k buckets, is gather_ms),
        # the (Q, k·128) f32 scores written once
        k5 = {"ms": cuda_ms(lambda: topk.rescore_buckets(queries, corpus, bids, k), 20),
              "distinct_buckets": bids.unique().numel()}
        k5.update(bound(k5["distinct_buckets"] * 128 * D * 2 + Q * D * 2 + Q * k * 4
                        + Q * k * 128 * 4, 2.0 * Q * k * 128 * D, "bfloat16"))
        k5["gather_ms"] = Q * k * 128 * D * 2 / HBM_BYTES_PER_S * 1e3
        v2_ms = cuda_ms(lambda: topk.topk_v2(queries, corpus, k), 10)
        log(f"exact search Q={Q:4d} over 1M x 384 bf16, k=10: K4 {k4['ms']:.3f} ms = "
            f"{2e-9 * Q * N * D / k4['ms']:.0f} TFLOP/s (bound {k4['bound_ms']:.3f} ms by "
            f"{k4['bound_by']}), K5 {k5['ms']:.3f} ms ({k5['distinct_buckets']} distinct buckets "
            f"of {Q * k} pairs; bound {k5['bound_ms']:.3f} ms by {k5['bound_by']}; the whole "
            f"gather would take {k5['gather_ms']:.3f} ms), topk_v2 {v2_ms:.3f} ms = "
            f"{Q / v2_ms * 1e3:.0f} QPS")
        if Q == 256:
            report["search_q256"] = {"k4": k4, "k5": k5, "topk_v2_ms": v2_ms}
            continue
        report["K4"].update(k4)
        report["K5"].update(k5)
        report["K4"]["plain_ms"] = cuda_ms(lambda: [
            topk.bucket_maxima_plain(queries[lo:lo + 512], corpus)
            for lo in range(0, Q, 512)], 2)
        report["K5"]["plain_ms"] = cuda_ms(
            lambda: topk.rescore_buckets_plain(queries, corpus, bids, k), 2)
        scan_ms = cuda_ms(lambda: exact_topk(queries.float(), corpus, k, "dot_score"), 2)
        report["search"] = {"qps": Q / v2_ms * 1e3, "plain_scan_qps": Q / scan_ms * 1e3}

        # K4's mainloop against two yardsticks at the same Q = 4096: the product
        # alone through torch.matmul (bf16 in, bf16 out, written to device
        # memory and dropped; no maximum), and K4 on int8 (exact int32 sums)
        def product_alone():
            for lo in range(0, Q, 512):
                torch.matmul(queries[lo:lo + 512], corpus.T)

        mm_ms = cuda_ms(product_alone, 5)
        c8 = torch.round(corpus.float() * 127).to(torch.int8)
        q8 = torch.round(queries.float() * 127).to(torch.int8)
        i8 = {"ms": cuda_ms(lambda: topk.bucket_maxima(q8, c8), 10)}
        i8.update(bound(N * D + Q * D + Q * (N // 128) * 4, 2.0 * Q * N * D, "int8"))
        # query counts whose tiles do not pack the 132 SMs (24 and 68 tiles)
        odd = {}
        for q_odd in (3000, 8704):
            qs = unit(torch.randn((q_odd, D), device=dev), dim=1).to(torch.bfloat16)
            odd[f"Q{q_odd}_ms"] = cuda_ms(lambda: topk.bucket_maxima(qs, corpus), 5)
        # what the card does under K4: 300 launches back to back (about 1.5 s)
        burst = clocks_under(lambda: topk.bucket_maxima(queries, corpus), 300)
        log(f"K4 Q=4096, 300 launches back to back: {burst['ms']:.3f} ms each; SM clock "
            f"{burst['rest_sm_mhz']} MHz after 1 s of rest, down to {burst['min_sm_mhz']} MHz; "
            f"power {burst['rest_watts']} W, up to {burst['max_watts']} W")
        report["k4_yardsticks"] = {"matmul_product_alone_ms": mm_ms, "int8": i8, **odd,
                                   "burst": burst}
        log(f"K4 Q=4096 yardsticks: the bf16 product alone through torch.matmul in chunks of "
            f"512 queries {mm_ms:.3f} ms = {2e-9 * Q * N * D / mm_ms:.0f} TFLOP/s; K4 int8 "
            f"{i8['ms']:.3f} ms = {2e-9 * Q * N * D / i8['ms']:.0f} TOP/s (bound "
            f"{i8['bound_ms']:.3f} ms by {i8['bound_by']}); K4 bf16 at "
            + ", ".join(f"Q={q} {odd[f'Q{q}_ms']:.3f} ms = "
                        f"{2e-9 * q * N * D / odd[f'Q{q}_ms']:.0f} TFLOP/s" for q in (3000, 8704)))
        del c8, q8
    # K5's two forms (pairs grouped by bucket after a sort; each pair its own
    # block) around the line where the wrapper changes from one to the other
    forms = {}
    group_from = topk._GROUP_MIN_PAIRS
    try:
        for Q in (256, 512, 1024, 4096):
            queries = unit(torch.randn((Q, D), device=dev), dim=1).to(torch.bfloat16)
            bids = topk._hierarchical_top_buckets(topk.bucket_maxima(queries, corpus), k)
            forms[f"Q{Q}"] = row = {"pairs": Q * k}
            for form, min_pairs in (("grouped_ms", 0), ("a_block_a_pair_ms", Q * k + 1)):
                topk._GROUP_MIN_PAIRS = min_pairs
                row[form] = cuda_ms(lambda: topk.rescore_buckets(queries, corpus, bids, k), 20, 3)
    finally:
        topk._GROUP_MIN_PAIRS = group_from
    report["k5_forms"] = forms
    log(f"K5 by form over 1M x 384 bf16, k=10 (the wrapper groups from {group_from} pairs on): "
        + "; ".join(f"{r['pairs']} pairs grouped {r['grouped_ms']:.3f} ms, a block a pair "
                    f"{r['a_block_a_pair_ms']:.3f} ms" for r in forms.values()))
    del corpus, queries, bm, bids, model
    torch.cuda.empty_cache()
    times_ivf(report)


def train_setup(enc_cfg, loss_cfg, gen, device):
    """A fresh train state and step at the training configuration, and one
    random (4, 32, 128) batch on the card."""
    import torch

    from qst_tpu_torch.train import create_train_state, make_train_step

    _, _, base = train_config()
    state, _ = create_train_state(enc_cfg, base, torch.Generator().manual_seed(14), 1000,
                                  loss_cfg, device=device)
    ids = torch.randint(5, enc_cfg.vocab_size, (4, 32, 128), generator=gen).to(device)
    mask = torch.ones_like(ids)
    return state, make_train_step(enc_cfg, loss_cfg), ids, mask


def train_step_rates(gen, report: dict) -> dict:
    """Steps/s (host clock, synchronised) of the kernel path one step a
    call, the same steps captured four a call (one CUDA graph replay), and
    the nn.Module path with the plain loss, timed in turns: kernels,
    captured, module, module, captured, kernels; 20 steps each after warm-up
    (3 steps; the captured path's first call runs eagerly and captures);
    K9's launches over the nn.Module path's timed steps."""
    import dataclasses

    import torch

    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.train import dropout_key, make_multi_step

    dev = torch.device("cuda")
    enc_cfg, loss_cfg, _ = train_config()
    paths = {"kernels": (enc_cfg, loss_cfg), "captured": (enc_cfg, loss_cfg),
             "module": (dataclasses.replace(enc_cfg, use_fused_layer=False),
                        dataclasses.replace(loss_cfg, use_fused_kernel=False))}
    rates = {"kernels": [], "captured": [], "module": []}
    K = 4
    keep = []
    for name in ("kernels", "captured", "module", "module", "captured", "kernels"):
        state, step, ids, mask = train_setup(*paths[name], gen, dev)
        if name == "captured":
            multi = make_multi_step(enc_cfg, loss_cfg, None, K)
            kids, kmask = ids.expand(K, *ids.shape), mask.expand(K, *mask.shape)
            keys = [torch.stack([dropout_key(c, j + 1) for j in range(K)]) for c in range(7)]
            calls = [lambda c=c: multi(state, kids, kmask, keys[c]) for c in range(7)]
            warm, timed, n = calls[:2], calls[2:], 20
        else:
            calls = [lambda i=i: step(state, ids, mask, dropout_key(i, 1)) for i in range(23)]
            warm, timed, n = calls[:3], calls[3:], 20
        for c in warm:
            c()
        torch.cuda.synchronize()
        fl.module_keep_mask.launches = 0
        t0 = time.perf_counter()
        for c in timed:
            c()
        torch.cuda.synchronize()
        rates[name].append(n / (time.perf_counter() - t0))
        if name == "module":
            keep.append(fl.module_keep_mask.launches)
        del state
    log(f"train steps/s, MiniLM-L6, batch 32 quadruplets, S=128, bf16, dropout 0.1: "
        f"kernel path {rates['kernels']}, captured {K} a call {rates['captured']}, "
        f"nn.Module path with plain loss {rates['module']} (K9 launches over its 20 steps "
        f"{keep})")
    # one mask a dropout site: the embeddings' and three a layer, a step
    if keep != [20 * (3 * enc_cfg.num_layers + 1)] * 2:
        fail(f"the nn.Module train step's dropout launched K9 {keep} times in its two turns "
             f"of 20 steps, want {20 * (3 * enc_cfg.num_layers + 1)} each")
    add_keep_launches(report, sum(keep))
    return rates


def device_us(event) -> float:
    """A profiler event's own device time in µs (the name varies by torch)."""
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
LEAD_IN_MARKERS = 32            # marker kernels a profiled window starts with


def lead_in() -> None:
    """What a profiled window runs before the calls it measures: 32 short
    marker kernels. Kineto drops the GPU records it timestamps before the
    window's start, and late in a run it timestamps a window's first records
    early (up to ~0.5 s before their launches): in a 3-minute run it dropped
    the first 3 to 9 records of a window, however long they ran, which the
    markers take; late in a whole run it dropped whole windows, which no
    lead-in saves (ROADMAP C2; an NVIDIA H100 80GB HBM3 at 700 W)."""
    import torch

    for _ in range(LEAD_IN_MARKERS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def device_activity() -> list:
    """The activities every profile of this script traces: the card's alone.
    Its windows read device events only, and tracing the host's operators
    too made reading a window back cost seconds (most of a phase in some)."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA]


def profiled(fn, reps: int):
    """torch.profiler over ``reps`` calls of ``fn``, after the window's
    ``lead_in``: the trace can miss the first kernels after it starts, and
    the markers take that loss. → the profile."""
    import torch
    from torch.profiler import profile

    with profile(activities=device_activity()) as prof:
        lead_in()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def is_kernel(e) -> bool:
    """A device event of the profiled calls: not a marker, not a
    record_function range (the optimizer's step also carries device time,
    which would count its kernels twice)."""
    key = getattr(e, "key", None) or e.name
    return (e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
            and not key.startswith("Optimizer.") and MARKER not in key)


def device_profile(fn, reps: int):
    """Device time per call of each kernel ``fn`` runs, from torch.profiler:
    ({kernel name: ms per call}, launches per call). Fails when the profiler
    saw no kernel in two tries."""
    import torch

    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        events = [e for e in profiled(fn, reps).key_averages() if is_kernel(e)]
        if events:
            break
        log(f"the profiler saw no device kernels (attempt {attempt + 1} of 2)")
    if not events:
        fail("the profiler saw no device kernels")
    return ({e.key: device_us(e) / 1e3 / reps for e in events},
            sum(e.count for e in events) / reps)


def device_ms(fn, reps: int) -> dict:
    return device_profile(fn, reps)[0]


def device_sequence(fn) -> list:
    """The names of the device operations (kernels, copies, memsets) of one
    call of ``fn``, in the order they started (after the last marker)."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = sorted((e for e in profiled(fn, 1).events() if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if MARKER in e.name]
    return [e.name for e in events[marks[-1] + 1 if marks else 0:] if is_kernel(e)]


LAYER_PIECES = (("GEMMs", ("gemm_bf16_kernel", "gemm_f32_kernel")),
                ("attention forward", ("attention_mma_kernel", "attention_kernel")),
                ("attention backward", ("attention_bwd_mma_kernel", "attention_bwd_kernel")),
                ("LayerNorm", ("layernorm_kernel", "layernorm_bwd_kernel")),
                ("ordered sums", ("sum_rows_kernel",)))


def layer_pieces(kernels: dict) -> dict:
    """{piece: device ms} of a fused layer's kernels (``device_ms``'s names)."""
    out = {label: sum(ms for n, ms in kernels.items() if any(k in n for k in keys))
           for label, keys in LAYER_PIECES}
    out["other"] = sum(kernels.values()) - sum(out.values())
    return out


def lib_kernels(names: dict, marks) -> dict:
    """The library kernels (not the port's: no ``qst::``) among ``names``
    whose name holds one of ``marks``."""
    return {n: c for n, c in names.items()
            if "qst::" not in n and any(mk in n.lower() for mk in marks)}


def ban_library_kernels(kernels: dict, what: str) -> None:
    """Fail if a library's GEMM or attention kernel ran (``device_ms``'s names)."""
    banned = sorted(lib_kernels(kernels, LIBRARY_KERNEL_MARKS))
    if banned:
        fail(f"library kernels on the path of {what}: {banned}")


def short_name(kernel: str) -> str:
    """A kernel's name without its namespaces and launch template
    arguments, up to 110 characters: the functor that tells torch's
    elementwise kernels apart stays."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::", "c10::"):
        kernel = kernel.replace(noise, "")
    return kernel[:110]


def shares(kernels: dict, groups, name_other: int = 0) -> str:
    """'label ms (share%)' for each (label, name substrings) group of
    kernels, then the rest, as a share of all device time; with
    ``name_other``, the largest kernels of the rest by name."""
    total = sum(kernels.values())
    left = dict(kernels)
    parts = []
    for label, keys in groups:
        ms = sum(left.pop(n) for n in list(left) if any(k in n for k in keys))
        parts.append(f"{label} {ms:.3f} ms ({100 * ms / total:.1f}%)")
    rest = sum(left.values())
    parts.append(f"other {rest:.3f} ms ({100 * rest / total:.1f}%)")
    top = sorted(left.items(), key=lambda kv: -kv[1])[:name_other]
    if top:
        parts.append("largest other: " + "; ".join(f"{short_name(n)} {ms:.3f} ms"
                                                   for n, ms in top))
    return ", ".join(parts)


def glue_pieces(enc_cfg, ids, dev) -> None:
    """Two pieces of the train step's glue (the device work outside the
    kernels), timed alone with CUDA events at the step's shapes: the
    embedding dropout's mask (its int32 hash, as the step draws it, against
    the int64 reference ``_hash31``; the two bit-equal on the card) and the
    word embedding's lookup forward + backward (``F.embedding``, as the step
    runs it, against the index form ``weight[ids]``), on random ids and on
    the same ids padded as short captions are (the last three quarters of
    each row id 0)."""
    import torch

    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.train import dropout_key

    H = enc_cfg.hidden_size
    flat = ids.reshape(-1, ids.shape[-1]).long()
    padded = flat.clone()
    padded[:, flat.shape[1] // 4:] = 0
    x = torch.randn(flat.shape + (H,), device=dev).to(torch.bfloat16)
    base = fl.step_draws(dropout_key(3, 1).to(dev), enc_cfg.num_layers)[0]
    i64 = torch.arange(x.numel(), dtype=torch.int64, device=dev)
    if not torch.equal(fl._hash31_i32(i64.to(torch.int32), base, fl._TAG_EMBED).long(),
                       fl._hash31(i64, base, fl._TAG_EMBED)):
        fail("the int32 embedding-mask hash differs from the int64 one on the card")
    del i64

    def mask_int64():
        idx = torch.arange(x.numel(), dtype=torch.int64, device=dev).reshape(x.shape)
        return (x.float() * fl._keep(fl._hash31(idx, base, fl._TAG_EMBED), 0.1)).to(x.dtype)

    weight = torch.randn((enc_cfg.vocab_size, H), device=dev, requires_grad=True)
    grad = torch.randn(flat.shape + (H,), device=dev)

    def lookup(rows, embedding: bool):
        def run():
            out = torch.nn.functional.embedding(rows, weight) if embedding else weight[rows]
            torch.autograd.grad(out, weight, grad)
        return run

    ms = {"mask int32": cuda_ms(lambda: fl.embedding_dropout(x, base, 0.1), 20),
          "mask int64": cuda_ms(mask_int64, 20)}
    for name, rows in (("random", flat), ("padded", padded)):
        for form, embedding in (("F.embedding", True), ("index", False)):
            ms[f"{form} {name}"] = cuda_ms(lookup(rows, embedding), 10)
    log(f"profile train step glue, {flat.numel()} rows x {H}: embedding-dropout mask "
        f"{ms['mask int32']:.3f} ms (int32 hash, the step's) against {ms['mask int64']:.3f} "
        f"(int64); word-embedding lookup forward + backward on random / padded ids "
        f"{ms['F.embedding random']:.3f} / {ms['F.embedding padded']:.3f} ms (F.embedding, the "
        f"step's) against {ms['index random']:.3f} / {ms['index padded']:.3f} (weight[ids])")


def profile_phase(report: dict) -> None:
    """Where the time goes. Encode and search:
    device time per kernel from torch.profiler against the wall time of the
    same call (CUDA events, no profiler), so busy = device / wall. Serving:
    closed-loop clients each sending single-query POST /search for a fixed
    window; req/s, p50 and p99 latency, the batcher's mean batch, and the
    device's busy share over a profiled window at the highest load."""
    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, embed_fn, init_params
    from qst_tpu_torch.models.tokenizer import HashTokenizer
    from qst_tpu_torch.ops import topk
    from qst_tpu_torch.retrieval import Retriever
    from qst_tpu_torch.serve import RetrievalServer
    from qst_tpu_torch.train import dropout_key

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    cfg = EncoderConfig.minilm_l6(use_fused_layer=True)
    params = init_params(cfg, torch.Generator().manual_seed(14), device=dev)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    enc = SentenceEncoder(cfg, params, tok)
    B, S = 256, 128
    ids = torch.randint(5, cfg.vocab_size, (B, S), generator=gen).to(dev)
    mask = torch.ones((B, S), dtype=torch.int64, device=dev)
    for name, fwd in (("fused (K1)", embed_fn(cfg)),
                      ("nn.Module", embed_fn(EncoderConfig.minilm_l6()))):
        wall = cuda_ms(lambda: fwd(enc.model, ids, mask), 10)
        k = device_ms(lambda: fwd(enc.model, ids, mask), 5)
        if name.startswith("fused"):
            ban_library_kernels(k, "the fused encode")
        log(f"profile encode {name} B={B} S={S}: {wall:.3f} ms per call, device busy "
            f"{100 * sum(k.values()) / wall:.1f}%: " + shares(k, (
                ("attention", ("attention_mma_kernel",)),
                ("QKV GEMM", ("gemm_bf16_kernel<0,",)),
                ("FFN-up GELU GEMM", ("gemm_bf16_kernel<1,",)),
                ("out-proj/FFN-down residual GEMMs", ("gemm_bf16_kernel<2,",)),
                ("layernorm", ("layernorm_kernel",)),
                ("library GEMM", ("gemm", "nvjet", "cutlass", "xmma")))))

    # one train step at the training configuration (kernel path): wall time
    # on the host clock (synchronised), device time per kernel from the
    # profiler. K1 and K2's forward recompute run the same kernels, so the
    # forward groups hold both (six layers each); K1 alone is `times`' one
    # layer x 6
    enc_cfg, loss_cfg, _ = train_config()
    state, step, tids, tmask = train_setup(enc_cfg, loss_cfg, gen, dev)
    tgen = dropout_key(3, 1)
    for _ in range(2):
        step(state, tids, tmask, tgen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(state, tids, tmask, tgen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    k = device_ms(lambda: step(state, tids, tmask, tgen), 3)
    ban_library_kernels(k, "the kernel-path train step")
    log(f"profile train step, batch 32 quadruplets, S=128, bf16, dropout 0.1: {wall:.3f} ms "
        f"per step, device busy {100 * sum(k.values()) / wall:.1f}%: " + shares(k, (
            ("attention forward (K1 + K2 recompute)", ("attention_mma_kernel",)),
            ("forward GEMMs (K1 + K2 recompute)", tuple(f"gemm_bf16_kernel<{e}," for e in
                                                        range(4))),
            ("attention backward (K2)", ("attention_bwd_mma_kernel",)),
            ("backward GEMMs (K2: dX and split-K dW)", tuple(f"gemm_bf16_kernel<{e}," for e in
                                                             range(4, 9))),
            ("LayerNorm forward and backward, ordered sums", ("layernorm_kernel",
                                                              "layernorm_bwd_kernel",
                                                              "sum_rows_kernel")),
            ("K3", ("quadruplet_",)),
            ("optimizer (foreach)", ("foreach", "multi_tensor", "MultiTensor")),
            ("library GEMM", ("gemm", "nvjet", "cutlass", "xmma"))), name_other=10))
    glue_pieces(enc_cfg, tids, dev)
    # K3 in the step's timeline: its forward, then its backward, with nothing
    # between them but the fill of backward()'s root gradient
    seq = device_sequence(lambda: step(state, tids, tmask, tgen))
    fwd = [i for i, n in enumerate(seq) if "quadruplet_fwd_kernel" in n]
    bwd = [i for i, n in enumerate(seq) if "quadruplet_bwd_kernel" in n]
    if len(fwd) != 1 or len(bwd) != 1:
        fail(f"one train step launched K3 forward {len(fwd)} and backward {len(bwd)} times")
    short = [n.split("(")[0][-60:] for n in seq]
    log(f"profile train step, K3 in the timeline of {len(seq)} device operations: ... "
        f"{short[max(fwd[0] - 2, 0):fwd[0]]} -> {short[fwd[0]:bwd[0] + 1]} -> "
        f"{short[bwd[0] + 1:bwd[0] + 3]} ...")
    between = seq[fwd[0] + 1:bwd[0]]
    if len(between) > 1 or any("fill" not in n.lower() for n in between):
        fail(f"device operations between K3's forward and backward: {between}")
    del state

    N, D = 1 << 20, 384
    unit = torch.nn.functional.normalize
    corpus = unit(torch.randn((N, D), device=dev), dim=1).to(torch.bfloat16)
    for Q in (8, 64, 256, 4096):
        queries = unit(torch.randn((Q, D), device=dev), dim=1).to(torch.bfloat16)
        wall = cuda_ms(lambda: topk.topk_v2(queries, corpus, 10), 10)
        k = device_ms(lambda: topk.topk_v2(queries, corpus, 10), 5)
        ban_library_kernels(k, "topk_v2")
        log(f"profile search Q={Q} over 1M x 384 bf16, k=10: {wall:.3f} ms per call, "
            f"device busy {100 * sum(k.values()) / wall:.1f}%: " + shares(k, (
                ("K4", ("bucket_max",)), ("K5", ("rescore_",)),
                ("bucket selection, K5's sort and the last top-k",
                 ("topk", "TopK", "sort", "Sort", "radix", "gather", "reduce"))), name_other=2))
    del corpus

    # the IVF search through K6 over the clustered 1M-row index of `times`
    from qst_tpu_torch.retrieval import IVFIndex

    rows, _, _ = clustered_corpus(N, 1024, D, seed=21)
    idx = IVFIndex(rows, n_clusters=1024, dtype="bfloat16", seed=0)
    for Q in (8, 64, 256):
        queries = unit(rows[torch.randint(0, N, (Q,), device=dev)]
                       + 0.02 * torch.randn((Q, D), device=dev), dim=1)

        def search():
            return idx._device_search(queries, 10, 8, "pallas")

        wall = cuda_ms(search, 48, warmup=24)
        k, launches = device_profile(search, 5)
        if not any("ivf_cell_scores_kernel" in n for n in k):
            fail(f"IVF search Q={Q}: the profiler did not see K6")
        log(f"profile IVF search Q={Q} over 1M x 384 bf16 in 1,024 cells of budget "
            f"{idx.cell_budget}, n_probe 8, k=10: {wall:.3f} ms per call, "
            f"{launches:.0f} device launches a call ({len(k)} distinct kernels), device busy "
            f"{100 * sum(k.values()) / wall:.1f}%: " + shares(k, (
                ("K6", ("ivf_cell_scores_kernel",)),
                ("centroid product", ("gemm", "splitKreduce", "gemv")),
                ("top-k", ("topk", "TopK", "sort", "Sort", "radix")),
                ("gathers", ("gather", "index"))), name_other=3))
        if Q == 8:
            log("profile IVF search Q=8, its device operations in order: " + ", ".join(
                n.split("(")[0].split("<")[0][-48:] for n in device_sequence(search)))
    del rows, idx

    docs = synthetic_docs(65536, seed=14)
    retr = Retriever(enc, score="dot_score", index_dtype="bfloat16").build(docs)
    server = RetrievalServer(retr, port=0)
    port = server.start()
    try:
        for n_clients in (1, 8, 64):
            lat, stop, errors = [], threading.Event(), []

            def client(seed):
                rng = np.random.default_rng(seed)
                while not stop.is_set():
                    q = docs[int(rng.integers(len(docs)))]
                    t0 = time.perf_counter()
                    try:
                        post(port, "/search", {"queries": [q], "k": 10})
                    except Exception as e:  # reported below
                        errors.append(repr(e))
                        return
                    lat.append(time.perf_counter() - t0)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
            for t in threads:
                t.start()
            time.sleep(1.0)                       # ramp up
            before, n0, t0 = server._search_batcher.stats(), len(lat), time.perf_counter()
            time.sleep(3.0)
            after, n1, window = server._search_batcher.stats(), len(lat), time.perf_counter() - t0
            busy = None
            if n_clients == 64:                   # busy share, still under load
                from torch.profiler import profile

                with profile(activities=device_activity()) as prof:
                    time.sleep(2.0)
                busy = sum(device_us(e) for e in prof.key_averages()
                           if e.device_type.name == "CUDA") / 2e6 or None
            stop.set()
            for t in threads:
                t.join(timeout=120)
            if errors or n1 == n0:
                fail(f"serving load, {n_clients} clients: {errors[:3]}")
            p50, p99 = (1e3 * float(np.percentile(lat[n0:n1], p)) for p in (50, 99))
            n_b = after["batches"] - before["batches"]
            mean_batch = (after["items"] - before["items"]) / max(n_b, 1)
            log(f"profile serve {n_clients:2d} clients, 65,536 docs bf16, k=10: "
                f"{(n1 - n0) / window:.1f} req/s, p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
                f"mean batch {mean_batch:.2f}"
                + ("" if n_clients != 64 else ", device busy " + (
                    "not measured (the profiler saw no kernels)" if busy is None
                    else f"{100 * busy:.1f}% of 2 s")))
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# mpnet: K1 with MPNet's relative bias and K2 with drel at S up to 512,
# checkpoint directories, the CLIs on a full-width MPNet-base directory
# ---------------------------------------------------------------------------
MPNET_SEQS = (128, 200, 384, 512)


def lecun_layer(H, F, dtype, gen, device):
    """A layer drawn as ``init_params`` draws one (each matrix normal with
    variance 1 / fan_in; biases and LayerNorm offsets 0.05 noise, scales
    near 1), so that activations keep unit scale at every width: at H = 384
    it is ``random_layer``'s 0.05 within 2 %."""
    w = random_layer(H, F, dtype, gen, device)
    for n, fan_in in (("wq", H), ("wk", H), ("wv", H), ("wo", H), ("w1", H), ("w2", F)):
        w[n] = (w[n].float() * (fan_in ** -0.5 / 0.05)).to(dtype).contiguous()
    return w


def random_rel(NH, S, gen, dev):
    """A (nh·S, S) relative bias: a (32, nh) table gathered by the buckets."""
    import torch

    from qst_tpu_torch.models.mpnet import relative_bias

    table = torch.randn((32, NH), generator=gen) * 0.5
    return relative_bias(table, S).reshape(NH * S, S).contiguous().to(dev)


def check_layer_pair(what: str, x, bias, w, g, kw: dict, errs: dict) -> None:
    """K1 and K2 against their plain versions (K1: f32 1e-4, bf16
    bf16_limits; K2 per gradient tensor, drel among them: f32 1e-4 max /
    2e-5 mean relative, bf16 2e-2 / 2^-7), and K2's outputs bit-equal
    between two calls."""
    import torch

    from qst_tpu_torch.ops import fused_layer as fl

    out = fl.fused_bert_layer(x, bias, w, **kw).float()
    ref = fl.fused_bert_layer_plain(x, bias, w, **kw).float()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"K1 {what}: non-finite output")
    if x.dtype == torch.float32:
        err = (out - ref).abs().max().item()
        log(f"K1 {what}: max|err| {err:.3e} (limit 1e-4)")
        if not err <= 1e-4:
            fail(f"K1 {what}: max|err| {err} > 1e-4")
    else:
        err = bf16_limits(f"K1 {what}", out, ref)
    errs["K1"] = max(errs["K1"], err)
    runs = [fl.fused_bert_layer_bwd(x, bias, w, g, **kw) for _ in range(2)]
    rdx, rdw = fl.fused_bert_layer_bwd_plain(x, bias, w, g, **kw)
    torch.cuda.synchronize()
    (dx, dw), (dx2, dw2) = runs
    if not (torch.equal(dx, dx2) and all(torch.equal(dw[n], dw2[n]) for n in dw)):
        fail(f"K2 {what}: two calls differ")
    grads, refs = dict(dw, dx=dx), dict(rdw, dx=rdx)
    if not all(torch.isfinite(t).all() for t in grads.values()):
        fail(f"K2 {what}: non-finite gradients")
    if ("drel" in refs) != ("drel" in grads):
        fail(f"K2 {what}: drel missing")
    (mx, mx_n), (mean, mean_n), ab = grad_errors(grads, refs)
    lim_max, lim_mean = (1e-4, 2e-5) if x.dtype == torch.float32 else (2e-2, 2.0 ** -7)
    drel = ""
    if "drel" in refs:
        d = (grads["drel"] - refs["drel"]).abs()
        drel = (f"; drel max {d.max().item() / refs['drel'].abs().max().item():.3e}, mean "
                f"{d.mean().item() / refs['drel'].abs().mean().item():.3e}")
    log(f"K2 {what}, dx and {len(dw)} gradients: worst max|err|/max|ref| {mx:.3e} ({mx_n}; "
        f"limit {lim_max:.0e}), worst mean|err|/mean|ref| {mean:.3e} ({mean_n}; limit "
        f"{lim_mean:.2e}){drel}; two calls bit-equal")
    if not (mx <= lim_max and mean <= lim_mean):
        fail(f"K2 {what}: outside the limits")
    errs["K2"] = max(errs["K2"], ab)


def kernel_names(fn, want=()) -> dict:
    """{device kernel name: launches a call} of fn, from two calls profiled
    after ``profiled``'s marker kernels: in a whole run the trace lost a
    window's first kernels (all of K1's forward, three windows in a row),
    which the markers and the first call absorb. Should a name in ``want``
    still not show, the calls are profiled again, up to three times, and
    the names of all tries merged (a profiler reports no kernel that did
    not run)."""
    out = {}
    for _ in range(3):
        prof = profiled(fn, 2)
        seen = {}
        for e in prof.events():
            if is_kernel(e):
                seen[e.name] = seen.get(e.name, 0) + 0.5
        for n, c in seen.items():
            out[n] = max(out.get(n, 0), c)
        if all(any(w in n for n in out) for w in want):
            break
    return out


def kernel_counts(fn, done=lambda counts: True, reps: int = 4, tries: int = 3) -> dict:
    """{device kernel name: launches a call} of ``fn``, for checks that count
    launches exactly. Every call of ``fn`` launches the same kernels, so a
    name's launches a call are its count in the window over ``reps``, rounded
    up: that is exact while the trace loses fewer than ``reps`` of the name's
    records (a whole run lost one record of a window now and then, which the
    plain mean of ``kernel_names`` turns into x.5 and a failed count), and it
    can never exceed the true count. Until ``done(counts)`` holds, the window
    is profiled again, up to ``tries`` times, each name keeping its largest
    count."""
    import math

    out = {}
    for t in range(tries):
        seen = {}
        for e in profiled(fn, reps).events():
            if is_kernel(e):
                seen[e.name] = seen.get(e.name, 0) + 1
        for n, c in seen.items():
            out[n] = max(out.get(n, 0), math.ceil(c / reps))
        if done(out) or t + 1 == tries:
            break
        log(f"kernel_counts: the window's counts fall short of the check's (try {t + 1} of "
            f"{tries}); profiling again")
    return out


def check_mpnet_kernels(report: dict) -> None:
    """K1 with rel_bias and K2 with drel at MPNet-base width (H 768, 12
    heads, F 3072), S = 128, 200 (no multiple of 16), 384 and 512, f32 and
    bf16, dropout 0 and 0.1; BERT K1/K2 at MiniLM-L6 width at S = 256; the
    kernels each path launches, by name."""
    import torch

    from qst_tpu_torch.ops import fused_layer as fl

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(19)
    errs = {"K1": 0.0, "K2": 0.0}
    cases = [(768, 3072, 12, S, True) for S in MPNET_SEQS] + [(384, 1536, 12, 256, False)]
    for H, F, NH, S, rel in cases:
        B = 8 if S > 256 else 16
        for dtype in (torch.float32, torch.bfloat16):
            w = lecun_layer(H, F, dtype, gen, dev)
            x, bias, g = masked_batch(B, S, H, dtype, gen, dev)
            rb = random_rel(NH, S, gen, dev) if rel else None
            if dtype == torch.bfloat16 and rel:
                # the same layer without the relative bias: what the
                # summation order alone gives at this width
                ref = fl.fused_bert_layer_plain(x, bias, w, num_heads=NH).float()
                base = (fl.fused_bert_layer(x, bias, w, num_heads=NH).float() - ref).abs()
                log(f"K1 H={H} S={S} bf16 without rel_bias: mean|err|/mean|ref| "
                    f"{base.mean().item() / ref.abs().mean().item():.3e}")
            for rate in (0.0, 0.1):
                seed = torch.tensor([123457], dtype=torch.int32, device=dev) if rate else None
                kw = dict(num_heads=NH, rel_bias=rb, attn_dropout=rate, hidden_dropout=rate,
                          seed=seed, nb=8)
                what = (f"{'MPNet' if rel else 'BERT'} H={H} S={S} B={B} {str(dtype)[6:]} "
                        f"dropout {rate}")
                check_layer_pair(what, x, bias, w, g, kw, errs)
    report["K1"]["mpnet_max_abs_err"] = errs["K1"]
    report["K2"]["mpnet_max_abs_err"] = errs["K2"]

    # which kernels each path launches: BERT at S <= 128 the one-block
    # attention kernels as before this slice; rel or S > 128 the key-blocked
    def names(H, F, NH, S, rel, want):
        w = lecun_layer(H, F, torch.bfloat16, gen, dev)
        x, bias, _ = masked_batch(8, S, H, torch.bfloat16, gen, dev)
        rb = random_rel(NH, S, gen, dev) if rel else None
        kw = dict(num_heads=NH, rel_bias=rb)
        return kernel_names(lambda: (fl.fused_bert_layer(x, bias, w, **kw),
                                     fl.fused_bert_layer_bwd(x, bias, w, x, **kw)), want)

    seen = {}
    for key, args, want, banned in (
            ("minilm_s128", (384, 1536, 12, 128, False),
             ("attention_mma_kernel", "attention_bwd_mma_kernel"), ("_kb_", "bwd_q", "drel")),
            ("minilm_s256", (384, 1536, 12, 256, False),
             ("attention_kb_mma_kernel", "attention_bwd_q_kernel", "attention_bwd_kv_kernel"),
             ("attention_mma_kernel", "attention_bwd_mma", "drel")),
            ("mpnet_s128", (768, 3072, 12, 128, True),
             ("attention_mma_kernel", "attention_bwd_q_kernel", "attention_bwd_kv_kernel",
              "attention_drel_kernel"), ("attention_kb_mma", "attention_bwd_mma")),
            ("mpnet_s384", (768, 3072, 12, 384, True),
             ("attention_kb_mma_kernel", "attention_bwd_q_kernel", "attention_bwd_kv_kernel",
              "attention_drel_kernel"), ("attention_mma_kernel", "attention_bwd_mma"))):
        got = names(*args, want)
        short = {}
        for n, c in got.items():
            short[short_name(n)] = short.get(short_name(n), 0) + c
        seen[key] = short
        log(f"kernels launched by K1 + K2, {key}: {short}")
        for wname in want:
            if not any(n.startswith(wname) or wname in n for n in short):
                fail(f"{key}: {wname} was not launched")
        for bname in banned:
            if any(bname in n for n in short):
                fail(f"{key}: {bname} was launched")
        ban_library_kernels(got, key)
    report["mpnet_kernel_names"] = seen


MPNET_SPECIAL = ["[PAD]", "<s>", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "</s>", "<unk>"]


def checkpoint_vocab(size: int) -> list:
    """A WordPiece vocabulary of ``size`` lines in which the synthetic
    datasets' words (w0 .. w4999) are whole tokens."""
    words = MPNET_SPECIAL + [f"w{i}" for i in range(5000)]
    return words + [f"t{i}" for i in range(size - len(words))]


def write_checkpoint_dirs(root: str) -> dict:
    """Two random-init sentence-transformers directories written by the
    port's exporter, at full width: MPNet-base (model.safetensors,
    max_seq_length 384, mean pooling) and MiniLM-L6 (pytorch_model.bin,
    max_seq_length 256)."""
    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.hf_export import save_checkpoint_dir
    from qst_tpu_torch.models.sentence_encoder import init_params

    out = {}
    for name, cfg, weights in (
            ("mpnet", EncoderConfig.mpnet_base(max_seq_length=384), "model.safetensors"),
            ("minilm", EncoderConfig.minilm_l6(max_seq_length=256), "pytorch_model.bin")):
        sd = init_params(cfg, torch.Generator().manual_seed(29), device="cpu")
        out[name] = save_checkpoint_dir(sd, cfg, os.path.join(root, name),
                                        vocab=checkpoint_vocab(cfg.vocab_size), weights=weights)
    return out


def long_texts(n: int, words: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{j}" for j in rng.integers(0, 5000, int(rng.integers(words // 2, words))))
            for _ in range(n)]


def encode_checkpoint_dirs(report: dict, dirs: dict) -> None:
    """Each directory through load_hf_checkpoint_dir; texts that land in the
    256 and 384 buckets encoded through the fused path and through the
    nn.Module path: cosine >= 0.999 per row."""
    import dataclasses

    import torch

    from qst_tpu_torch.models.hf_import import load_hf_checkpoint_dir
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
    from qst_tpu_torch.models.tokenizer import load_tokenizer
    from qst_tpu_torch.ops import fused_layer as fl

    out = {}
    for name, want in (("mpnet", ("mpnet", 768, 12, 384, "mean", 30527)),
                       ("minilm", ("bert", 384, 6, 256, "mean", 30522))):
        cfg, sd, vocab = load_hf_checkpoint_dir(dirs[name])
        got = (cfg.arch, cfg.hidden_size, cfg.num_layers, cfg.max_seq_length, cfg.pooling,
               cfg.vocab_size)
        if got != want:
            fail(f"{name} directory: config {got}, want {want}")
        tok = load_tokenizer(vocab, vocab_size=cfg.vocab_size)
        # a batch of 32 short texts, one of 125-250 words (the 256 bucket)
        # and one of 190-380 words (the 384 bucket, cut to 256 for MiniLM)
        texts = long_texts(32, 40, 1) + long_texts(32, 250, 2) + long_texts(32, 380, 3)
        embs = {}
        for fused in (True, False):
            enc = SentenceEncoder(dataclasses.replace(cfg, use_fused_layer=fused), sd, tok,
                                  device="cuda")
            before = fl.fused_bert_layer.launches
            embs[fused] = enc.encode(texts, batch_size=32)
            launches = fl.fused_bert_layer.launches - before
            if fused:
                if launches != cfg.num_layers * 3:
                    fail(f"{name}: K1 launched {launches} times, want {cfg.num_layers * 3}")
                report["K1"]["launches"] = report["K1"].get("launches", 0) + launches
        lens = [int(m.sum()) for m in tok.batch_encode(texts, max_length=cfg.max_seq_length)[1]]
        cos = (embs[True] * embs[False]).sum(1) / (
            np.linalg.norm(embs[True], axis=1) * np.linalg.norm(embs[False], axis=1))
        log(f"{name} directory ({cfg.arch}, H={cfg.hidden_size}, {cfg.num_layers} layers, "
            f"max_seq_length {cfg.max_seq_length}): {len(texts)} texts of {min(lens)}-"
            f"{max(lens)} tokens in three batches (buckets 64, 256, {cfg.max_seq_length}), "
            f"fused path against nn.Module path: worst row cosine {cos.min():.6f} (limit 0.999)")
        if not (np.isfinite(embs[True]).all() and cos.min() >= 0.999):
            fail(f"{name}: the fused path's embeddings disagree with the module path's")
        out[name] = {"worst_cosine": float(cos.min()), "tokens": [min(lens), max(lens)]}
    report.setdefault("mpnet", {})["directories"] = out


def write_long_chunks(root: str, n: int, seed: int) -> None:
    """A quadruplet dataset whose references run to 150-380 words (the
    collator pads every batch to the model's max_seq_length)."""
    from qst_tpu_torch.data import write_chunk, write_meta

    rng = np.random.default_rng(seed)
    insts = []
    for i in range(n):
        ref = rng.integers(0, 5000, int(rng.integers(150, 380)))
        text = lambda ws: " ".join(f"w{j}" for j in ws)  # noqa: E731
        pos = []
        for _ in range(3):
            v = ref.copy()
            v[rng.integers(0, len(v), 30)] = rng.integers(0, 5000, 30)
            pos.append(text(v))
        part = [text(np.concatenate([ref[: len(ref) // 2], rng.integers(0, 5000, 20)]))
                for _ in range(2)]
        insts.append({"id": i, "reference": text(ref), "positive": pos, "part_positive": part})
    for c in range(0, n, 64):
        write_chunk(root, c // 64, insts[c:c + 64], dataset_name="synthetic-long")
    write_meta(root, (n + 63) // 64)


def mpnet_train_main(report: dict, mpnet_dir: str, tmp: str) -> None:
    """train_main --hf_checkpoint_dir on the MPNet-base directory with the
    fused layer and loss: 12 steps at batch 32 quadruplets, every batch at
    S = 384; K2 and K3's backward launched exactly 12 and 1 times a step."""
    import torch

    from qst_tpu_torch.cli import train_main
    from qst_tpu_torch.data import ChunkStore

    data = f"{tmp}/long"
    write_long_chunks(data, 384, seed=31)
    counters = train_counters()
    before = [c.launches for c in counters]
    exp = f"{tmp}/exp_mpnet"
    argv = ["--dataset_root", data, "--experiment_dir", exp, "--hf_checkpoint_dir", mpnet_dir,
            "--use_fused_layer", "--use_fused_loss_kernel", "--hard_contrastive_mode", "-1",
            "--epochs", "1", "--evaluation_steps", "8", "--warmup_steps", "4",
            "--learning_rate", "2e-5", "--seed", "14", "--val_fraction", "0.05"]
    t0 = time.perf_counter()
    with logged("qst_tpu_torch.cli.train") as records:
        if train_main.main(argv) != 0:
            fail("train_main --hf_checkpoint_dir failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches - b for c, b in zip(counters, before)]
    with open(f"{exp}/train_loss.json") as f:
        losses = [e["loss"] for e in json.load(f)]
    steps = len(ChunkStore(data)) // 32
    done = [r for r in records if r.msg.startswith("done:")]
    steps_per_s = done[0].args[3] if done else float("nan")
    log(f"train_main --hf_checkpoint_dir (MPNet-base, 12 layers, S=384, batch 32 "
        f"quadruplets, bf16, dropout 0.1): {steps} steps in {wall:.1f} s ({steps_per_s:.2f} "
        f"steps/s in the loop), losses {['%.4f' % v for v in losses]}; launches "
        f"{dict(zip(COUNTED, launches))}")
    if not (losses and all(np.isfinite(losses))):
        fail(f"train_main --hf_checkpoint_dir: losses {losses}")
    if launches[1] != 12 * steps or launches[3] != steps or (launches[0] - 12 * steps) % 12:
        fail(f"train_main --hf_checkpoint_dir: launches {launches} for {steps} steps")
    add_train_launches(report, launches)
    report["mpnet"]["train_main"] = {"steps": steps, "wall_s": wall, "steps_per_s": steps_per_s,
                                     "losses": losses}


def mpnet_step_checks(report: dict, mpnet_dir: str) -> None:
    """On the MPNet-base directory's weights: one train step launches 12 K1,
    12 K2 and one K3 each way; at dropout 0 the first step's gradients,
    the relative-bias table among them, against the plain versions (cosine
    >= 0.999, per tensor <= 5e-2); and K = 4 steps a call captured, two
    calls (eager + capture, replay) bit-equal to 8 eager steps."""
    import dataclasses

    import torch

    from qst_tpu_torch.core.config import LossConfig, TrainConfig
    from qst_tpu_torch.models.hf_import import load_hf_checkpoint_dir
    from qst_tpu_torch.train import (create_train_state, dropout_key, make_multi_step,
                                     make_train_step)
    from qst_tpu_torch.train.train_step import encoder_apply_fn, loss_from_config

    dev = torch.device("cuda")
    cfg, sd, _ = load_hf_checkpoint_dir(mpnet_dir)
    cfg = dataclasses.replace(cfg, use_fused_layer=True)
    loss_cfg = LossConfig(kind="gamma", use_fused_kernel=True)
    base = TrainConfig(learning_rate=2e-5, warmup_steps=2)
    gen = torch.Generator().manual_seed(33)
    S = 384
    ids = torch.randint(8, 5008, (4, 32, S), generator=gen)
    lens = torch.randint(100, S + 1, (4, 32), generator=gen)
    mask = (torch.arange(S)[None, None, :] < lens[..., None]).long()
    ids = torch.where(mask > 0, ids, torch.zeros_like(ids))

    def state_for(c):
        return create_train_state(c, base, torch.Generator().manual_seed(14), 100, loss_cfg,
                                  initial_params={k: v.to(dev) for k, v in sd.items()},
                                  device=dev)[0]

    counters = train_counters()
    state = state_for(cfg)
    before = [c.launches for c in counters]
    state, loss = make_train_step(cfg, loss_cfg)(state, ids, mask, dropout_key(14, 1))
    torch.cuda.synchronize()
    one = [c.launches - b for c, b in zip(counters, before)]
    log(f"one MPNet-base train step (S={S}, batch 32 quadruplets, dropout 0.1): loss "
        f"{loss.item():.5f}, launches {dict(zip(COUNTED, one))} (want 12, 12, 1, 1)")
    if one != [12, 12, 1, 1] or not np.isfinite(loss.item()):
        fail(f"one MPNet-base train step: launches {one}, loss {loss.item()}")
    add_train_launches(report, one)
    del state

    # the first step's gradients at dropout 0: the kernels (bf16) against the
    # plain versions (bf16), and both against the plain versions in f32
    cfg0 = dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)
    state = state_for(cfg0)
    flat = (ids.reshape(128, S).to(dev), mask.reshape(128, S).to(dev))
    grads = []
    for plain, c in ((False, cfg0), (True, cfg0), (True, dataclasses.replace(cfg0,
                                                                             dtype="float32"))):
        state.model.zero_grad(set_to_none=True)
        with plain_kernels() if plain else contextlib.nullcontext():
            emb = encoder_apply_fn(c)(state.model, *flat, None).reshape(4, 32, -1)
            loss_from_config(loss_cfg)(*emb.unbind(0)).backward()
        torch.cuda.synchronize()
        grads.append({n: p.grad.detach().clone() for n, p in state.model.named_parameters()})
    kern, ref, f32 = grads
    cos = torch.nn.functional.cosine_similarity(
        torch.cat([g.flatten() for g in kern.values()]),
        torch.cat([g.flatten() for g in ref.values()]), dim=0).item()

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    # Per tensor |g_k - g_p| <= 5e-2 |g_p|, as the train phase holds, where
    # the plain bf16 gradient is itself within 2.5e-2 of the f32 one. Where
    # it is not, the tensor's gradient is bf16 rounding noise of a sum that
    # cancels (every row of dS sums to 0, and in the upper layers of a
    # random-init 12-layer encoder the tokens nearly coincide, so the
    # attention projections' gradients are sums of nearly opposite terms;
    # the key bias's is that noise alone): there the kernels' distance from
    # the f32 gradient is held to twice the plain versions' own
    worst, noisy, table = (0.0, ""), [], None
    for n, g in ref.items():
        e_kp, e_p32, e_k32 = rel(kern[n], g), rel(g, f32[n]), rel(kern[n], f32[n])
        if e_p32 <= 2.5e-2:
            worst = max(worst, (e_kp, n))
        else:
            noisy.append((n, e_k32, e_p32))
            if e_k32 > 2 * e_p32:
                fail(f"{n}: the kernels' gradient is {e_k32:.3e} from the f32 one, the plain "
                     f"versions' {e_p32:.3e}")
        if n == "encoder.relative_attention_bias.weight":
            table = (e_kp, e_k32, e_p32)
    log(f"MPNet-base first step's gradients (S={S}, dropout 0), kernels against plain "
        f"versions: cosine {cos:.6f} (limit 0.999), worst per-tensor |g_k - g_p|/|g_p| "
        f"{worst[0]:.3e} ({worst[1]}; limit 5e-2) over {len(ref) - len(noisy)} tensors; "
        f"relative-bias table {table[0]:.3e} (f32: kernels {table[1]:.3e}, plain "
        f"{table[2]:.3e}); {len(noisy)} tensors whose plain bf16 gradient is > 2.5e-2 from "
        f"the f32 one, distance from f32 kernels / plain: "
        + ", ".join(f"{n.removeprefix('encoder.layer.')} {a:.3f}/{b:.3f}" for n, a, b in noisy))
    if table is None or not (cos >= 0.999 and worst[0] <= 5e-2):
        fail("the MPNet kernel path's gradients disagree with the plain versions")
    report["mpnet"]["grad_cosine"] = cos
    report["mpnet"]["rel_table_grad_rel_err"] = table[0]
    report["mpnet"]["noise_dominated_grads"] = len(noisy)
    del state, grads, kern, ref, f32

    # K = 4 steps a call captured against eager steps, S = 128
    K, Sc = 4, 128
    cids = ids[..., :Sc].expand(2 * K, 4, 32, Sc).contiguous()
    cmask = mask[..., :Sc].expand(2 * K, 4, 32, Sc).contiguous()
    keys = torch.stack([dropout_key(14, s) for s in range(1, 2 * K + 1)])
    graph_st, eager_st = state_for(cfg), state_for(cfg)
    multi = make_multi_step(cfg, loss_cfg, None, K)
    graph_losses = []
    for call in range(2):
        part = slice(call * K, (call + 1) * K)
        graph_st, losses = multi(graph_st, cids[part], cmask[part], keys[part])
        graph_losses.append(losses)
    step = make_train_step(cfg, loss_cfg)
    eager_losses = []
    for j in range(2 * K):
        eager_st, loss = step(eager_st, cids[j], cmask[j], keys[j])
        eager_losses.append(loss)
    torch.cuda.synchronize()
    graph_losses, eager_losses = torch.cat(graph_losses), torch.stack(eager_losses)
    tensors = list(zip(graph_st.optimizer.state_tensors(), eager_st.optimizer.state_tensors()))
    unequal = sum(not torch.equal(a, b) for a, b in tensors)
    same = torch.equal(graph_losses, eager_losses)
    log(f"MPNet-base captured steps (S={Sc}, dropout 0.1): 2 calls of {K} against {2 * K} "
        f"eager steps: losses {'bit-equal' if same else 'DIFFER'}, {len(tensors) - unequal} "
        f"of {len(tensors)} state tensors bit-equal")
    if multi._graph is None or not same or unequal:
        fail("MPNet-base: the captured steps differ from the eager ones")
    report["mpnet"]["captured_bit_equal"] = True


def mpnet_ir_eval(report: dict, mpnet_dir: str, tmp: str) -> None:
    """ir_eval_main --hf_checkpoint_dir on the evaluate phase's 11,200
    instances: the baseline is the MPNet-base directory; its dot search
    one K4 and one K5 launch at D = 768."""
    big = quadruplet_set(11200, 21)
    run = ir_eval_run(report, big, None, f"{tmp}/ir_mpnet", "exact",
                      extra=["--hf_checkpoint_dir", mpnet_dir])
    report["mpnet"]["ir_eval_main_s"] = run["wall_s"]
    report["mpnet"]["ir_eval_map100"] = {
        f: m["map@100"] for f, m in run["results"]["baseline"]["metrics"].items()}


MPNET_PROFILED_STEPS = 4     # the MPNet-base train step's profiled steps a turn


def mpnet_times(report: dict) -> None:
    """K1 and K2 at MPNet-base (S = 128 and 384) and MiniLM-L6 (S = 128 and
    256) beside their bounds and plain versions; encode sentences/s at
    B = 256, S = 128 and 384, fused against nn.Module; the MPNet-base train
    step (batch 32 quadruplets, S = 128) through the kernels and the
    nn.Module path, with the device's busy share."""
    import dataclasses

    import torch
    from torch.profiler import profile

    from qst_tpu_torch.core.config import EncoderConfig, LossConfig, TrainConfig
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule, embed_fn, init_params
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.train import create_train_state, dropout_key, make_train_step

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(37)
    layers = {}
    for label, H, F, NH, S, rel in (("MPNet-base S=128", 768, 3072, 12, 128, True),
                                    ("MPNet-base S=384", 768, 3072, 12, 384, True),
                                    ("MiniLM-L6 S=128", 384, 1536, 12, 128, False),
                                    ("MiniLM-L6 S=256", 384, 1536, 12, 256, False)):
        w = lecun_layer(H, F, torch.bfloat16, gen, dev)
        w.update(wqkv=torch.cat([w["wq"], w["wk"], w["wv"]], 1),
                 bqkv=torch.cat([w["bq"], w["bk"], w["bv"]], 1))
        rb = random_rel(NH, S, gen, dev) if rel else None
        row = {}
        for kernel, B in (("K1", 256), ("K2", 128)):
            x = torch.randn((B, S, H), generator=gen).to(dev, torch.bfloat16)
            bias = torch.zeros((B, S), device=dev)
            M = B * S
            ops = 2.0 * M * (4 * H * H + 2 * H * F) + 4.0 * B * S * S * H
            wbytes = 2 * (4 * H * H + 2 * H * F) + 4 * (9 * H + F) + (4 * NH * S * S if rel else 0)
            if kernel == "K1":
                fn = lambda: fl.fused_bert_layer(x, bias, w, num_heads=NH, rel_bias=rb)  # noqa
                plain = lambda: fl.fused_bert_layer_plain(x, bias, w, num_heads=NH,  # noqa
                                                          rel_bias=rb)
                b = bound(2 * M * H * 2 + wbytes + B * S * 4, ops, "bfloat16")
            else:
                # the training path's K2, dropout 0.1, as the times phase runs it
                g = torch.randn((B, S, H), generator=gen).to(dev, torch.bfloat16)
                drop = dict(num_heads=NH, rel_bias=rb, attn_dropout=0.1, hidden_dropout=0.1,
                            seed=torch.tensor([5], dtype=torch.int32, device=dev))
                fn = lambda: fl.fused_bert_layer_bwd(x, bias, w, g, **drop)  # noqa: E731
                plain = lambda: fl.fused_bert_layer_bwd_plain(x, bias, w, g, **drop)  # noqa
                gbytes = 4 * (4 * H * H + 2 * H * F + 9 * H + F) + (4 * NH * S * S if rel else 0)
                b = bound(3 * M * H * 2 + wbytes + gbytes, 3 * ops, "bfloat16")
            ms = cuda_ms(fn, 10)
            pms = cuda_ms(plain, 2)
            row[kernel] = dict(B=B, ms=ms, plain_ms=pms, **b, share=b["bound_ms"] / ms)
            del x
        layers[label] = row
        log(f"{label}: K1 (B=256) {row['K1']['ms']:.3f} ms (bound {row['K1']['bound_ms']:.3f}, "
            f"{100 * row['K1']['share']:.0f}%; plain {row['K1']['plain_ms']:.2f}), K2 (B=128, "
            f"dropout 0.1) "
            f"{row['K2']['ms']:.3f} ms (bound {row['K2']['bound_ms']:.3f}, "
            f"{100 * row['K2']['share']:.0f}%; plain {row['K2']['plain_ms']:.2f})")
    for kernel in ("K1", "K2"):
        report[kernel]["mpnet_long_s"] = {lab: r[kernel] for lab, r in layers.items()}

    # encode sentences/s, MPNet-base, B = 256
    cfg = EncoderConfig.mpnet_base()
    sd = init_params(cfg, torch.Generator().manual_seed(3), device=dev)
    model = SentenceEncoderModule(cfg).to(dev)
    model.load_state_dict(sd)
    model.eval()
    encode = {}
    for S in (128, 384):
        ids = torch.randint(8, cfg.vocab_size, (256, S), generator=gen).to(dev)
        mask = torch.ones_like(ids)
        rates = {}
        for name in ("fused", "module", "module", "fused"):
            fwd = embed_fn(dataclasses.replace(cfg, use_fused_layer=name == "fused"))
            ms = cuda_ms(lambda: fwd(model, ids, mask), 5)
            rates.setdefault(name, []).append(256 / ms * 1e3)
        encode[S] = rates
        rates["bound"] = 256 / (12 * layers[f"MPNet-base S={S}"]["K1"]["bound_ms"]) * 1e3
        fused = embed_fn(dataclasses.replace(cfg, use_fused_layer=True))
        ban_library_kernels(kernel_names(lambda: fused(model, ids, mask)),
                            f"the MPNet-base encode at S={S}")
        log(f"MPNet-base encode, B=256, S={S}: sentences/s fused {rates['fused']}, nn.Module "
            f"{rates['module']} (bound {rates['bound']:.0f})")
    report["mpnet"]["encode_sentences_per_s"] = encode
    del model

    # the train step, batch 32 quadruplets, S = 128: kernels and nn.Module in turns
    loss_cfg = LossConfig(kind="gamma", use_fused_kernel=True)
    ids = torch.randint(8, cfg.vocab_size, (4, 32, 128), generator=gen).to(dev)
    mask = torch.ones_like(ids)
    steps = {}
    for name in ("kernels", "module", "module", "kernels"):
        c = dataclasses.replace(cfg, use_fused_layer=name == "kernels")
        lc = dataclasses.replace(loss_cfg, use_fused_kernel=name == "kernels")
        state, _ = create_train_state(c, TrainConfig(), torch.Generator().manual_seed(14), 100,
                                      lc, initial_params=sd, device=dev)
        step = make_train_step(c, lc)
        for i in range(3):
            state, _ = step(state, ids, mask, dropout_key(14, i + 1))
        torch.cuda.synchronize()
        with profile(activities=device_activity()) as prof:
            t0 = time.perf_counter()
            for i in range(MPNET_PROFILED_STEPS):
                state, _ = step(state, ids, mask, dropout_key(14, i + 4))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / MPNET_PROFILED_STEPS
        dev_ms = sum(device_us(e) for e in prof.key_averages()
                     if e.device_type.name == "CUDA"
                     and not getattr(e, "is_user_annotation", False)
                     and not e.key.startswith("Optimizer.")) / 1e3 / MPNET_PROFILED_STEPS
        if name == "kernels":
            ban_library_kernels({e.key: 0 for e in prof.key_averages()
                                 if e.device_type.name == "CUDA"}, "the MPNet-base train step")
        steps.setdefault(name, []).append({"ms": wall, "device_ms": dev_ms,
                                           "busy": dev_ms / wall})
        del state
    # bound: 12 x (K1 + K2 at B=128, S=128) and AdamW over the f32 parameters
    k1_128 = layers["MPNet-base S=128"]["K1"]["bound_ms"] / 2
    n_params = sum(v.numel() for v in sd.values())
    step_bound = 12 * (k1_128 + layers["MPNet-base S=128"]["K2"]["bound_ms"]) + \
        n_params * 4 * 6 / HBM_BYTES_PER_S * 1e3
    log(f"MPNet-base train step (batch 32 quadruplets, S=128, bf16, dropout 0.1): kernels "
        f"{[round(s['ms'], 2) for s in steps['kernels']]} ms (busy "
        f"{[round(s['busy'], 3) for s in steps['kernels']]}), nn.Module "
        f"{[round(s['ms'], 2) for s in steps['module']]} ms (busy "
        f"{[round(s['busy'], 3) for s in steps['module']]}); bound {step_bound:.2f} ms")
    report["mpnet"]["train_step"] = dict(steps, bound_ms=step_bound)


def mpnet(report: dict) -> None:
    """K1 with MPNet's relative bias and K2 with drel up to S = 512 against
    their plain versions; checkpoint directories written and loaded at full
    width; train_main and ir_eval_main on the MPNet-base directory; times."""
    import tempfile

    report.setdefault("mpnet", {})
    parts, t0 = {}, time.perf_counter()

    def done(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    check_mpnet_kernels(report)
    done("kernels")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_checkpoint_dirs(tmp)
        done("write directories")
        encode_checkpoint_dirs(report, dirs)
        done("encode directories")
        mpnet_step_checks(report, dirs["mpnet"])
        done("step checks")
        mpnet_train_main(report, dirs["mpnet"], tmp)
        done("train_main")
        mpnet_ir_eval(report, dirs["mpnet"], tmp)
        done("ir_eval_main")
    mpnet_times(report)
    done("times")
    report["mpnet"]["part_s"] = parts
    log("mpnet phase by part (s): " + ", ".join(f"{n} {v:.1f}" for n, v in parts.items()))


# --------------------------------------------------------------------- pq
PQ_ROWS = 1 << 22            # the scale part's corpus: 4,194,304 rows of D = 384
PQ_CELLS = 4096              # IVF-PQ cells at that size (1,024 rows a cell)
STREAM_ROWS = (1 << 21) + (1 << 19) - 3000   # the streamed memmap: both tile sizes leave a
                                             # ragged tile
GEN_CHUNK = 1 << 20          # rows the corpus generator makes at a time
PQ_QUERIES = 256
PQ_CLI_DOCS = 65536          # the ivf phase's corpus


def clustered_chunks(n: int, seed: int, dim: int = 384, rank: int = 64, noise: float = 0.35):
    """``benchmarks/ivfpq_bench.py``'s clustered generator in torch, on the
    card: each row is a latent cluster center (max(65,536, n/32) of them)
    plus N(0, noise²) latent noise through one fixed rank-64 projection,
    plus N(0, 0.05²) noise per dimension (within-cluster cosine about
    0.89). Yields (first row, (rows, dim) f32 chunk), GEN_CHUNK rows at a
    time, each chunk made from (seed, chunk index) alone."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_centers = max(1 << 16, n // 32)
    w = torch.randn((rank, dim), device="cuda", generator=gen) / 8
    centers = torch.randn((n_centers, rank), device="cuda", generator=gen)
    for lo in range(0, n, GEN_CHUNK):
        rows = min(GEN_CHUNK, n - lo)
        g = torch.Generator(device="cuda").manual_seed(seed * 7919 + 1 + lo // GEN_CHUNK)
        cid = torch.randint(0, n_centers, (rows,), device="cuda", generator=g)
        lat = centers[cid] + noise * torch.randn((rows, rank), device="cuda", generator=g)
        yield lo, lat @ w + 0.05 * torch.randn((rows, dim), device="cuda", generator=g)


def launch_counts():
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import ivf as ops_ivf
    from qst_tpu_torch.ops import topk

    return {"K1": fl.fused_bert_layer, "K4": topk.bucket_maxima, "K5": topk.rescore_buckets,
            "K6": ops_ivf.ivf_cell_scores}


def reset_counts() -> None:
    for fn in launch_counts().values():
        fn.launches = 0


def read_counts() -> dict:
    return {n: fn.launches for n, fn in launch_counts().items()}


def add_launches(report: dict, counts: dict) -> None:
    for n in ("K4", "K5"):
        report[n]["launches"] = report[n].get("launches", 0) + counts[n]


def expect_launches(what: str, counts: dict, k4: int) -> None:
    """K4 and K5 each launched exactly ``k4`` times (a search through the
    kernels launches one of each a slice or tile)."""
    if counts["K4"] != k4 or counts["K5"] != k4:
        fail(f"{what}: K4 / K5 launched {counts['K4']} / {counts['K5']} times, "
             f"{k4} each accounted for")


RELOAD_SCRIPT = """
import contextlib, io, json, sys
from qst_tpu_torch.cli import index_main
from qst_tpu_torch.ops import topk
argv, kinds = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}
for name, flags in kinds.items():
    topk.bucket_maxima.launches = topk.rescore_buckets.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = index_main.main(["query", *flags, *argv])
    out[name] = {"rc": rc, "K4": topk.bucket_maxima.launches,
                 "K5": topk.rescore_buckets.launches,
                 "rows": [json.loads(l) for l in buf.getvalue().splitlines() if l.startswith("{")]}
print("RELOADED " + json.dumps(out))
"""


class CandidateScores:
    """The true scores of each query's candidates only, indexed like a
    (Q, N) score matrix by ``[row, ids]`` (the ties check reads no other):
    for corpora whose (Q, N) matrix would not fit in memory."""

    def __init__(self, ids, scores):
        self.rows = [dict(zip(i.tolist(), s.tolist())) for i, s in
                     zip(np.asarray(ids), np.asarray(scores))]

    def __getitem__(self, key):
        if isinstance(key, slice):          # rows, as rows_match_up_to_ties reads them
            out = CandidateScores.__new__(CandidateScores)
            out.rows = self.rows[key]
            return out
        row, ids = key
        return np.array([self.rows[row][int(j)] for j in np.atleast_1d(ids)], np.float32)


def hits_of(rows, k: int):
    """(scores, ids) of index_main query's printed rows."""
    return (np.array([[h["score"] for h in r["hits"][:k]] for r in rows]),
            np.array([[h["id"] for h in r["hits"][:k]] for r in rows]))


def pq_cli(report: dict) -> tuple:
    """index_main build | serve | query for pq (m 48, refine rows),
    ivfpq at 8 and 4 bits and streaming over the ivf phase's 65,536 docs,
    256 queries a batch (so "auto" takes K4 + K5 for pq and streaming); then
    starts the fresh process that reloads and queries the four saved
    indexes. → (that process, each kind's query rows) for ``check_reload``."""
    import io

    import torch

    from qst_tpu_torch.cli import index_main
    from qst_tpu_torch.ops.distances import l2_normalize
    from qst_tpu_torch.retrieval import IVFPQIndex, PQIndex, StreamingExactIndex

    docs = synthetic_docs(PQ_CLI_DOCS, seed=14)
    rng = np.random.default_rng(21)
    queries = [docs[j] for j in rng.integers(0, len(docs), 128)] + synthetic_docs(128, seed=98)
    encoder_flags = ["--encoder_preset", "minilm-l6", "--use_fused_layer", "--seed", "14"]
    kinds = {"pq": ["--index_dtype", "pq"], "ivfpq8": ["--index_dtype", "ivfpq"],
             "ivfpq4": ["--index_dtype", "ivfpq"], "streaming": ["--index_dtype", "streaming"]}
    types = {"pq": PQIndex, "ivfpq8": IVFPQIndex, "ivfpq4": IVFPQIndex,
             "streaming": StreamingExactIndex}
    # searches through the kernels: pq's one 2M-row slice and streaming's one
    # tile, once served and once queried
    through_kernels = {"pq": 2, "ivfpq8": 0, "ivfpq4": 0, "streaming": 2}
    out = {}
    tmp = work_dir("pq_cli")        # the indexes outlive this part: reloaded below
    texts = f"{tmp}/docs.txt"
    with open(texts, "w") as f:
        f.write("\n".join(docs) + "\n")
    for name, kind_flags in kinds.items():
        index_dir = f"{tmp}/{name}"
        kinds[name] = kind_flags = kind_flags + ["--index_dir", index_dir]
        reset_counts()
        t0 = time.perf_counter()
        if index_main.main(["build", "--texts", texts, *kind_flags, "--pq_m", "48",
                            "--ivf_clusters", "256", "--ivf_probe", "8", "--ivfpq_bits",
                            "4" if name == "ivfpq4" else "8", *encoder_flags]) != 0:
            fail(f"index_main build --index_dtype {name} failed")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        args = index_main.build_parser().parse_args(
            ["serve", *kind_flags, "--port", "0", "--max_wait_ms", "200", *encoder_flags])
        retr = index_main.serving_retriever(args)
        index = retr.index
        if not isinstance(index, types[name]) or index.n_docs != len(docs):
            fail(f"serve --index_dtype {name} loaded {type(index).__name__}")
        seen = {}
        encode = retr.encoder.encode

        def recording_encode(texts, batch_size=256, convert_to_numpy=True):
            got = encode(texts, batch_size=batch_size, convert_to_numpy=convert_to_numpy)
            for t, row in zip(texts, got):
                seen.setdefault(t, row)
            return got

        retr.encoder.encode = recording_encode
        server = index_main.serving_server(args, retr)
        port = server.start()
        try:
            served = post(port, "/search", {"queries": queries, "k": 10})["results"]
            batches = server._search_batcher.stats()["max_batch"]
        finally:
            server.stop()
        retr.encoder.encode = encode
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = index_main.main(["query", *kind_flags, "--k", "10", "--queries", *queries,
                                  *encoder_flags])
        rows = [json.loads(line) for line in printed.getvalue().splitlines()
                if line.startswith("{")]
        counts = read_counts()
        if rc != 0 or len(rows) != len(queries) or batches != len(queries):
            fail(f"{name}: query rc {rc}, {len(rows)} rows; the server's largest batch "
                 f"{batches} of {len(queries)} queries")
        expect_launches(f"index_main serve + query --index_dtype {name}", counts,
                        through_kernels[name])
        if counts["K1"] <= 0:
            fail(f"{name}: K1 was never launched by build + serve + query")
        add_launches(report, counts)
        report["K1"]["launches"] = report["K1"].get("launches", 0) + counts["K1"]

        # the served rows (k 10 of a k = 16 search: the server buckets k)
        # and the query command's against the index's plain path over
        # the same embeddings, scores to 1e-4, ids up to ties
        q_emb = torch.stack([seen[q] for q in queries])
        if name == "streaming":
            sent = torch.cat([l2_normalize(torch.from_numpy(np.asarray(
                index.embeddings[lo:lo + 16384])).cuda().to(torch.bfloat16).float())
                .to(torch.bfloat16) for lo in range(0, index.n_docs, 16384)])
            true = (l2_normalize(q_emb.float()).to(torch.bfloat16).float()
                    @ sent.float().T).cpu().numpy()
            plain = {k: index.search(q_emb, k=k, backend="xla") for k in (16, 10)}
        else:
            rows_f32 = torch.from_numpy(index.refine_rows_f32()).cuda()
            true = (l2_normalize(q_emb.float()) @ rows_f32.T).cpu().numpy()
            if name == "pq":
                plain = {k: index.search(q_emb, k=k, backend="xla") for k in (16, 10)}
            else:      # IVF-PQ answers id lists, None where cells ran out
                plain = {}
                for k in (16, 10):
                    s, ids = index.search(q_emb, k=k)
                    plain[k] = (s, np.array([[-1 if j is None else j for j in r]
                                             for r in ids]))
        ss = np.array([[r[1] for r in row] for row in served])
        si = np.array([[r[0] for r in row] for row in served])
        ps, pi = plain[16]
        if not ids_match_up_to_ties(ss, si, ps[:, :10], pi[:, :10], true, 1e-4):
            fail(f"{name}: served answers differ from the index's plain path")
        qs, qi = hits_of(rows, 10)
        if not ids_match_up_to_ties(qs, qi, *plain[10], true, 1e-4 + 5e-5):
            fail(f"{name}: index_main query's hits differ from the index's plain path")
        out[name] = {"build_s": build_s, "K4": counts["K4"], "K5": counts["K5"],
                     "query_rows": rows}
        log(f"index_main --index_dtype {name}: {len(docs)} docs built in {build_s:.1f} s "
            f"({type(index).__name__}); /search of {len(queries)} queries in one batch and "
            f"query match the plain path (scores 1e-4); K4 / K5 launches {counts['K4']} / "
            f"{counts['K5']} as accounted")
        del retr, index

    # each saved index reloaded in a fresh process (from the checkout root);
    # a check of answers, not of time, so it runs while the scale parts do
    import qst_tpu_torch

    proc = subprocess.Popen(
        [sys.executable, "-c", RELOAD_SCRIPT,
         json.dumps(["--k", "10", "--queries", *queries, *encoder_flags]), json.dumps(kinds)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(qst_tpu_torch.__file__))))
    report["pq"]["cli"] = {n: {k: v for k, v in o.items() if k != "query_rows"}
                           for n, o in out.items()}
    return proc, {n: (o["query_rows"], through_kernels[n]) for n, o in out.items()}


def check_reload(report: dict, proc, want: dict) -> None:
    """The fresh process of ``pq_cli``: each kind's hits those of the query
    command before, and its launches one search's."""
    try:
        text = proc.communicate(timeout=600)[0]
    except subprocess.TimeoutExpired:
        fail("the fresh-process reload ran past 600 s")
    line = [ln for ln in text.splitlines() if ln.startswith("RELOADED ")]
    if proc.returncode != 0 or not line:
        fail(f"the fresh-process reload failed: {text[-3000:]}")
    reloaded = json.loads(line[0][len("RELOADED "):])
    for name, got in reloaded.items():
        rows, through = want[name]
        have, expect = hits_of(got["rows"], 10), hits_of(rows, 10)
        if got["rc"] != 0 or not (np.allclose(have[0], expect[0], atol=1e-4, rtol=0)
                                  and np.array_equal(have[1], expect[1])):
            fail(f"{name}: the index reloaded in a fresh process answers otherwise")
        expect_launches(f"{name} reloaded in a fresh process", got, through // 2)
        add_launches(report, got)
    log("the four saved indexes reloaded in a fresh process: the same hits, K4 / K5 "
        f"launches {[(n, g['K4']) for n, g in reloaded.items()]}")


def recall_at(got_ids, truth_ids) -> float:
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(
        np.asarray(got_ids).tolist(), np.asarray(truth_ids).tolist())]))


def full_probe_golden(idx, queries, k: int):
    """The exact top-k over an IVF-PQ index's reconstructions in its
    search's own arithmetic (queries and decoded residuals in the compute
    dtype, bf16 on the card, products summed in f32, the centroid term in
    f32), cell by cell over the whole index: → (scores (Q, k), positions
    (Q, k))."""
    import torch

    from qst_tpu_torch.ops.distances import l2_normalize
    from qst_tpu_torch.retrieval.ivfpq import _compute_dtype, _decode_any

    C, L, m = idx.cell_codes.shape
    cd = _compute_dtype(idx.device)
    qf = l2_normalize(queries.float())
    qb = qf.to(cd).float()
    psim = qf @ idx.centroids.T                                     # (Q, C)
    cb = idx.codebooks.to(cd).float()
    cs = torch.full((qf.shape[0], k), float("-inf"), device="cuda")
    ci = torch.full((qf.shape[0], k), -1, dtype=torch.int64, device="cuda")
    step = max(1, (1 << 18) // L)
    for c0 in range(0, C, step):
        codes = idx.cell_codes[c0:c0 + step].reshape(-1, m)
        ids = idx.cell_ids[c0:c0 + step].reshape(-1).long()
        s = qb @ _decode_any(codes, cb, idx.bits).T
        if idx.residual:
            s = s + psim[:, c0:c0 + step].repeat_interleave(L, dim=1)
        s = torch.where(ids[None, :] >= 0, s, float("-inf"))
        cs, pos = torch.topk(torch.cat([cs, s], 1), k, dim=1)
        ci = torch.gather(torch.cat([ci, ids[None, :].expand(qf.shape[0], -1)], 1), 1, pos)
    return cs, ci


def ivfpq_candidate_scores(idx, queries, cand: np.ndarray) -> CandidateScores:
    """The scores of the docs ``cand`` names, from their codes: each doc's
    slot found in the cell table, its reconstruction decoded by the one-hot
    products (not the search's gather) and scored in the search's
    arithmetic, the centroid term of its cell added."""
    import torch

    from qst_tpu_torch.ops.distances import l2_normalize
    from qst_tpu_torch.retrieval.ivfpq import _compute_dtype, _decode_any

    C, L, m = idx.cell_codes.shape
    flat_ids = idx.cell_ids.reshape(-1).long()
    slot = torch.full((idx.n_docs,), -1, dtype=torch.int64, device="cuda")
    valid = flat_ids >= 0
    slot[flat_ids[valid]] = torch.arange(C * L, device="cuda")[valid]
    pos = slot[torch.from_numpy(cand).cuda()]                       # (Q, n)
    if bool((pos < 0).any()):
        fail("IVF-PQ: an answer names a doc that no cell holds")
    cd = _compute_dtype(idx.device)
    qf = l2_normalize(queries.float())
    dec = _decode_any(idx.cell_codes.reshape(C * L, m)[pos.reshape(-1)],
                      idx.codebooks.to(cd), idx.bits, "onehot").float()
    got = torch.einsum("qd,qnd->qn", qf.to(cd).float(), dec.reshape(*pos.shape, -1))
    if idx.residual:
        got = got + torch.gather(qf @ idx.centroids.T, 1, pos // L)
    return CandidateScores(cand, got.cpu().numpy())


def pq_scale(report: dict) -> None:
    """PQIndex and IVFPQIndex at MiniLM-L6's width over PQ_ROWS clustered
    rows made on the card: the kernels' path (two 2M-row slices through
    topk_local) against the plain scan; IVF-PQ at 8 and 4 bits with recall,
    ms and QPS, and its full probe against the exact top-k over its
    reconstructions."""
    import torch

    from qst_tpu_torch.ops import topk
    from qst_tpu_torch.ops.distances import l2_normalize
    from qst_tpu_torch.retrieval import ExactIndex, IVFPQIndex, PQIndex
    from qst_tpu_torch.retrieval import pq as pq_mod

    n, D, k = PQ_ROWS, 384, 10
    t0 = time.perf_counter()
    rows = torch.empty((n, D), device="cuda")
    for lo, chunk in clustered_chunks(n, seed=31):
        rows[lo:lo + chunk.shape[0]] = l2_normalize(chunk)
    gen = torch.Generator(device="cuda").manual_seed(32)
    pick = torch.randint(0, GEN_CHUNK, (4096,), device="cuda", generator=gen)
    queries = l2_normalize(rows[pick] + 0.03 * torch.randn((4096, D), device="cuda",
                                                           generator=gen))
    torch.cuda.synchronize()
    log(f"pq scale: {n} clustered unit rows of D = {D} made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    res = {"rows": n}
    exact = ExactIndex(rows, dtype="bfloat16", device="cuda")
    _, truth = exact.search(queries[:PQ_QUERIES], k=k, score="dot_score", backend="xla")
    del exact
    torch.cuda.empty_cache()

    # PQIndex, m = 48: the kernels' path against the plain scan
    t0 = time.perf_counter()
    pq = PQIndex(rows, m=48, device="cuda")
    torch.cuda.synchronize()
    res["pq_build_s"] = time.perf_counter() - t0
    n_slices = -(-pq.codes.shape[0] // pq_mod.PQ_SUPER_TILE)
    for Q in (PQ_QUERIES, 4096):
        q = queries[:Q]
        reset_counts()
        fs, fi = pq._device_search(q, k, "dot_score", 0, "auto")
        torch.cuda.synchronize()
        counts = read_counts()
        expect_launches(f"PQIndex search Q={Q} over {n} rows", counts, n_slices)
        add_launches(report, counts)
        xs, xi = pq._device_search(q, k, "dot_score", 0, "xla")
        # the true scores of both answers' docs decide ties: the query
        # against each doc's decoded row, both in the compute dtype (bf16)
        cd = pq_mod._compute_dtype(pq.device)
        cand = torch.cat([fi, xi], 1)
        recon = pq_mod._decode_rows(pq.codes[cand.reshape(-1)], pq.codebooks.to(cd), "gather")
        picked = torch.einsum("qd,qkd->qk", l2_normalize(q.float()).to(cd).float(),
                              recon.float().reshape(Q, 2 * k, D))
        true = CandidateScores(cand.cpu().numpy(), picked.cpu().numpy())
        fs_, fi_, xs_, xi_ = (t.cpu().numpy() for t in (fs, fi, xs, xi))
        if not ids_match_up_to_ties(fs_, fi_, xs_, xi_, true, 1e-4):
            fail(f"PQIndex Q={Q}: the kernels' path and the plain scan disagree")
        err = float(np.abs(fs_ - xs_).max())
        fused_ms = cuda_ms(lambda: pq._device_search(q, k, "dot_score", 0, "pallas"), 3)
        scan_ms = cuda_ms(lambda: pq._device_search(q, k, "dot_score", 0, "xla"), 1)
        res[f"pq_q{Q}"] = {"fused_ms": fused_ms, "scan_ms": scan_ms, "max_abs_err": err,
                           "fused_qps": Q / fused_ms * 1e3, "K4_launches": counts["K4"]}
        if Q == PQ_QUERIES:
            res["pq_recall_at_10_raw"] = recall_at(fi_, truth)
        log(f"PQIndex m=48 over {n} rows, Q={Q}, k={k}: {n_slices} slices through K4 + K5 "
            f"{fused_ms:.2f} ms ({Q / fused_ms * 1e3:.0f} QPS) against the plain scan "
            f"{scan_ms:.2f} ms; answers equal up to ties, max|score diff| {err:.2e} (limit 1e-4)")
    log(f"PQIndex raw recall@10 against exact (Q={PQ_QUERIES}): {res['pq_recall_at_10_raw']:.4f}")
    del pq, recon
    torch.cuda.empty_cache()

    # IVFPQIndex, C = PQ_CELLS, at 8 and 4 bits with int8 refine rows
    q = queries[:PQ_QUERIES]
    for bits in (8, 4):
        t0 = time.perf_counter()
        idx = IVFPQIndex(rows, n_clusters=PQ_CELLS, m=48, bits=bits, keep_rows="int8",
                         device="cuda")
        torch.cuda.synchronize()
        row = {"build_s": time.perf_counter() - t0, "cell_budget": idx.cell_budget,
               "spilled": idx.spilled}
        for n_probe in (8, 16, 32):
            reset_counts()
            s_raw, got_raw = idx.search(q, k=k, n_probe=n_probe, refine_factor=0)
            s_ref, got_ref = idx.search(q, k=k, n_probe=n_probe, refine_factor=8)
            if read_counts()["K4"]:
                fail("IVF-PQ search launched K4")
            ms = cuda_ms(lambda: idx._device_search(q, k, n_probe), 2)
            t1 = time.perf_counter()
            idx.search(q, k=k, n_probe=n_probe, refine_factor=8)
            ref_ms = (time.perf_counter() - t1) * 1e3
            ids = lambda g: [[-1 if j is None else j for j in r] for r in g]  # noqa: E731
            row[f"n_probe_{n_probe}"] = {
                "recall_at_10_raw": recall_at(ids(got_raw), truth),
                "recall_at_10_refined_x8": recall_at(ids(got_ref), truth),
                "ms": ms, "qps": PQ_QUERIES / ms * 1e3, "refined_ms": ref_ms,
                "refined_qps": PQ_QUERIES / ref_ms * 1e3}
            r = row[f"n_probe_{n_probe}"]
            log(f"IVFPQIndex bits={bits} C={PQ_CELLS} L={idx.cell_budget} n_probe={n_probe}: "
                f"recall@10 raw {r['recall_at_10_raw']:.4f}, refined x8 "
                f"{r['recall_at_10_refined_x8']:.4f}; Q={PQ_QUERIES}: {ms:.2f} ms = "
                f"{r['qps']:.0f} QPS on the card, refined {ref_ms:.2f} ms = "
                f"{r['refined_qps']:.0f} QPS end to end")
        # full probe = the exact top-k over the reconstructions
        qf = q[:32]
        fs, fi = idx._device_search(qf, k, PQ_CELLS)
        gs, gi = full_probe_golden(idx, qf, k)
        fs_, fi_, gs_, gi_ = (t.cpu().numpy() for t in (fs, fi, gs, gi))
        true = ivfpq_candidate_scores(idx, qf, np.concatenate([fi_, gi_], 1))
        if not ids_match_up_to_ties(fs_, fi_, gs_, gi_, true, 1e-4):
            fail(f"IVF-PQ bits={bits}: the full probe differs from the exact top-k over the "
                 f"reconstructions")
        row["full_probe_max_abs_err"] = float(np.abs(fs_ - gs_).max())
        log(f"IVFPQIndex bits={bits}: full probe ({PQ_CELLS} cells) equals the exact top-10 over "
            f"the reconstructions for 32 queries, max|diff| {row['full_probe_max_abs_err']:.2e} "
            f"(limit 1e-4); built in {row['build_s']:.1f} s, spilled {idx.spilled}")
        res[f"ivfpq{bits}"] = row
        del idx
        torch.cuda.empty_cache()

    # the decode of one 2M-row slice, which the kernels' path runs before
    # K4: the port's gather (one index a 16-byte codeword), the row gather it
    # replaced (rows of 8 bf16 elements), the same rows as two 8-byte words
    # and through F.embedding, beside the bytes it must move (codes in, bf16
    # rows out)
    slice_rows = pq_mod.PQ_SUPER_TILE
    pq = PQIndex.from_codes(torch.randint(0, 256, (slice_rows, 48), dtype=torch.uint8,
                                          device="cuda", generator=gen),
                            torch.randn((48, 256, 8), device="cuda", generator=gen))
    cb = pq.codebooks.to(torch.bfloat16)
    flat = (pq.codes.long() + torch.arange(48, device="cuda") * 256)
    forms = {"gather": lambda: pq_mod._decode_rows(pq.codes, cb, "gather"),
             "element_gather": lambda: cb.reshape(-1, 8)[flat],
             "int64_words": lambda: cb.reshape(-1, 8).view(torch.int64)[flat].view(torch.bfloat16),
             "embedding": lambda: torch.nn.functional.embedding(flat, cb.reshape(-1, 8))}
    want = forms["element_gather"]().reshape(slice_rows, D)
    for name, f in forms.items():
        if not torch.equal(f().reshape(slice_rows, D).view(torch.int16), want.view(torch.int16)):
            fail(f"the {name} decode of a {slice_rows}-row slice differs from the "
                 "element-wise gather")
    decode = {n: cuda_ms(f, 3) for n, f in forms.items()}
    decode.update(bound(slice_rows * 48 + slice_rows * D * 2, 0, "bfloat16"))
    res["decode_2m_rows"] = decode
    log(f"decode of one {slice_rows}-row slice (m = 48, bf16 rows): "
        + ", ".join(f"{n} {decode[n]:.2f} ms" for n in forms)
        + f"; bound {decode['bound_ms']:.3f} ms by bytes")
    del pq, cb, flat

    # K4 and K5 at the kernels' path's shapes: one decoded 2M-row bf16 slice
    tile = rows[:slice_rows].to(torch.bfloat16)
    del rows
    torch.cuda.empty_cache()
    shapes = {}
    for Q, kk in ((PQ_QUERIES, 80), (4096, 10)):
        qb = queries[:Q].to(torch.bfloat16)
        k4 = {"ms": cuda_ms(lambda: topk.bucket_maxima(qb, tile, slice_rows - 77), 10)}
        k4.update(bound(slice_rows * D * 2 + Q * D * 2 + Q * (slice_rows // 128) * 4,
                        2.0 * Q * slice_rows * D, "bfloat16"))
        k4["plain_ms"] = cuda_ms(lambda: [topk.bucket_maxima_plain(qb[lo:lo + 256], tile,
                                                                   slice_rows - 77)
                                          for lo in range(0, Q, 256)], 1)
        bids = topk._hierarchical_top_buckets(topk.bucket_maxima(qb, tile, slice_rows - 77), kk)
        k5 = {"ms": cuda_ms(lambda: topk.rescore_buckets(qb, tile, bids, kk), 10),
              "distinct_buckets": bids.unique().numel()}
        k5.update(bound(k5["distinct_buckets"] * 128 * D * 2 + Q * D * 2 + Q * kk * 4
                        + Q * kk * 128 * 4, 2.0 * Q * kk * 128 * D, "bfloat16"))
        k5["plain_ms"] = cuda_ms(lambda: topk.rescore_buckets_plain(qb, tile, bids, kk), 1)
        got = topk.topk_local(qb, tile, kk, slice_rows - 77)
        want = topk.topk_local_plain(qb, tile, kk, slice_rows - 77)
        err = (got[0] - want[0]).abs().max().item()
        if not err <= 1e-4:
            fail(f"topk_local Q={Q} k={kk} over a {slice_rows}-row slice: max|err| {err}")
        shapes[f"Q{Q}_k{kk}"] = {"K4": k4, "K5": k5, "topk_local_max_abs_err": err}
        log(f"K4 / K5 over a decoded {slice_rows} x {D} bf16 slice, Q={Q}, k={kk}: K4 "
            f"{k4['ms']:.3f} ms (bound {k4['bound_ms']:.3f} by {k4['bound_by']}, plain "
            f"{k4['plain_ms']:.2f}), K5 {k5['ms']:.3f} ms (bound {k5['bound_ms']:.3f} by "
            f"{k5['bound_by']}, plain {k5['plain_ms']:.2f}); topk_local against its plain "
            f"version max|err| {err:.2e} (limit 1e-4)")
    report["pq"]["scale"] = res
    report["K4"]["pq_slice"] = {s: v["K4"] for s, v in shapes.items()}
    report["K5"]["pq_slice"] = {s: v["K5"] for s, v in shapes.items()}
    report["pq"]["slice_kernels"] = shapes
    del tile
    torch.cuda.empty_cache()


def stream_scale(report: dict) -> None:
    """StreamingExactIndex over a STREAM_ROWS x 384 f32 .npy memmap written to
    a temporary directory: tile_rows 2^21 and 2^19 (the last tile ragged),
    bf16 cast on the host, a pre-quantized int8 corpus and, at 2^19, int8
    quantized per tile; the kernels' path against the plain path and the
    top-k over the rows it sends held on the card at once (ExactIndex for
    bf16), ties judged by scores computed from those rows; GB/s of the
    stream beside a plain pinned host-to-device copy."""
    import tempfile

    import torch

    from qst_tpu_torch.ops.distances import l2_normalize
    from qst_tpu_torch.retrieval import ExactIndex, StreamingExactIndex

    n, D, k = STREAM_ROWS, 384, 10
    res = {"rows": n}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/corpus.npy"
        t0 = time.perf_counter()
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=(n, D))
        for lo, chunk in clustered_chunks(n, seed=41):
            mm[lo:lo + chunk.shape[0]] = chunk.cpu().numpy()
        mm.flush()
        del mm
        res["write_s"] = time.perf_counter() - t0
        corpus = np.load(path, mmap_mode="r")
        gen = torch.Generator(device="cuda").manual_seed(42)
        pick = torch.randint(0, n, (PQ_QUERIES,), generator=gen, device="cuda").cpu().numpy()
        q = torch.from_numpy(np.array(corpus[np.sort(pick)])).cuda()
        q = q + 0.03 * torch.randn(q.shape, device="cuda", generator=gen)
        log(f"streaming: {n} x {D} f32 memmap ({n * D * 4 / 1e9:.2f} GB) written in "
            f"{res['write_s']:.1f} s")

        # a plain pinned host -> device copy of one 2M-row f32 tile
        pinned = torch.empty((1 << 21, D), pin_memory=True)
        on_card = torch.empty((1 << 21, D), device="cuda")
        copy_ms = cuda_ms(lambda: on_card.copy_(pinned, non_blocking=True), 5)
        res["pinned_copy_gb_per_s"] = pinned.numel() * 4 / copy_ms / 1e6
        del pinned, on_card

        # what the bf16 stream sends, as a resident bf16 index
        sent = torch.empty((n, D), dtype=torch.bfloat16, device="cuda")
        for lo in range(0, n, GEN_CHUNK):
            x = torch.from_numpy(np.array(corpus[lo:lo + GEN_CHUNK])).cuda()
            sent[lo:lo + x.shape[0]] = l2_normalize(x.to(torch.bfloat16).float()).to(
                torch.bfloat16)
        exact = ExactIndex(sent, dtype="bfloat16", device="cuda")
        es, ei = exact.search(l2_normalize(q), k=k, score="dot_score", backend="xla")
        del exact
        torch.cuda.empty_cache()
        qb = l2_normalize(q).to(torch.bfloat16).float()

        prequantized = torch.cat([
            torch.clamp(torch.round(l2_normalize(torch.from_numpy(np.array(
                corpus[lo:lo + GEN_CHUNK])).cuda()) * 127), -127, 127).to(torch.int8).cpu()
            for lo in range(0, n, GEN_CHUNK)]).numpy()

        def resident(idx):
            """The corpus as ``idx`` sends it, on the card at once: → (rows,
            per-row descale or None, queries as the search prepares them).
            int8 rows are the host tiles, each row with its tile's scale."""
            if idx.transfer_dtype == torch.bfloat16:
                return sent, None, qb
            rows = torch.empty((n, D), dtype=torch.int8, device="cuda")
            scale = torch.empty(n, device="cuda")
            buf = torch.empty((idx.tile_rows, D), dtype=torch.int8, pin_memory=True)
            for lo in range(0, n, idx.tile_rows):
                hi = min(n, lo + idx.tile_rows)
                scale[lo:hi] = idx._fill_tile(lo // idx.tile_rows, buf)
                rows[lo:hi] = buf[:hi - lo].cuda()
            qq = l2_normalize(q)
            qs = 127.0 / torch.clamp(qq.abs().max(), min=1e-12)
            return rows, 1.0 / (qs * scale), torch.clamp(torch.round(qq * qs), -127, 127)

        def true_scores(sent_rows, *ids):
            """The scores of the docs the answers name, from the rows as sent."""
            rows, inv, qq = sent_rows
            cand = torch.from_numpy(np.concatenate(ids, 1)).cuda()
            got = torch.einsum("qd,qkd->qk", qq, rows[cand].float())
            if inv is not None:
                got = got * inv[cand]
            return CandidateScores(cand.cpu().numpy(), got.cpu().numpy())

        def resident_topk(sent_rows):
            """The top-k over the rows as sent, searched on the card at once."""
            rows, inv, qq = sent_rows
            cs = torch.full((qq.shape[0], k), float("-inf"), device="cuda")
            ci = torch.full((qq.shape[0], k), -1, dtype=torch.int64, device="cuda")
            for lo in range(0, n, GEN_CHUNK):
                sc = qq @ rows[lo:lo + GEN_CHUNK].float().T
                if inv is not None:
                    sc = sc * inv[lo:lo + GEN_CHUNK]
                cs, pos = torch.topk(torch.cat([cs, sc], 1), k, dim=1)
                ci = torch.gather(torch.cat([ci, lo + torch.arange(
                    sc.shape[1], device="cuda").expand(qq.shape[0], -1)], 1), 1, pos)
            return cs.cpu().numpy(), ci.cpu().numpy()

        # int8 quantized on the host per tile at the smaller tile only: the
        # host's quantization sets its rate at either size (0.93 and 0.94M
        # rows/s at 2^21 and 2^19 on an H100 host)
        for tile_rows, transfer, source in (
                (1 << 21, "bfloat16", corpus), (1 << 21, "int8", prequantized),
                (1 << 19, "bfloat16", corpus), (1 << 19, "int8", corpus),
                (1 << 19, "int8", prequantized)):
            n_tiles = -(-n // tile_rows)
            idx = StreamingExactIndex(source, tile_rows=tile_rows,
                                      transfer_dtype=transfer, device="cuda")
            what = (f"streaming {transfer} tile_rows={tile_rows} "
                    + ("pre-quantized" if source is prequantized else
                       "cast on the host" if transfer == "bfloat16" else
                       "quantized per tile"))
            # the plain path first: it also warms the pinned buffers
            xs, xi = idx.search(q, k=k, backend="xla")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gs, gi = idx.search(q, k=k)
            wall = time.perf_counter() - t0
            counts = read_counts()
            expect_launches(what, counts, n_tiles)
            add_launches(report, counts)
            sent_gb = n * D * idx.transfer_dtype.itemsize / 1e9
            sent_rows = resident(idx)
            rs, ri = (es, ei) if transfer == "bfloat16" else resident_topk(sent_rows)
            if not ids_match_up_to_ties(gs, gi, xs, xi, true_scores(sent_rows, gi, xi),
                                        1e-4):
                fail(f"{what}: the kernels' path and the plain path disagree")
            if not ids_match_up_to_ties(gs, gi, rs, ri, true_scores(sent_rows, gi, ri),
                                        1e-4):
                fail(f"{what}: the answers differ from the top-k over the rows it sends, "
                     "searched on the card at once")
            del sent_rows
            key = f"{transfer}_{tile_rows}_" + ("prequantized" if source is prequantized
                                                else "host")
            res[key] = {"search_s": wall, "gb_sent": sent_gb, "gb_per_s": sent_gb / wall,
                        "rows_per_s": n / wall, "tiles": n_tiles,
                        "max_abs_err_vs_plain": float(np.abs(gs - xs).max()),
                        "max_abs_err_vs_resident": float(np.abs(gs - rs).max())}
            log(f"{what}: {n_tiles} tiles through K4 + K5 in {wall:.2f} s = "
                f"{sent_gb / wall:.2f} GB/s sent ({n / wall / 1e6:.2f} M rows/s; a pinned "
                f"copy runs {res['pinned_copy_gb_per_s']:.1f} GB/s); equal to the plain "
                "path and to the top-k over the rows it sends, held on the card "
                + ("(ExactIndex)" if transfer == "bfloat16" else "(one product a chunk)"))
        del corpus, prequantized, sent
    report["pq"]["streaming"] = res


def tear_down() -> dict:
    """Release what a phase leaves behind for the next one: the device's
    queued work, collected objects (an index's copy stream, events and
    buffers), device memory the caching allocator holds, and the
    page-locked host memory torch's host allocator caches (the streamed
    index's staging buffers, the pinned copies: gigabytes after ``pq``).
    Fails if a profiler is still running. → what was released."""
    import gc

    import torch

    torch.cuda.synchronize()
    gc.collect()
    before = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    host_empty = getattr(torch._C, "_host_emptyCache", None)
    if host_empty is not None:
        host_empty()
    if torch.autograd._profiler_enabled():
        fail("a profiler was left running")
    return {"device_gb": (before - torch.cuda.memory_reserved()) / 1e9,
            "host_cache_emptied": host_empty is not None}


C2_ROWS = 65536               # the probe's index: the ivf phase's corpus size
C2_LAUNCHES = 10             # K4 launches in each probe window
C2_BUFFER_MB = 1024          # kineto's ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB, raised (default 128)


KINETO_STATS = {"gpu_records": r"Processed (\d+) GPU records",
                "out_of_range": r"Out-of-range = (\d+)",
                "cupti_stopped_early": r"CUPTI stopped early\? = (\d+)",
                "max_gpu_buffer_mb": r"Max GPU buffer size: (\d+)MB"}


def c2_probe(report: dict, after: str) -> None:
    """ROADMAP C2: whether whole runs lose profiler records after pq's parts.
    Ten K4 launches on a seeded 65,536 x 384 bf16 index under torch.profiler
    (the card alone) in three windows: behind three 1,000-cycle markers, the
    windows' form before ``lead_in``, with kineto's default GPU buffer limit
    (128 MB) and with it raised, and behind ``lead_in``. The records are
    counted by name, not rounded, beside kineto's own accounting of each
    window, read from what it writes to stderr at ``KINETO_LOG_LEVEL`` 1
    (``main`` sets it for runs with ``pq``): the GPU records it processed,
    those it dropped as out of the window's range, whether CUPTI stopped
    early, the buffer limit it ran with. The probe's K4 launches leave the
    launch counts as they were."""
    import tempfile

    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import profile

    from qst_tpu_torch.ops import topk

    def short_markers():
        for _ in range(3):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    # torch hands kineto "CUSTOM_CONFIG=<this>"; the newline ends that line so
    # kineto reads the setting as its own (without it kineto rejects the line,
    # does not start tracing, and the process dies with SIGSEGV, torch 2.11)
    raised = f"ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB={C2_BUFFER_MB}"
    windows = {"short markers": (short_markers, {}),
               f"short markers, {raised}": (short_markers, {"experimental_config":
                                            _ExperimentalConfig(custom_profiler_config="\n"
                                                                + raised)}),
               "lead_in": (lead_in, {})}
    gen = torch.Generator(device="cuda").manual_seed(19)
    corpus = torch.randn((C2_ROWS, 384), device="cuda", generator=gen).to(torch.bfloat16)
    queries = torch.randn((256, 384), device="cuda", generator=gen).to(torch.bfloat16)
    topk.bucket_maxima(queries, corpus)
    torch.cuda.synchronize()
    held = topk.bucket_maxima.launches
    out = {}
    for name, (start, kw) in windows.items():
        saved = os.dup(2)
        with tempfile.TemporaryFile(mode="w+b") as err:
            os.dup2(err.fileno(), 2)
            try:
                with profile(activities=device_activity(), **kw) as prof:
                    start()
                    for _ in range(C2_LAUNCHES):
                        topk.bucket_maxima(queries, corpus)
                    torch.cuda.synchronize()
                events = prof.events()
            finally:
                os.dup2(saved, 2)
                os.close(saved)
            err.seek(0)
            text = err.read().decode(errors="replace")
        found = {k: re.findall(rx, text) for k, rx in KINETO_STATS.items()}
        skews = [int(x) for x in re.findall(r"< runtime timestamp \(\d+\) by (\d+)us", text)]
        out[name] = {"k4_records": sum(1 for e in events if is_kernel(e)
                                       and "bucket_max" in e.name),
                     "markers": sum(1 for e in events if e.device_type.name == "CUDA"
                                    and MARKER in e.name),
                     **{k: int(v[-1]) if v else None for k, v in found.items()},
                     "gpu_before_launch_us_max": max(skews, default=0)}
    topk.bucket_maxima.launches = held
    report["pq"].setdefault("c2_probe", {})[after] = out
    log(f"C2 probe after {after}: {C2_LAUNCHES} K4 launches on {C2_ROWS} x 384 bf16 under "
        f"torch.profiler: " + "; ".join(f"{n} {v}" for n, v in out.items()))
    del corpus, queries


def pq(report: dict) -> None:
    report["pq"] = {}
    parts = {}
    c2_probe(report, "the phases before pq")
    t0 = time.perf_counter()
    proc, want = pq_cli(report)
    parts["cli"] = time.perf_counter() - t0
    tear_down()
    c2_probe(report, "pq's cli part")
    try:
        for name, fn in (("scale", pq_scale), ("streaming", stream_scale)):
            t0 = time.perf_counter()
            fn(report)
            parts[name] = time.perf_counter() - t0
            released = tear_down()
            c2_probe(report, f"pq's {name} part")
        t0 = time.perf_counter()
        check_reload(report, proc, want)
        parts["reload (waited for)"] = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    report["pq"]["part_s"] = parts
    log("pq phase by part (s): " + ", ".join(f"{n} {v:.1f}" for n, v in parts.items())
        + f"; torn down after it: {released}")


# ---------------------------------------------------------------------------
# mesh: the sharded serving path on a mesh of positions of one card
# ---------------------------------------------------------------------------
MESH_ROWS = 1 << 20          # bench.py's corpus: 1M x 384 bf16, Q = 4096, k = 10
MESH_QUERIES = 4096
MESH_CELLS = 1024            # the ivf phase's cells: 1,024 of 2,048 x 384 bf16
MESH_BUDGET = 2048
MESH_PQ_ROWS = 1 << 20       # the pq phase's widths (m = 48, D = 384), 1M rows
MESH_PQ_CELLS = 1024
MESH_DOCS = 16384            # the sharded Retriever's corpus
MESH_EVAL_INSTANCES = 960    # ir_eval_main's dataset: the evaluate phase's small cut
MESH_ATTENTION = (8, 12, 4096, 32)


def counted(report: dict, what: str, fn, want: dict):
    """Run ``fn`` with every count set to 0 just before and read just after
    (synchronized); fail unless the counts are ``want`` (kernels it names)
    and 0 (the others); add them to the kernels' totals. → fn's result."""
    import torch

    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = read_counts()
    expect = {n: want.get(n, 0) for n in got}
    if got != expect:
        fail(f"mesh {what}: launches {got}, want {expect}")
    for n, v in got.items():
        report[n]["launches"] = report[n].get("launches", 0) + v
    return out


def sharded_beside_plain(plain, sharded, reps: int, queries: int) -> dict:
    """cuda_ms of the unsharded and the sharded call in turns (plain,
    sharded, sharded, plain): the cost of the shard structure on one card,
    not scaling."""
    ms = {"plain": [], "sharded": []}
    for who in ("plain", "sharded", "sharded", "plain"):
        ms[who].append(cuda_ms(plain if who == "plain" else sharded, reps, warmup=2))
    out = {f"{w}_ms": min(v) for w, v in ms.items()}
    out.update({f"{w}_qps": queries / out[f"{w}_ms"] * 1e3 for w in ms})
    out["sharded_over_plain"] = out["sharded_ms"] / out["plain_ms"]
    return out


def by_mark(counts: dict, mark: str) -> float:
    """The launches a call of the device kernels whose names hold ``mark``."""
    return sum(v for n, v in counts.items() if mark in n)


def busy(fn, wall_ms: float) -> dict:
    """Device ms and launches a call of ``fn`` (torch.profiler) beside its
    wall ms: the device's busy share, and the five longest kernels."""
    dev, launches = device_profile(fn, 5)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
    return {"device_ms": sum(dev.values()), "launches_per_call": launches,
            "busy": sum(dev.values()) / wall_ms,
            "top_ms": {short_name(n)[:60]: round(v, 4) for n, v in top}}


def truth_of(q, rows, ids):
    """CandidateScores: each query against the rows its answers name, in
    f32 (exact products of the stored dtype)."""
    import torch

    cand = torch.cat(ids, 1)
    got = torch.einsum("qd,qkd->qk", q.float(), rows[cand].float())
    return CandidateScores(cand.cpu().numpy(), got.cpu().numpy())


def mesh_exact(report: dict, mesh) -> None:
    """ExactIndex over 1M x 384 (bf16 and int8) at Q = 4096, k = 10: the
    8-shard search through K4 + K5 in every shard against the unsharded
    one; a 129-row index whose shards 2-7 hold no document against the
    plain scan."""
    import torch

    from qst_tpu_torch.retrieval import ExactIndex

    N, D, Q, k = MESH_ROWS, 384, MESH_QUERIES, 10
    gen = torch.Generator(device="cuda").manual_seed(41)
    unit = torch.nn.functional.normalize
    rows = unit(torch.randn((N, D), device="cuda", generator=gen), dim=1)
    queries = unit(torch.randn((Q, D), device="cuda", generator=gen), dim=1)
    res = {}
    for dtype in ("bfloat16", "int8"):
        plain = ExactIndex(rows, dtype=dtype)
        shard = ExactIndex(rows, dtype=dtype, mesh=mesh)
        if shard.shard_rows != N // mesh.size:
            fail(f"mesh exact: shard_rows {shard.shard_rows}, want {N // mesh.size}")
        search = lambda idx: idx._device_search(queries, k, "dot_score", 131072, "auto")  # noqa: E731
        s1, i1 = counted(report, f"exact {dtype} Q={Q}", lambda: search(shard),
                         {"K4": mesh.size, "K5": mesh.size})
        s0, i0 = search(plain)
        if dtype == "int8":
            # the integer products of the quantized queries and rows, descaled
            qs = 127.0 / queries.abs().max()
            qi = torch.clamp(torch.round(queries * qs), -127, 127)
            true = truth_of(qi / (qs * plain._int8_scale), plain.embeddings, (i0, i1))
            tol = 1e-6
        else:
            true = truth_of(queries.to(torch.bfloat16), plain.embeddings, (i0, i1))
            tol = 1e-4
        if not ids_match_up_to_ties(s1.cpu(), i1.cpu(), s0.cpu(), i0.cpu(), true, tol):
            fail(f"mesh exact {dtype}: the 8-shard search differs from the unsharded one")
        bit_equal = bool(torch.equal(s0, s1) and torch.equal(i0, i1))
        t = sharded_beside_plain(lambda: search(plain), lambda: search(shard), 10, Q)
        res[dtype] = {"max_abs_err": (s1 - s0).abs().max().item(), "bit_equal": bit_equal, **t}
        if dtype == "bfloat16":
            # the device's view: K4 and K5 by name (records over 4 calls, rounded
            # up: a lost record cannot move it), device ms and busy share
            names = kernel_counts(lambda: search(shard), done=lambda c: by_mark(
                c, "bucket_max") >= mesh.size and by_mark(c, "rescore_") >= mesh.size)
            if (by_mark(names, "bucket_max"), by_mark(names, "rescore_")) != (mesh.size,) * 2:
                fail(f"mesh exact: the profiled search ran {by_mark(names, 'bucket_max')} K4 "
                     f"and {by_mark(names, 'rescore_')} K5 kernels, want {mesh.size} each")
            res[dtype]["sharded_profile"] = busy(lambda: search(shard), t["sharded_ms"])
            res[dtype]["plain_profile"] = busy(lambda: search(plain), t["plain_ms"])
            log(f"mesh exact bf16 profiled: {mesh.size} K4 and {mesh.size} K5 kernels by name; "
                f"sharded {res[dtype]['sharded_profile']}, unsharded {res[dtype]['plain_profile']}")
        log(f"mesh exact {dtype} over {N} x {D}, Q={Q}, k={k}, {mesh.size} shards of "
            f"{shard.shard_rows}: K4 {mesh.size} / K5 {mesh.size} launches, answers "
            f"{'bit-equal to' if bit_equal else 'equal up to ties to'} the unsharded search; "
            f"{t['sharded_ms']:.3f} ms ({t['sharded_qps']:.0f} QPS) against "
            f"{t['plain_ms']:.3f} ms ({t['plain_qps']:.0f} QPS) unsharded: "
            f"x{t['sharded_over_plain']:.2f}, the shard structure's cost on one card")
        del plain, shard
    # 129 rows over 8 shards of 128: shard 1 holds one row, shards 2-7 none
    small = ExactIndex(rows[:129], dtype="bfloat16", mesh=mesh)
    q = queries[:256]
    s1, i1 = counted(report, "exact 129 rows", lambda: small._device_search(
        q, k, "dot_score", 131072, "pallas"), {"K4": mesh.size, "K5": mesh.size})
    # the plain scan unsharded (the sharded scan scores unrounded queries, as in qst_tpu)
    s0, i0 = ExactIndex(rows[:129], dtype="bfloat16")._device_search(q, k, "dot_score", 131072,
                                                                      "xla")
    true = truth_of(q.to(torch.bfloat16), small.embeddings.gather(), (i0, i1))
    if not (ids_match_up_to_ties(s1.cpu(), i1.cpu(), s0.cpu(), i0.cpu(), true, 1e-4)
            and int(i1.max()) < 129):
        fail("mesh exact: the 129-row index through K4 + K5 differs from the plain scan")
    res["rows_129"] = {"shards_without_rows": sum(
        1 for i in range(mesh.size) if i * small.shard_rows >= 129)}
    log(f"mesh exact: 129 rows over {mesh.size} shards of {small.shard_rows} "
        f"({res['rows_129']['shards_without_rows']} shards without a row): K4 + K5 in every "
        "shard equal the plain scan")
    report["mesh"]["exact"] = res


def ivf_cells(gen):
    """(centroids, cells, cell_ids, fill): 1,024 bf16 cells of 2,048 x 384
    around unit centroids, fill counts from 0 to 2,048 (an empty and a full
    cell), the ids numbered in cell order, drawn from ``gen`` on the card."""
    import torch

    C, L, D = MESH_CELLS, MESH_BUDGET, 384
    unit = torch.nn.functional.normalize
    centroids = unit(torch.randn((C, D), device="cuda", generator=gen), dim=1)
    fill = torch.randint(0, L + 1, (C,), device="cuda", generator=gen, dtype=torch.int32)
    fill[0], fill[1] = 0, L                                 # an empty and a full cell
    cells = torch.zeros((C, L, D), dtype=torch.bfloat16, device="cuda")
    for c0 in range(0, C, 64):
        x = centroids[c0:c0 + 64, None, :] + 0.3 * torch.randn((64, L, D), device="cuda",
                                                               generator=gen)
        live = torch.arange(L, device="cuda")[None, :] < fill[c0:c0 + 64, None]
        cells[c0:c0 + 64] = torch.where(live[..., None], unit(x, dim=2), 0).to(torch.bfloat16)
    slot = torch.arange(L, device="cuda")[None, :]
    first = torch.cumsum(fill, 0) - fill
    cell_ids = torch.where(slot < fill[:, None], first[:, None] + slot, -1).to(torch.int32)
    return centroids, cells, cell_ids, fill


def ivf_truth(cells, cell_ids, q, ids) -> "CandidateScores":
    """The true score of each IVF answer's doc: the bf16 query against the
    row the cells store for it."""
    import torch

    C, L, D = cell_ids.shape[0], cell_ids.shape[1], cells.shape[-1]
    flat = cells[:C].reshape(-1, D)
    live = cell_ids.reshape(-1) >= 0
    where = torch.full((int(live.sum()),), -1, dtype=torch.int64, device=cells.device)
    where[cell_ids.reshape(-1)[live].long()] = torch.arange(C * L, device=cells.device)[live]
    cand = torch.cat([i.to(cells.device) for i in ids], 1)
    got = torch.einsum("qd,qkd->qk", q.to(torch.bfloat16).float(),
                       flat[where[cand.clamp_min(0)]].float())
    return CandidateScores(cand.cpu().numpy(), got.cpu().numpy())


def mesh_ivf(report: dict, mesh) -> None:
    """IVFIndex over 1,024 bf16 cells of 2,048 x 384 (fill counts from 0 to
    2,048), 128 cells a shard: K6 once a shard at Q = 256 / 64 / 8, n_probe
    8, against the unsharded search, before and after compact()."""
    import torch

    from qst_tpu_torch.retrieval import IVFIndex

    C, L, D, P, k = MESH_CELLS, MESH_BUDGET, 384, 8, 10
    gen = torch.Generator(device="cuda").manual_seed(43)
    unit = torch.nn.functional.normalize
    centroids, cells, cell_ids, fill = ivf_cells(gen)
    plain = IVFIndex.from_arrays(centroids, cells, cell_ids, fill)
    shard = IVFIndex.from_arrays(centroids, cells, cell_ids, fill, mesh=mesh)
    del cells
    res = {"cells_per_shard": shard.cells_per_shard, "docs": plain.n_docs}
    for Q in (256, 64, 8):
        pick = torch.randint(0, C, (Q,), device="cuda", generator=gen)
        q = unit(centroids[pick] + 0.3 * torch.randn((Q, D), device="cuda", generator=gen), dim=1)
        search = lambda idx: idx._device_search(q, k, P, "auto")  # noqa: E731
        s1, i1 = counted(report, f"ivf Q={Q}", lambda: search(shard), {"K6": mesh.size})
        s0, i0 = search(plain)
        # the true score of each answer's doc: the query against its stored row
        true = ivf_truth(plain.cells, cell_ids, q, (i0, i1))
        if not rows_match_up_to_ties((s1.cpu(), i1.cpu()), (s0.cpu(), i0.cpu()), true, 1e-4):
            fail(f"mesh ivf Q={Q}: the sharded search differs from the unsharded one")
        ids_equal = bool(torch.equal(i0, i1))
        res[f"Q{Q}"] = {"ids_equal": ids_equal,
                        **sharded_beside_plain(lambda: search(plain), lambda: search(shard),
                                               20, Q)}
        if Q == 256:
            before = (s1.clone(), i1.clone())
            shard.compact()
            after = search(shard)
            if not (torch.equal(after[0], before[0]) and torch.equal(after[1], before[1])):
                fail("mesh ivf: compact() changed the sharded search's results")
        t = res[f"Q{Q}"]
        t["sharded_profile"] = busy(lambda: search(shard), t["sharded_ms"])
        t["plain_profile"] = busy(lambda: search(plain), t["plain_ms"])
        log(f"mesh ivf Q={Q}: sharded {t['sharded_profile']}, unsharded {t['plain_profile']}")
        log(f"mesh ivf Q={Q} P={P} over {C} cells of {L} x {D} bf16 ({plain.n_docs} docs), "
            f"{shard.cells_per_shard} cells a shard: K6 {mesh.size} launches, ids "
            f"{'equal' if ids_equal else 'equal up to ties'}; {t['sharded_ms']:.3f} ms against "
            f"{t['plain_ms']:.3f} ms unsharded (x{t['sharded_over_plain']:.2f})"
            + ("; compact() kept the results" if Q == 256 else ""))
    report["mesh"]["ivf"] = res


def mesh_compressed(report: dict, mesh) -> None:
    """PQ (m = 48) and IVF-PQ (1,024 cells, 8 and 4 bits) over 1M clustered
    rows of D = 384, and the streamed index over them as a host array
    (tile_rows 2^19: two tiles), each sharded over the mesh against its
    unsharded self at Q = 256 (PQ also 4,096)."""
    import torch

    from qst_tpu_torch.ops.distances import l2_normalize
    from qst_tpu_torch.retrieval import IVFPQIndex, PQIndex, StreamingExactIndex
    from qst_tpu_torch.retrieval import pq as pq_mod

    n, D, k = MESH_PQ_ROWS, 384, 10
    rows = torch.empty((n, D), device="cuda")
    for lo, chunk in clustered_chunks(n, seed=51):
        rows[lo:lo + chunk.shape[0]] = l2_normalize(chunk)
    gen = torch.Generator(device="cuda").manual_seed(52)
    pick = torch.randint(0, n, (4096,), device="cuda", generator=gen)
    queries = l2_normalize(rows[pick] + 0.03 * torch.randn((4096, D), device="cuda",
                                                           generator=gen))
    res = {"rows": n}
    t0 = time.perf_counter()
    pq = PQIndex(rows, m=48)
    torch.cuda.synchronize()
    res["pq_build_s"] = time.perf_counter() - t0
    pqs = PQIndex.from_codes(pq.codes[:n], pq.codebooks, mesh=mesh)
    cd = pq_mod._compute_dtype(pq.device)
    for Q in (256, 4096):
        q = queries[:Q]
        search = lambda idx: idx._device_search(q, k, "dot_score", 0, "auto")  # noqa: E731
        s1, i1 = counted(report, f"pq Q={Q}", lambda: search(pqs),
                         {"K4": mesh.size, "K5": mesh.size})
        s0, i0 = counted(report, f"pq unsharded Q={Q}", lambda: search(pq), {"K4": 1, "K5": 1})
        cand = torch.cat([i0, i1], 1)
        recon = pq_mod._decode_rows(pq.codes[cand.reshape(-1)], pq.codebooks.to(cd), "gather")
        got = torch.einsum("qd,qkd->qk", l2_normalize(q.float()).to(cd).float(),
                           recon.float().reshape(Q, -1, D))
        true = CandidateScores(cand.cpu().numpy(), got.cpu().numpy())
        if not ids_match_up_to_ties(s1.cpu(), i1.cpu(), s0.cpu(), i0.cpu(), true, 1e-4):
            fail(f"mesh pq Q={Q}: the sharded search differs from the unsharded one")
        res[f"pq_q{Q}"] = {"bit_equal": bool(torch.equal(s0, s1) and torch.equal(i0, i1)),
                           **sharded_beside_plain(lambda: search(pq), lambda: search(pqs), 5, Q)}
        t = res[f"pq_q{Q}"]
        log(f"mesh pq Q={Q} over {n} rows, m=48, {mesh.size} shards of {pqs.shard_rows}: K4 / "
            f"K5 {mesh.size} launches (unsharded 1), {t['sharded_ms']:.3f} ms against "
            f"{t['plain_ms']:.3f} ms unsharded (x{t['sharded_over_plain']:.2f})")
    del pq, pqs
    torch.cuda.empty_cache()
    q = queries[:256]
    for bits in (8, 4):
        t0 = time.perf_counter()
        idx = IVFPQIndex(rows, n_clusters=MESH_PQ_CELLS, m=48, bits=bits)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sh = IVFPQIndex.from_arrays(idx.centroids, idx.cell_codes, idx.cell_ids, idx.codebooks,
                                    idx.fill, mesh=mesh, bits=bits)
        for P in (8, 32):
            s1, i1 = sh._device_search(q, k, P)
            s0, i0 = idx._device_search(q, k, P)
            true = ivfpq_candidate_scores(idx, q, torch.cat([i0, i1], 1).cpu().numpy())
            if not ids_match_up_to_ties(s1.cpu(), i1.cpu(), s0.cpu(), i0.cpu(), true, 1e-4):
                fail(f"mesh ivfpq {bits} bits n_probe {P}: the sharded search differs")
            res[f"ivfpq{bits}_p{P}"] = {
                "build_s": build_s, "bit_equal": bool(torch.equal(s0, s1)),
                **sharded_beside_plain(lambda: idx._device_search(q, k, P),
                                       lambda: sh._device_search(q, k, P), 5, 256)}
            t = res[f"ivfpq{bits}_p{P}"]
            log(f"mesh ivfpq {bits} bits, {MESH_PQ_CELLS} cells, n_probe {P}, Q=256: "
                f"{sh.cells_per_shard} cells a shard, {t['sharded_ms']:.3f} ms against "
                f"{t['plain_ms']:.3f} ms unsharded (x{t['sharded_over_plain']:.2f})")
        del idx, sh
        torch.cuda.empty_cache()
    # the streamed index over the rows as a host array: two tiles of 2^19
    host = rows.cpu().numpy()
    del rows
    torch.cuda.empty_cache()
    plain = StreamingExactIndex(host, tile_rows=1 << 19)
    shard = StreamingExactIndex(host, tile_rows=1 << 19, mesh=mesh)
    tiles = -(-n // (1 << 19))
    s1, i1 = counted(report, "streaming", lambda: shard.search(q, k=k),
                     {"K4": mesh.size * tiles, "K5": mesh.size * tiles})
    s0, i0 = plain.search(q, k=k)
    cand = np.concatenate([i0, i1], 1)
    sent = l2_normalize(torch.from_numpy(host[cand.reshape(-1)]).cuda().to(
        torch.bfloat16).float()).to(torch.bfloat16).float()
    got = torch.einsum("qd,qkd->qk", l2_normalize(q).to(torch.bfloat16).float(),
                       sent.reshape(256, -1, D))
    if not ids_match_up_to_ties(s1, i1, s0, i0, CandidateScores(cand, got.cpu().numpy()), 1e-4):
        fail("mesh streaming: the sharded stream differs from the unsharded one")
    res["streaming"] = {"tiles": tiles, "bit_equal": bool(np.array_equal(s0, s1)),
                        **sharded_beside_plain(lambda: plain.search(q, k=k),
                                               lambda: shard.search(q, k=k), 2, 256)}
    t = res["streaming"]
    log(f"mesh streaming over {n} x {D} f32 host rows, {tiles} tiles of 2^19, bf16: "
        f"K4 / K5 {mesh.size} a tile, {t['sharded_ms']:.1f} ms against {t['plain_ms']:.1f} ms "
        f"unsharded (x{t['sharded_over_plain']:.2f})")
    report["mesh"]["compressed"] = res


def mesh_encode(report: dict, mesh) -> None:
    """Data-parallel encode: MiniLM-L6 through K1, B = 256, S = 128,
    SentenceEncoder(mesh=) over the data axis (4 shards of 64 rows) against
    the unsharded encode."""
    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params
    from qst_tpu_torch.models.tokenizer import HashTokenizer

    cfg = EncoderConfig.minilm_l6(use_fused_layer=True)
    params = init_params(cfg, torch.Generator().manual_seed(53), device="cuda")
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    plain = SentenceEncoder(cfg, params, tok)
    shard = SentenceEncoder(cfg, params, tok, mesh=mesh)
    n_data = mesh.shape["data"]
    ids, mask = tok.batch_encode(synthetic_docs(256, seed=54), max_length=128)
    ids = torch.from_numpy(ids.astype(np.int64)).cuda()
    mask = torch.from_numpy(mask.astype(np.int64)).cuda()
    got = counted(report, "encode", lambda: shard.encode_ids(ids, mask),
                  {"K1": cfg.num_layers * n_data})
    want = plain.encode_ids(ids, mask)
    bit_equal = bool(torch.equal(got, want))
    err = bf16_limits("mesh encode: data-parallel against unsharded", got, want)
    t = sharded_beside_plain(lambda: plain.encode_ids(ids, mask),
                             lambda: shard.encode_ids(ids, mask), 10, 256)
    report["mesh"]["encode"] = {"bit_equal": bit_equal, "max_abs_err": err,
                                "sentences_per_s": t["sharded_qps"],
                                "plain_sentences_per_s": t["plain_qps"], **t,
                                "sharded_profile": busy(lambda: shard.encode_ids(ids, mask),
                                                        t["sharded_ms"]),
                                "plain_profile": busy(lambda: plain.encode_ids(ids, mask),
                                                      t["plain_ms"])}
    log(f"mesh encode MiniLM-L6 B=256 S={ids.shape[1]}: {n_data} data shards, K1 "
        f"{cfg.num_layers * n_data} launches, embeddings "
        f"{'bit-equal to' if bit_equal else 'within the bf16 limits of'} the unsharded "
        f"encode; {t['sharded_qps']:.0f} against {t['plain_qps']:.0f} sentences/s unsharded; "
        f"sharded {report['mesh']['encode']['sharded_profile']}, unsharded "
        f"{report['mesh']['encode']['plain_profile']}")


def mesh_retriever(report: dict, mesh) -> None:
    """Retriever(mesh=) at MiniLM-L6 width over MESH_DOCS docs (an f32
    index: below PALLAS_MIN_SHARD_DOCS rows a shard both take the plain
    scan, which for a bf16 index rounds the queries only unsharded, as in
    qst_tpu): build, search, save, reload sharded and search, against the
    unsharded Retriever; ir_eval_main --mesh_data 4 --mesh_model 2 (eight positions of
    $QST_TORCH_VIRTUAL_DEVICES on the card) against the same run without a
    mesh."""
    import torch

    from qst_tpu_torch.cli import ir_eval_main
    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.core.meshes import VIRTUAL_DEVICES_ENV
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params
    from qst_tpu_torch.models.tokenizer import HashTokenizer
    from qst_tpu_torch.retrieval import Retriever

    cfg = EncoderConfig.minilm_l6(use_fused_layer=True)
    params = init_params(cfg, torch.Generator().manual_seed(55), device="cuda")
    enc = SentenceEncoder(cfg, params, HashTokenizer(vocab_size=cfg.vocab_size), mesh=mesh)
    docs = synthetic_docs(MESH_DOCS, seed=56)
    queries = [docs[j] for j in range(0, MESH_DOCS, MESH_DOCS // 64)]
    tmp = work_dir("mesh")
    t0 = time.perf_counter()
    shard = Retriever(enc, mesh=mesh, score="dot_score").build(docs)
    build_s = time.perf_counter() - t0
    plain = Retriever(enc, score="dot_score").build(docs)
    want = plain.search(queries, k=10)
    got = shard.search(queries, k=10)

    def pairs(rows):
        return (np.array([[r[1] for r in row] for row in rows]),
                np.array([[r[0] for r in row] for row in rows]))

    emb = plain.index.embeddings
    qe = enc.encode(queries, convert_to_numpy=False)
    cand = np.concatenate([pairs(want)[1], pairs(got)[1]], 1)
    true = CandidateScores(cand, torch.einsum(
        "qd,qkd->qk", qe, emb[torch.from_numpy(cand).cuda()]).cpu().numpy())
    if not ids_match_up_to_ties(*pairs(got), *pairs(want), true, 1e-4):
        fail("mesh Retriever: the sharded answers differ from the unsharded ones")
    shard.save(f"{tmp}/idx")
    saved = np.load(f"{tmp}/idx/embeddings.npy", mmap_mode="r").shape[0]
    again = Retriever(enc, mesh=mesh).load(f"{tmp}/idx")
    if saved != len(docs) or again.index.mesh is not mesh or again.search(queries, k=10) != got:
        fail(f"mesh Retriever: {saved} rows saved for {len(docs)} docs, or the reloaded "
             "sharded index answers differently")
    res = {"docs": len(docs), "build_s": build_s}
    log(f"mesh Retriever over {len(docs)} docs: built sharded in {build_s:.1f} s, answers "
        f"equal to the unsharded Retriever's up to ties, saved {saved} rows, reloaded "
        "sharded with the same answers")
    # ir_eval_main with and without the mesh flags on one dataset
    data = f"{tmp}/data"
    write_quadruplet_chunks(data, MESH_EVAL_INSTANCES, seed=57)
    runs = {}
    for name, flags in (("plain", []), ("mesh", ["--mesh_data", "4", "--mesh_model", "2"])):
        os.environ[VIRTUAL_DEVICES_ENV] = "8" if flags else ""
        try:
            t0 = time.perf_counter()
            argv = ["--dataset_root", data, "--output_root", f"{tmp}/ir_{name}",
                    "--use_fused_layer", "--score_functions", "cos_sim", "dot_score",
                    *IR_GRID, *flags]
            if ir_eval_main.main(argv) != 0:
                fail(f"ir_eval_main {' '.join(flags)} failed")
            torch.cuda.synchronize()
            runs[name] = time.perf_counter() - t0
        finally:
            os.environ.pop(VIRTUAL_DEVICES_ENV, None)
        [out] = os.listdir(f"{tmp}/ir_{name}")
        with open(f"{tmp}/ir_{name}/{out}/results.json") as f:
            res[f"ir_{name}"] = json.load(f)["baseline"]["metrics"]
    worst = max(abs(v - res["ir_mesh"][fn][m]) for fn, ms in res["ir_plain"].items()
                for m, v in ms.items())
    # equal embeddings give equal metrics; else the evaluate phase's limit
    limit = 1e-6 if report["mesh"].get("encode", {}).get("bit_equal") else 5e-3
    if not worst <= limit:
        fail(f"ir_eval_main --mesh_data 4 --mesh_model 2: metrics differ by {worst} "
             f"(limit {limit})")
    res.update(ir_wall_s=runs, ir_max_abs_diff=worst)
    for name in ("ir_plain", "ir_mesh"):
        res[name] = {fn: ms["map@100"] for fn, ms in res[name].items()}
    log(f"mesh ir_eval_main --mesh_data 4 --mesh_model 2 over {MESH_EVAL_INSTANCES} instances: "
        f"metrics within {worst:.1e} of the run without a mesh; map@100 {res['ir_mesh']}; "
        f"wall {runs['mesh']:.1f} s against {runs['plain']:.1f} s")
    report["mesh"]["retriever"] = res


def mesh_attention(report: dict, mesh) -> None:
    """Context-parallel and ring attention over the data axis (4 shards) at
    (B 8, 12 heads, S 4,096, head 32) f32 against full_attention, and one
    backward of each against full attention's."""
    import torch

    from qst_tpu_torch.parallel import context_parallel_attention, full_attention, ring_attention

    B, H, S, Dh = MESH_ATTENTION
    gen = torch.Generator(device="cuda").manual_seed(58)
    q, k, v = (torch.randn((B, H, S, Dh), device="cuda", generator=gen) for _ in range(3))
    g = torch.randn((B, H, S, Dh), device="cuda", generator=gen)
    res = {"shards": mesh.shape["data"]}
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    full = full_attention(*ref)
    full.backward(g)
    full, grads = full.detach(), [t.grad for t in ref]
    del ref
    torch.cuda.empty_cache()
    for name, fn in (("context_parallel", context_parallel_attention), ("ring", ring_attention)):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*xs, mesh)
        out.backward(g)
        err = (out.detach() - full).abs().max().item()
        gerr = max((x.grad - r).abs().max().item() / r.abs().max().item()
                   for x, r in zip(xs, grads))
        res[name] = {"max_abs_err": err, "grad_max_rel_err": gerr,
                     "ms": cuda_ms(lambda: fn(q, k, v, mesh), 3)}
        log(f"mesh {name} attention (B {B}, {H} heads, S {S}, head {Dh}) f32 over "
            f"{res['shards']} shards: max|err| {err:.2e} against full_attention (limit 1e-4), "
            f"gradients within {gerr:.2e} of full attention's (limit 1e-4 of the largest), "
            f"{res[name]['ms']:.1f} ms forward")
        if not (err <= 1e-4 and gerr <= 1e-4):
            fail(f"mesh {name} attention: outside the limits")
        del xs, out
        torch.cuda.empty_cache()
    res["full_ms"] = cuda_ms(lambda: full_attention(q, k, v), 3)
    report["mesh"]["attention"] = res


def mesh(report: dict) -> None:
    """The sharded serving path on a 4 x 2 mesh of positions of one card."""
    from qst_tpu_torch.core.meshes import make_mesh

    report["mesh"] = {}
    m = make_mesh(4, 2, devices=["cuda:0"] * 8)
    parts = {}
    for name, fn in (("exact", mesh_exact), ("ivf", mesh_ivf), ("compressed", mesh_compressed),
                     ("encode", mesh_encode), ("retriever", mesh_retriever),
                     ("attention", mesh_attention)):
        t0 = time.perf_counter()
        fn(report, m)
        parts[name] = time.perf_counter() - t0
        tear_down()
    report["mesh"]["part_s"] = parts
    log("mesh phase by part (s): " + ", ".join(f"{n} {v:.1f}" for n, v in parts.items()))


# ---------------------------------------------------------------------------
# train_mesh: training on device meshes (data- and tensor-parallel steps, the
# captured sharded step, the pipeline, train_main's mesh flags)
# ---------------------------------------------------------------------------
TM_BATCH = 32                # quadruplets a step: 128 sequences
TM_SEQ = 128


def tm_batch(seed: int, vocab: int, n: int = 1):
    """n (4, 32, 128) batches of ids and masks (lengths 16-128), numpy."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (n, 4, TM_BATCH, TM_SEQ)).astype(np.int64)
    lengths = rng.integers(16, TM_SEQ + 1, (n, 4, TM_BATCH, 1))
    mask = (np.arange(TM_SEQ)[None, None, None, :] < lengths).astype(np.int64)
    return (ids[0], mask[0]) if n == 1 else (ids, mask)


_TM_WEIGHTS: dict = {}


def tm_weights(enc_cfg, seed: int = 21) -> dict:
    """MiniLM-L6's random weights from ``seed``, on the card, drawn once a
    seed (a state copies them; it never aliases them)."""
    import torch

    from qst_tpu_torch.models.sentence_encoder import init_params

    if seed not in _TM_WEIGHTS:
        _TM_WEIGHTS[seed] = init_params(enc_cfg, torch.Generator().manual_seed(seed),
                                        device="cuda:0")
    return _TM_WEIGHTS[seed]


def tm_state(enc_cfg, loss_cfg, tcfg, mesh, seed: int = 21):
    """A train state from one seed's weights: tensor-parallel when the mesh
    has a model axis > 1, else plain, on the card."""
    import torch

    from qst_tpu_torch.train import create_train_state
    from qst_tpu_torch.train.train_step import create_train_state_sharded

    sd = tm_weights(enc_cfg, seed)
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        return create_train_state_sharded(enc_cfg, tcfg, torch.Generator(), 100, mesh, loss_cfg,
                                          initial_params=sd)[0]
    return create_train_state(enc_cfg, tcfg, torch.Generator(), 100, loss_cfg,
                              initial_params=sd, device="cuda:0")[0]


def tm_counted(what: str, fn, want: list, report: dict, keep_want=0):
    """K1, K2, K3 forward and K3 backward launches of ``fn`` (every count set
    to 0 just before, read just after), added to the report's rows; fail
    unless ``want``, or unless K9 launched ``keep_want`` times (None: any
    number). → (fn's result, the four counts, K9's)."""
    import torch

    from qst_tpu_torch.ops.fused_layer import module_keep_mask

    counters = train_counters()
    for c in (*counters, module_keep_mask):
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got, keep = [c.launches for c in counters], module_keep_mask.launches
    if got != want or (keep_want is not None and keep != keep_want):
        fail(f"train_mesh {what}: launches {got} ({', '.join(COUNTED)}), K9 {keep}; want "
             f"{want}, K9 {keep_want}")
    add_train_launches(report, got)
    add_keep_launches(report, keep)
    return out, got, keep


def tm_grads(enc_cfg, loss_cfg, state, mesh, ids, mask) -> dict:
    """The first step's gradients under HF names (a tensor-parallel state's
    gathered), dropout 0, through ``encoder_apply_fn(cfg, mesh)``."""
    import torch

    from qst_tpu_torch.train.train_step import encoder_apply_fn, loss_from_config

    state.model.zero_grad(set_to_none=True)
    state.model.train()
    emb = encoder_apply_fn(enc_cfg, mesh)(state.model, ids.reshape(4 * TM_BATCH, -1),
                                          mask.reshape(4 * TM_BATCH, -1), None)
    loss_from_config(loss_cfg)(*emb.reshape(4, TM_BATCH, -1).unbind(0)).backward()
    torch.cuda.synchronize()
    named = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    return named if state.layout is None else state.layout.export(named)


def tm_grad_bars(what: str, got: dict, ref: dict) -> dict:
    """The train phase's bars on gradients: cosine >= 0.999 over all of them
    and every tensor within 5e-2 of the reference's norm (the key bias, whose
    gradient is rounding noise, against the query bias's)."""
    import torch

    flat_g = torch.cat([got[n].flatten().float() for n in ref])
    flat_r = torch.cat([g.flatten().float() for g in ref.values()])
    cos = torch.nn.functional.cosine_similarity(flat_g, flat_r, dim=0).item()
    worst = (0.0, "")
    for n, g in ref.items():
        den = ref[n.replace("key", "query")] if n.endswith("self.key.bias") else g
        worst = max(worst, (((got[n] - g).norm() / den.norm().clamp_min(1e-30)).item(), n))
    log(f"train_mesh {what}: first-step gradients against the unsharded step's: cosine "
        f"{cos:.6f} (limit 0.999), worst per tensor {worst[0]:.3e} ({worst[1]}; limit 5e-2)")
    if not (cos >= 0.999 and worst[0] <= 5e-2):
        fail(f"train_mesh {what}: gradients disagree with the unsharded step's")
    return {"grad_cosine": cos, "grad_worst": worst[0]}


def tm_same(a, b) -> bool:
    return all(torch_equal(x, y) for x, y in zip(a.optimizer.state_tensors(),
                                                  b.optimizer.state_tensors()))


def torch_equal(x, y) -> bool:
    import torch

    return bool(torch.equal(x, y))


def tm_busy(fn, ms: float, calls: int = 1) -> dict:
    """``window`` over one call of ``fn`` (``calls`` steps): device ms and
    launches a step, and the busy share against ``ms``, the step's time
    measured without the profiler."""
    w = window(fn, calls)
    launches = sum(c for c, _ in w["kernels"].values()) / calls
    if not launches:
        fail("train_mesh: the profiler saw no kernel of a step")
    return {"device_ms": w["device_ms_per_step"], "launches_per_call": launches,
            "busy": w["device_ms_per_step"] / ms}


def tm_step_time(make_state, step, ids, mask, key) -> dict:
    """ms a step (CUDA events over two steps, after a warm-up step) of
    ``step`` on a fresh state, launches a step and the device's busy share."""
    state = make_state()
    ms = cuda_ms(lambda: step(state, ids, mask, key), 2, warmup=1)
    return {"ms": ms, **tm_busy(lambda: step(state, ids, mask, key), ms)}


def tm_data_parallel(report: dict, out: dict) -> None:
    """DP (4 x 1) and DP + TP (4 x 2) through K1 / K2 per data shard and K3
    once, fused path, bf16: one step at dropout 0 against the unsharded step
    from the same state and batch (loss, gradients, launches by wrapper and
    by name); a 1 x 1 mesh equals the unsharded step bit for bit; at
    dropout 0.1 two calls are bit-equal and the shards draw other masks."""
    import dataclasses

    import torch

    from qst_tpu_torch.core.meshes import make_mesh
    from qst_tpu_torch.ops.fused_layer import fold_key, step_draws
    from qst_tpu_torch.train import dropout_key, make_train_step

    enc_cfg, loss_cfg, base = train_config()
    tcfg = dataclasses.replace(base, learning_rate=1e-4, scheduler="constantlr")
    cfg0 = dataclasses.replace(enc_cfg, hidden_dropout=0.0, attention_dropout=0.0)
    ids_np, mask_np = tm_batch(31, enc_cfg.vocab_size)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    L = enc_cfg.num_layers
    plain_state = tm_state(cfg0, loss_cfg, tcfg, None)
    ref_grads = tm_grads(cfg0, loss_cfg, plain_state, None, ids, mask)
    ref_loss = make_train_step(cfg0, loss_cfg)(tm_state(cfg0, loss_cfg, tcfg, None), ids, mask,
                                               None)[1].item()
    for label, shape in (("DP 4x1", (4, 1)), ("DP+TP 4x2", (4, 2))):
        mesh = make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
        n_data = shape[0]
        want = [L * n_data, L * n_data, 1, 1]
        state = tm_state(cfg0, loss_cfg, tcfg, mesh)
        step = make_train_step(cfg0, loss_cfg, None, mesh)
        (_, loss), launches, _ = tm_counted(label, lambda: step(state, ids, mask, None), want,
                                            report)
        grads = tm_grad_bars(label, tm_grads(cfg0, loss_cfg, tm_state(cfg0, loss_cfg, tcfg, mesh),
                                             mesh, ids, mask), ref_grads)
        rel = abs(loss.item() - ref_loss) / abs(ref_loss)
        # by name: K1's attention kernel once a layer and shard, K2's
        # recompute of it as often, K2's attention backward once, K3's two
        # kernels once a step
        want_names = {"attention_mma_kernel": 2 * L * n_data,
                      "attention_bwd_mma_kernel": L * n_data,
                      "quadruplet_fwd_kernel": 1, "quadruplet_bwd_kernel": 1}

        def named(c, mark):
            return sum(v for n, v in c.items() if f"::{mark}" in n)

        # four steps a window (kernel_counts' default): a whole run on a slow
        # host lost two or three of a window's records in each of three tries
        # of a two-step window (47 against 48 attention kernels a step)
        names = kernel_counts(lambda: step(state, ids, mask, None), lambda c: all(
            named(c, m) >= v for m, v in want_names.items()))
        by_name = {m: named(names, m) for m in want_names}
        bad = {m: (by_name[m], v) for m, v in want_names.items() if by_name[m] != v}
        log(f"train_mesh {label} (MiniLM-L6, batch 32 quadruplets, S=128, bf16, fused): loss "
            f"{loss.item():.6f} against {ref_loss:.6f} unsharded (rel {rel:.2e}, limit 1e-2); "
            f"launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]} + {launches[3]}; "
            f"by name a step: {by_name} (want {want_names})")
        if not rel <= 1e-2 or bad:
            fail(f"train_mesh {label}: loss {rel:.2e} off, or kernels by name {bad}")
        # dropout 0.1: the same step twice from the same state is bit-equal
        key = dropout_key(14, 1)
        runs = []
        for _ in range(2):
            st = tm_state(enc_cfg, loss_cfg, tcfg, mesh)
            _, l2 = make_train_step(enc_cfg, loss_cfg, None, mesh)(st, ids, mask, key)
            runs.append((l2, st))
        torch.cuda.synchronize()
        same = torch_equal(runs[0][0], runs[1][0]) and tm_same(runs[0][1], runs[1][1])
        seeds = [step_draws(fold_key(key.cuda(), i), L)[1] for i in range(n_data)]
        distinct = len({tuple(s.flatten().tolist()) for s in seeds}) == n_data
        log(f"train_mesh {label} at dropout 0.1: two calls bit-equal {same}; the {n_data} data "
            f"shards' layer seeds distinct {distinct}")
        if not (same and distinct):
            fail(f"train_mesh {label}: dropout steps not bit-equal, or shards share masks")
        del runs
        out[label] = {"loss": loss.item(), "unsharded_loss": ref_loss, "loss_rel": rel,
                      **grads, "launches": launches, "by_name": by_name,
                      "dropout_bit_equal": same}
    # a 1 x 1 mesh is the unsharded step bit for bit (dropout 0.1)
    key = dropout_key(14, 2)
    pair = []
    for mesh in (None, make_mesh(1, 1, devices=["cuda:0"])):
        st = tm_state(enc_cfg, loss_cfg, tcfg, mesh)
        _, l1 = make_train_step(enc_cfg, loss_cfg, None, mesh)(st, ids, mask, key)
        pair.append((l1, st))
    torch.cuda.synchronize()
    one = torch_equal(pair[0][0], pair[1][0]) and tm_same(pair[0][1], pair[1][1])
    log(f"train_mesh 1x1 mesh against no mesh, dropout 0.1: bit-equal {one}")
    if not one:
        fail("train_mesh: a 1x1 mesh differs from the unsharded step")
    out["one_position_bit_equal"] = one


def tm_module_tp(report: dict, out: dict) -> None:
    """TP on the nn.Module path, f32: 1 x 2 and 4 x 2 meshes, one step
    against the unsharded step (parameters within 1e-4, the loss)."""
    import dataclasses

    import torch

    from qst_tpu_torch.core.meshes import make_mesh
    from qst_tpu_torch.train import make_train_step

    enc_cfg, _, base = train_config()
    cfg = dataclasses.replace(enc_cfg, use_fused_layer=False, dtype="float32",
                              hidden_dropout=0.0, attention_dropout=0.0)
    from qst_tpu_torch.core.config import LossConfig

    loss_cfg = LossConfig(kind="gamma", use_fused_kernel=True)
    tcfg = dataclasses.replace(base, learning_rate=1e-5, scheduler="constantlr")
    ids_np, mask_np = tm_batch(32, cfg.vocab_size)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    ref = tm_state(cfg, loss_cfg, tcfg, None)
    _, ref_loss = make_train_step(cfg, loss_cfg)(ref, ids, mask, None)
    ref_sd = ref.flat_state_dict()
    for shape in ((1, 2), (4, 2)):
        mesh = make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
        st = tm_state(cfg, loss_cfg, tcfg, mesh)
        (_, loss), _, _ = tm_counted(f"TP nn.Module {shape}", lambda: make_train_step(
            cfg, loss_cfg, None, mesh)(st, ids, mask, None), [0, 0, 1, 1], report)
        got = st.flat_state_dict()
        worst = max(((got[k] - v).abs().max().item(), k) for k, v in ref_sd.items())
        rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
        log(f"train_mesh TP nn.Module {shape[0]}x{shape[1]} f32: loss rel {rel:.2e} (limit "
            f"1e-5), parameters after one step within {worst[0]:.2e} of the unsharded step's "
            f"({worst[1]}; limit 1e-4)")
        if not (worst[0] <= 1e-4 and rel <= 1e-5):
            fail(f"train_mesh TP nn.Module {shape}: parameters or loss disagree")
        out[f"TP nn.Module {shape[0]}x{shape[1]}"] = {"param_max_err": worst[0], "loss_rel": rel}


def tm_captured(report: dict, out: dict) -> None:
    """make_multi_step(K=4) on the 4 x 1 mesh (fused, dropout 0.1) and on the
    nn.Module path without a mesh (dropout 0.1): two calls (eager +
    capture, then a replay) against eight eager steps, bit for bit, with
    each call's launches exact (K9's: K times an eager step's)."""
    import dataclasses

    import torch

    from qst_tpu_torch.core.meshes import make_mesh
    from qst_tpu_torch.train import dropout_key, make_multi_step, make_train_step

    enc_cfg, loss_cfg, base = train_config()
    tcfg = dataclasses.replace(base, learning_rate=1e-4, warmup_steps=2)
    K = 4
    ids, mask = tm_batch(33, enc_cfg.vocab_size, 2 * K)
    keys = torch.stack([dropout_key(14, s) for s in range(1, 2 * K + 1)])
    for label, cfg, mesh, per_step in (
            ("DP 4x1 fused", enc_cfg, make_mesh(4, 1, devices=["cuda:0"] * 4),
             [6 * 4, 6 * 4, 1, 1]),
            ("nn.Module, no mesh", dataclasses.replace(enc_cfg, use_fused_layer=False), None,
             [0, 0, 1, 1])):
        graph_st, eager_st = (tm_state(cfg, loss_cfg, tcfg, mesh) for _ in range(2))
        step = make_train_step(cfg, loss_cfg, None, mesh)
        # K9: one mask a dropout site of the nn.Module path (the embeddings'
        # and three a layer) a step; none on the fused path
        keep = 0 if mesh is not None else 2 * K * (3 * cfg.num_layers + 1)
        eager, _, _ = tm_counted(f"eager {label}", lambda: torch.stack([step(
            eager_st, ids[j], mask[j], keys[j])[1] for j in range(2 * K)]),
            [2 * K * n for n in per_step], report, keep)
        multi = make_multi_step(cfg, loss_cfg, None, K, mesh)
        graph_losses, launches = [], []
        for call in range(2):
            part = slice(call * K, (call + 1) * K)
            (_, losses), got, got_keep = tm_counted(
                f"captured {label} call {call}", lambda: multi(
                    graph_st, ids[part], mask[part], keys[part]), [K * n for n in per_step],
                report, keep // 2)
            launches.append(got + [got_keep])
            graph_losses.append(losses)
        if multi._graph is None:
            fail(f"train_mesh captured {label}: no graph was captured")
        graph_losses = torch.cat(graph_losses)
        same = torch_equal(graph_losses, eager) and tm_same(graph_st, eager_st)
        log(f"train_mesh captured {label} (K={K}, dropout 0.1): 2 calls against {2 * K} eager "
            f"steps bit-equal {same}; launches a call (K1, K2, K3 fwd, bwd, K9) {launches}, "
            f"K9 over the eager steps {keep}")
        if not same:
            fail(f"train_mesh captured {label}: replays differ from the eager steps")
        out[f"captured {label}"] = {"bit_equal": same, "launches_per_call": launches[1]}
        del graph_st, eager_st, multi


def tm_pipeline(report: dict, out: dict) -> None:
    """The pipeline on the nn.Module layers, K3 for the loss: 2 x 2 GPipe
    (M = 4) and 3 stages x 2 rounds circular (M = 4); f32 at dropout 0 the
    forward and one step against the unpipelined step (1e-4); bf16 at
    dropout 0.1 two calls bit-equal."""
    import dataclasses

    import torch

    from qst_tpu_torch.parallel.pipeline import (
        PipelineLayout,
        make_pipe_mesh,
        make_pp_embed_fn,
        make_pp_train_step,
        pp_params_from_encoder,
    )
    from qst_tpu_torch.train import dropout_key, make_train_step
    from qst_tpu_torch.train.train_step import TrainState, make_optimizer

    enc_cfg, loss_cfg, base = train_config()
    tcfg = dataclasses.replace(base, learning_rate=1e-5, scheduler="constantlr")
    cfg32 = dataclasses.replace(enc_cfg, use_fused_layer=False, dtype="float32",
                                hidden_dropout=0.0, attention_dropout=0.0)
    cfg_drop = dataclasses.replace(enc_cfg, use_fused_layer=False)
    ids_np, mask_np = tm_batch(34, enc_cfg.vocab_size)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    flat_ids, flat_mask = ids.reshape(4 * TM_BATCH, -1), mask.reshape(4 * TM_BATCH, -1)
    sd = tm_weights(enc_cfg)
    ref = tm_state(cfg32, loss_cfg, tcfg, None)
    with torch.no_grad():
        ref_emb = ref.model(flat_ids, flat_mask)["sentence_embedding"]
    _, ref_loss = make_train_step(cfg32, loss_cfg)(ref, ids, mask, None)
    ref_sd = ref.flat_state_dict()
    for label, (pipe, data, M, V) in (("GPipe 2x2", (2, 2, 4, 1)),
                                      ("circular 3 stages x 2 rounds", (3, 1, 4, 2))):
        mesh = make_pipe_mesh(pipe, data, devices=["cuda:0"] * (pipe * data))

        def fresh(cfg):
            model = pp_params_from_encoder(sd, cfg, pipe, mesh, V)
            return TrainState(step=0, model=model,
                              optimizer=make_optimizer(tcfg, 100, model.parameters()),
                              layout=PipelineLayout(cfg, pipe, V))

        st = fresh(cfg32)
        with torch.no_grad():
            emb = make_pp_embed_fn(cfg32, mesh, pipe, M, V)(st.model, flat_ids, flat_mask)
        fwd_err = (emb - ref_emb).abs().max().item()
        (_, loss), launches, _ = tm_counted(f"pipeline {label}", lambda: make_pp_train_step(
            cfg32, loss_cfg, None, mesh, pipe, M, V)(st, ids, mask, None), [0, 0, 1, 1], report)
        got = st.flat_state_dict()
        worst = max(((got[k] - v).abs().max().item(), k) for k, v in ref_sd.items())
        loss_err = abs(loss.item() - ref_loss.item())
        step = make_pp_train_step(cfg_drop, loss_cfg, None, mesh, pipe, M, V)
        pair, keeps = [], []
        for _ in range(2):
            s2 = fresh(cfg_drop)
            (_, l2), _, keep = tm_counted(f"pipeline {label} dropout 0.1", lambda: step(
                s2, ids, mask, dropout_key(14, 1)), [0, 0, 1, 1], report, None)
            pair.append((l2, s2))
            keeps.append(keep)
        if not keeps[0] or keeps[0] != keeps[1]:
            fail(f"train_mesh pipeline {label}: K9 launches {keeps} at dropout 0.1")
        same = torch_equal(pair[0][0], pair[1][0]) and tm_same(pair[0][1], pair[1][1])
        log(f"train_mesh pipeline {label} (M={M}): f32 forward within {fwd_err:.2e} of the "
            f"unpipelined encoder, loss within {loss_err:.2e}, parameters after one step "
            f"within {worst[0]:.2e} ({worst[1]}; limits 1e-4); bf16 dropout 0.1 two calls "
            f"bit-equal {same}; K3 {launches[2]} + {launches[3]}")
        if not (fwd_err <= 1e-4 and loss_err <= 1e-4 and worst[0] <= 1e-4 and same):
            fail(f"train_mesh pipeline {label}: disagrees with the unpipelined step")
        out[f"pipeline {label}"] = {"forward_max_err": fwd_err, "loss_err": loss_err,
                                    "param_max_err": worst[0], "dropout_bit_equal": same}
        del st, pair


def tm_cli(report: dict, out: dict) -> None:
    """train_main --mesh_data 4 --mesh_model 2 --use_fused_layer and
    train_main --pp_stages 2 under $QST_TORCH_VIRTUAL_DEVICES=8, a few steps
    each; each best artifact loads into SentenceEncoder and encodes."""
    import tempfile

    import torch

    from qst_tpu_torch.cli import common, train_main
    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
    from qst_tpu_torch.models.tokenizer import HashTokenizer

    from qst_tpu_torch.ops.fused_layer import module_keep_mask

    cfg = EncoderConfig.minilm_l6()
    counters = (*train_counters(), module_keep_mask)
    saved = os.environ.get("QST_TORCH_VIRTUAL_DEVICES")
    os.environ["QST_TORCH_VIRTUAL_DEVICES"] = "8"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_quadruplet_chunks(f"{tmp}/data", 160, seed=35)
            for label, flags, want in (
                    ("--mesh_data 4 --mesh_model 2 --use_fused_layer",
                     ["--mesh_data", "4", "--mesh_model", "2", "--use_fused_layer"], 24),
                    ("--pp_stages 2", ["--pp_stages", "2"], 0)):
                exp = f"{tmp}/exp_{len(out)}"
                for c in counters:
                    c.launches = 0
                t0 = time.perf_counter()
                rc = train_main.main([
                    "--dataset_root", f"{tmp}/data", "--experiment_dir", exp,
                    "--use_fused_loss_kernel", "--batch_size", "32", "--epochs", "1",
                    "--evaluation_steps", "2", "--max_val_samples", "16", "--seed", "14",
                    *flags])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = [c.launches for c in counters]
                add_train_launches(report, launches)
                add_keep_launches(report, launches[4])
                best = common.load_best_params(exp)
                enc = SentenceEncoder(cfg, {k: v.cuda() for k, v in best.items()},
                                      HashTokenizer(cfg.vocab_size))
                emb = enc.encode(synthetic_docs(64, seed=36))
                ok = (rc == 0 and emb.shape == (64, cfg.hidden_size)
                      and bool(np.isfinite(emb).all()))
                log(f"train_mesh train_main {label}: rc {rc} in {wall:.1f} s; launches "
                    f"K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]} + {launches[3]}, "
                    f"K9 {launches[4]}; the best artifact encodes 64 texts to {emb.shape}, "
                    f"finite {ok}")
                # the fused path draws its masks in K1; the pipeline's
                # nn.Module layers (dropout 0.1) through K9
                if (not ok or (want and launches[1] % want) or launches[1] < want
                        or bool(want) == bool(launches[4])):
                    fail(f"train_mesh train_main {label}: rc {rc}, launches {launches}")
                out[f"train_main {label}"] = {"wall_s": wall, "launches": launches}
    finally:
        if saved is None:
            os.environ.pop("QST_TORCH_VIRTUAL_DEVICES", None)
        else:
            os.environ["QST_TORCH_VIRTUAL_DEVICES"] = saved


def tm_times(out: dict) -> None:
    """ms a step of each form beside its unsharded self (CUDA events, in
    turns), with launches a step and the busy share: the shard structure's
    cost on one card, not scaling."""
    import dataclasses

    import torch

    from qst_tpu_torch.core.meshes import make_mesh
    from qst_tpu_torch.parallel.pipeline import (
        PipelineLayout,
        make_pipe_mesh,
        make_pp_train_step,
        pp_params_from_encoder,
    )
    from qst_tpu_torch.train import dropout_key, make_multi_step, make_train_step
    from qst_tpu_torch.train.train_step import TrainState, make_optimizer

    enc_cfg, loss_cfg, base = train_config()
    tcfg = dataclasses.replace(base, learning_rate=1e-5, scheduler="constantlr")
    ids_np, mask_np = tm_batch(37, enc_cfg.vocab_size)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    key = dropout_key(14, 1).cuda()
    module = dataclasses.replace(enc_cfg, use_fused_layer=False)
    sd = tm_weights(enc_cfg)
    times = {}

    def form(name, cfg, mesh, make_step):
        def make_state():
            return tm_state(cfg, loss_cfg, tcfg, mesh)
        times[name] = tm_step_time(make_state, make_step(), ids, mask, key)

    m41 = make_mesh(4, 1, devices=["cuda:0"] * 4)
    m42 = make_mesh(4, 2, devices=["cuda:0"] * 8)
    form("fused unsharded", enc_cfg, None, lambda: make_train_step(enc_cfg, loss_cfg))
    form("fused DP 4x1", enc_cfg, m41, lambda: make_train_step(enc_cfg, loss_cfg, None, m41))
    form("fused DP+TP 4x2", enc_cfg, m42, lambda: make_train_step(enc_cfg, loss_cfg, None, m42))
    form("module unsharded", module, None, lambda: make_train_step(module, loss_cfg))
    m12 = make_mesh(1, 2, devices=["cuda:0"] * 2)
    form("module TP 1x2", module, m12, lambda: make_train_step(module, loss_cfg, None, m12))
    for name, (pipe, data, M, V) in (("module pipeline GPipe 2x2", (2, 2, 4, 1)),
                                     ("module pipeline circular 3x2", (3, 1, 4, 2))):
        pm = make_pipe_mesh(pipe, data, devices=["cuda:0"] * (pipe * data))

        def make_state(pipe=pipe, pm=pm, V=V):
            model = pp_params_from_encoder(sd, module, pipe, pm, V)
            return TrainState(step=0, model=model,
                              optimizer=make_optimizer(tcfg, 100, model.parameters()),
                              layout=PipelineLayout(module, pipe, V))
        times[name] = tm_step_time(make_state, make_pp_train_step(module, loss_cfg, None, pm,
                                                                  pipe, M, V), ids, mask, key)
    # the captured sharded step: 4 steps a call
    K = 4
    ids4 = ids[None].expand(K, *ids.shape).contiguous()
    mask4 = mask[None].expand(K, *mask.shape).contiguous()
    keys4 = torch.stack([dropout_key(14, s) for s in range(1, K + 1)])
    for name, mesh in (("fused captured K=4 unsharded", None), ("fused captured K=4 DP 4x1",
                                                                 m41)):
        st = tm_state(enc_cfg, loss_cfg, tcfg, mesh)
        multi = make_multi_step(enc_cfg, loss_cfg, None, K, mesh)
        ms = cuda_ms(lambda: multi(st, ids4, mask4, keys4), 2, warmup=2) / K
        times[name] = {"ms": ms, **tm_busy(lambda: multi(st, ids4, mask4, keys4), ms, K)}
        del st, multi
    for sharded, plain in (("fused DP 4x1", "fused unsharded"),
                           ("fused DP+TP 4x2", "fused unsharded"),
                           ("module TP 1x2", "module unsharded"),
                           ("module pipeline GPipe 2x2", "module unsharded"),
                           ("module pipeline circular 3x2", "module unsharded"),
                           ("fused captured K=4 DP 4x1", "fused captured K=4 unsharded")):
        times[sharded]["over_unsharded"] = times[sharded]["ms"] / times[plain]["ms"]
    log("train_mesh times (ms a step; launches a step; busy): " + "; ".join(
        f"{n} {t['ms']:.2f} ms ({t.get('over_unsharded', 1.0):.2f}x), "
        f"{t['launches_per_call']} launches, {100 * t['busy']:.0f}%" for n, t in times.items()))
    out["times"] = times


def train_mesh(report: dict) -> None:
    """Training on device meshes of positions of one card (core/meshes.py):
    the shard structure's checks and costs, not scaling."""
    import torch

    out = {}
    parts = {}
    for name, fn in (("data_parallel", lambda: tm_data_parallel(report, out)),
                     ("module_tp", lambda: tm_module_tp(report, out)),
                     ("captured", lambda: tm_captured(report, out)),
                     ("pipeline", lambda: tm_pipeline(report, out)),
                     ("cli", lambda: tm_cli(report, out)),
                     ("times", lambda: tm_times(out))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        parts[name] = time.perf_counter() - t0
    _TM_WEIGHTS.clear()
    out["part_s"] = parts
    log("train_mesh phase by part (s): " + ", ".join(f"{n} {v:.1f}" for n, v in parts.items()))
    report["train_mesh"] = out


# ---------------------------------------------------------------------------
# dist: meshes across processes — two processes of the port on cuda:0 over
# gloo (NCCL refuses two ranks on one card), each with four positions
# ---------------------------------------------------------------------------
DIST_TIMEOUT = 180           # a child's own limit (s): a hang fails the phase
DIST_POSITIONS = 4           # $QST_TORCH_VIRTUAL_DEVICES in each child: 8 global positions
DIST_QUERIES = 256           # bench.py's exact search at Q = 256


def dist_meshes(devices, ranks) -> dict:
    """The DP 4 x 1 and DP + TP 4 x 2 meshes over eight positions (ranks
    [0]*4 + [1]*4 across the children, [0]*8 in one process): 4 x 1 takes two
    positions of each process, 4 x 2 all eight (a row a pair of one
    process's positions)."""
    from qst_tpu_torch.core.meshes import make_mesh

    pick = [0, 1, 4, 5]
    return {"DP 4x1": make_mesh(4, 1, devices=[devices[i] for i in pick],
                                ranks=[ranks[i] for i in pick]),
            "DP+TP 4x2": make_mesh(4, 2, devices=devices, ranks=ranks)}


def state_digest(state) -> str:
    """sha256 of every parameter and Adam moment's bytes, in order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in state.optimizer.state_tensors():
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class GatherClock:
    """While entered: host time spent in ``core/meshes.py:gather_ordered``,
    the device's queued work synchronised before and after each gather so
    that it is not charged to the gather. The syncs are the clock's own, not
    the program's: a pass under the clock is timed apart from the pass that
    gives ms a step."""

    def __enter__(self):
        import torch

        from qst_tpu_torch.core import meshes
        from qst_tpu_torch.parallel import sharding

        self.s, self.calls = 0.0, 0
        self.inner = inner = meshes.gather_ordered

        def timed(t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(t)
            torch.cuda.synchronize()
            self.s += time.perf_counter() - t0
            self.calls += 1
            return out

        meshes.gather_ordered = sharding.gather_ordered = timed
        return self

    def __exit__(self, *exc):
        from qst_tpu_torch.core import meshes
        from qst_tpu_torch.parallel import sharding

        meshes.gather_ordered = sharding.gather_ordered = self.inner


def timed_passes(fn, reps: int, clocked: bool) -> dict:
    """ms a call of ``fn`` over ``reps`` calls (host clock, synchronised);
    with ``clocked``, a second pass of ``reps`` calls under a
    :class:`GatherClock`: its ms a call, the gathers' ms and count a call,
    and their share of that pass. Each pass starts at a barrier of the
    group, so that no process's window holds its wait for another's host
    work before it (a profile's processing, say)."""
    import torch

    from qst_tpu_torch.core.meshes import barrier

    torch.cuda.synchronize()
    barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3 / reps}
    if clocked:
        barrier()
        with GatherClock() as clock:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / reps
        out.update(clocked_ms=ms, gather_ms=clock.s * 1e3 / reps,
                   gathers=clock.calls / reps, gather_share=clock.s * 1e3 / reps / ms)
    return out


def names_in_child(fn, marks, reps: int = 3) -> dict:
    """{mark: launches a call of the device kernels whose names hold it}, from
    torch.profiler over ``reps`` calls of ``fn`` (rounded up, as
    ``kernel_counts``; one try only, so that the two processes of the group
    make the same calls and collectives)."""
    counts = kernel_counts(fn, reps=reps, tries=1)
    return {m: by_mark(counts, m) for m in marks}


TRAIN_MARKS = ("::attention_mma_kernel", "::attention_bwd_mma_kernel", "quadruplet_fwd_kernel",
               "quadruplet_bwd_kernel")
SEARCH_MARKS = {"exact": ("bucket_max", "rescore_"), "ivf": ("ivf_cell_scores_kernel",)}


def dist_train(meshes: dict, child: bool = False) -> dict:
    """Two steps (keys (14, 1) and (14, 2)) of the training configuration on
    each mesh from one seed's weights: the losses, the digest of the state
    after them, K1 / K2 / K3 launches of this process; then ms a step over
    three more steps (``timed_passes``). In a ``child`` of the group also the
    kernels by name in three profiled steps, and the gathers' share in a
    clocked pass."""
    import torch

    from qst_tpu_torch.train import dropout_key, make_train_step

    enc_cfg, loss_cfg, tcfg = train_config()
    ids_np, mask_np = tm_batch(31, enc_cfg.vocab_size)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    out = {}
    for label, mesh in meshes.items():
        state = tm_state(enc_cfg, loss_cfg, tcfg, mesh)
        step = make_train_step(enc_cfg, loss_cfg, None, mesh)
        counters = train_counters()
        for c in counters:
            c.launches = 0
        losses = [step(state, ids, mask, dropout_key(14, s))[1].item() for s in (1, 2)]
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        digest = state_digest(state)
        key = dropout_key(14, 3)
        out[label] = {"losses": losses, "digest": digest, "launches": launches,
                      "names": names_in_child(lambda: step(state, ids, mask, key), TRAIN_MARKS)
                      if child else None,
                      **timed_passes(lambda: step(state, ids, mask, key), 3, child)}
        del state, step
        torch.cuda.empty_cache()
    return out


def dist_corpora():
    """bench.py's exact corpus (1M x 384 unit rows, Q = 256 queries) and the
    ivf phase's cells (1,024 of 2,048 x 384 bf16), from seeds on the card."""
    import torch

    unit = torch.nn.functional.normalize
    gen = torch.Generator(device="cuda").manual_seed(41)
    rows = unit(torch.randn((MESH_ROWS, 384), device="cuda", generator=gen), dim=1)
    queries = unit(torch.randn((DIST_QUERIES, 384), device="cuda", generator=gen), dim=1)
    return rows, queries, ivf_cells(torch.Generator(device="cuda").manual_seed(43))


def dist_search(mesh, corpora, child: bool = False) -> dict:
    """The exact search (bf16, k = 10, "auto": K4 + K5 in every shard) and
    the IVF search (n_probe 8, K6 in every shard) at Q = 256 on ``mesh`` (or
    unsharded for None): answers, this process's K4 / K5 / K6 launches, ms
    a search (``timed_passes``) and, in a ``child`` of the group, the
    kernels by name and the gathers' share."""
    import torch

    from qst_tpu_torch.retrieval import ExactIndex, IVFIndex

    rows, queries, (centroids, cells, cell_ids, fill) = corpora
    out = {}
    exact = ExactIndex(rows, dtype="bfloat16", mesh=mesh)
    ivf = IVFIndex.from_arrays(centroids, cells, cell_ids, fill, mesh=mesh)
    gen = torch.Generator(device="cuda").manual_seed(44)
    pick = torch.randint(0, MESH_CELLS, (DIST_QUERIES,), device="cuda", generator=gen)
    q_ivf = torch.nn.functional.normalize(centroids[pick] + 0.3 * torch.randn(
        (DIST_QUERIES, 384), device="cuda", generator=gen), dim=1)
    for name, fn in (("exact", lambda: exact._device_search(queries, 10, "dot_score", 131072,
                                                             "auto")),
                     ("ivf", lambda: ivf._device_search(q_ivf, 10, 8, "auto"))):
        reset_counts()
        s, i = fn()
        torch.cuda.synchronize()
        launches = read_counts()
        out[name] = {"scores": s.cpu(), "ids": i.cpu(), "launches": launches,
                     "names": names_in_child(fn, SEARCH_MARKS[name]) if child else None,
                     **timed_passes(fn, 5, child)}
    out["ivf_queries"] = q_ivf
    return out


DIST_ATTENTION = (4, 12, 4096, 32)     # B, heads, S, head width of the ring and context runs
K9_KERNEL = "module_keep_kernel"
# stages (pipelines) or rows (tensor-parallel) a process runs of each layout:
# (child 0, child 1, one process)
LAYOUT_SHARES = {"GPipe 2x1": (1, 1, 2), "circular 3x1": (2, 1, 3), "TP 1x2": (1, 1, 1),
                 "DP+TP 2x2": (1, 2, 2)}


def layout_want(label: str, share: int) -> tuple:
    """A layout's launches a step by wrapper, and by kernel name, in a
    process that runs ``share`` of its stages or rows (MiniLM-L6, M = 4):
    K9 once for the embeddings and once a dropout site of each layer of
    each microbatch it runs (three sites at attention dropout 0.1, two
    without), K7 and K8 once a layer and microbatch on the flash path, K1
    and K2 once a layer and row on the fused path (K1's attention kernel
    again in K2's recompute), K3 once."""
    L, M = 6, 4
    want = dict.fromkeys(("K1", "K2", "K7", "K8", "K9"), 0)
    want.update({"K3 forward": 1, "K3 backward": 1})
    if label == "GPipe 2x1":
        want["K9"] = 1 + 3 * (share * L // 2) * M
    elif label == "circular 3x1":
        per = share * L // 3 * M
        want.update(K7=per, K8=per, K9=1 + 2 * per)
    else:
        want.update(K1=L * share, K2=L * share)
    names = {K9_KERNEL: want["K9"], "flash_fwd_wgmma_kernel": want["K7"],
             "flash_bwd_prep_kernel": want["K8"], "flash_bwd_wgmma_kernel": want["K8"],
             "::attention_mma_kernel": 2 * want["K1"], "::attention_bwd_mma_kernel": want["K2"],
             "quadruplet_fwd_kernel": 1, "quadruplet_bwd_kernel": 1}
    return want, names


def dist_layout_meshes(devices, ranks) -> dict:
    """The layouts of (d)-(g) over the eight positions (ranks [0]*4 + [1]*4
    across the children, [0]*8 in one process), by position: GPipe 2 x 1
    and the ring's 2 x 1 over positions 0 and 4 (one stage, one block a
    process), circular 3 x 1 over 0, 1, 4 (ranks [0, 0, 1]), TP 1 x 2 over 0
    and 4 (the row split [0, 1]), DP + TP 2 x 2 over 0, 4, 5, 6 (ranks [0, 1,
    1, 1]: row 0 split, row 1 in process 1)."""
    from qst_tpu_torch.core.meshes import make_mesh, make_pipe_mesh

    def at(*idx):
        return [devices[i] for i in idx], [ranks[i] for i in idx]

    return {"GPipe 2x1": make_pipe_mesh(2, 1, *at(0, 4)),
            "circular 3x1": make_pipe_mesh(3, 1, *at(0, 1, 4)),
            "TP 1x2": make_mesh(1, 2, *at(0, 4)),
            "DP+TP 2x2": make_mesh(2, 2, *at(0, 4, 5, 6)),
            "attention 2x1": make_mesh(2, 1, *at(0, 4))}


def layout_digest(state) -> str:
    """sha256 of a layout's checkpoint dict (parameters and Adam moments
    under the checkpoint's names, gathered from every process: all call
    this together)."""
    import hashlib

    import torch

    sd = state.state_dict()
    h = hashlib.sha256()
    for part in (sd["model"], *sd["optimizer"]["moments"].values()):
        names = sorted(part)
        h.update("\n".join(names).encode())
        h.update(torch.cat([part[n].detach().contiguous().reshape(-1).view(torch.uint8)
                            for n in names]).cpu().numpy().tobytes())
    return h.hexdigest()


def layout_counters():
    """(name, wrapper) of every kernel the layouts' paths launch."""
    from qst_tpu_torch.ops import fused_layer as fl

    return tuple(zip(("K1", "K2", "K3 forward", "K3 backward"), train_counters())) + (
        ("K7", flash_counters()[0]), ("K8", flash_counters()[1]), ("K9", fl.module_keep_mask))


def dist_layouts(meshes: dict, child: bool = False) -> dict:
    """(d) GPipe 2 x 1 (M = 4, nn.Module layers, dropout 0.1), (e) circular
    3 x 1 (v = 2, M = 4, use_flash_attention, attention dropout 0, hidden
    0.1), (f) TP 1 x 2 and DP + TP 2 x 2 fused steps (the training
    configuration): two steps each (keys (14, 1), (14, 2)) from one seed's
    weights → the losses, the gathered state's digest, this process's
    launches by wrapper, ms a step over two more (``timed_passes``) and, in
    a ``child``, the kernels by name in two profiled steps. (g) context and
    ring attention at DIST_ATTENTION, f32, forward and the q / k / v
    gradients of Σ out · w: the digest of output and gradients, ms a call."""
    import dataclasses
    import hashlib

    import torch

    from qst_tpu_torch.parallel import context_parallel_attention, ring_attention
    from qst_tpu_torch.parallel.pipeline import (
        PipelineLayout,
        make_pp_train_step,
        pp_params_from_encoder,
    )
    from qst_tpu_torch.train import dropout_key, make_train_step
    from qst_tpu_torch.train.train_step import TrainState, make_optimizer

    enc_cfg, loss_cfg, tcfg = train_config()
    module = dataclasses.replace(enc_cfg, use_fused_layer=False)
    flash = dataclasses.replace(module, use_flash_attention=True, attention_dropout=0.0)
    ids_np, mask_np = tm_batch(38, enc_cfg.vocab_size)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    out = {}

    def pipeline(cfg, mesh, pipe, M, V):
        model = pp_params_from_encoder(tm_weights(enc_cfg), cfg, pipe, mesh, V)
        state = TrainState(step=0, model=model,
                           optimizer=make_optimizer(tcfg, 100, model.parameters()),
                           layout=PipelineLayout(cfg, pipe, V, mesh))
        return state, make_pp_train_step(cfg, loss_cfg, None, mesh, pipe, M, V)

    forms = {"GPipe 2x1": lambda: pipeline(module, meshes["GPipe 2x1"], 2, 4, 1),
             "circular 3x1": lambda: pipeline(flash, meshes["circular 3x1"], 3, 4, 2)}
    for label in ("TP 1x2", "DP+TP 2x2"):
        forms[label] = lambda m=meshes[label]: (tm_state(enc_cfg, loss_cfg, tcfg, m),
                                                make_train_step(enc_cfg, loss_cfg, None, m))
    counters = layout_counters()
    for label, make in forms.items():
        clock = [time.perf_counter()]

        def lap():
            clock.append(time.perf_counter())
            return clock[-1] - clock[-2]

        state, step = make()
        made = lap()
        for _, c in counters:
            c.launches = 0
        losses = [step(state, ids, mask, dropout_key(14, s))[1].item() for s in (1, 2)]
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters}
        stepped = lap()
        key = dropout_key(14, 3)
        marks = tuple(layout_want(label, 1)[1])
        out[label] = {"losses": losses, "digest": layout_digest(state), "launches": launches}
        digested = lap()
        out[label]["names"] = (names_in_child(lambda: step(state, ids, mask, key), marks, 2)
                               if child else None)
        named = lap()
        out[label].update(timed_passes(lambda: step(state, ids, mask, key), 2, False))
        out[label]["part_s"] = {"make": made, "steps": stepped, "digest": digested,
                                "names": named, "timed": lap()}
        del state, step
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(45)
    q, k, v, w = (torch.randn(DIST_ATTENTION, device="cuda", generator=gen) for _ in range(4))
    mesh = meshes["attention 2x1"]
    for scheme, fn in (("context", context_parallel_attention), ("ring", ring_attention)):
        def call(fn=fn):
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            o = fn(*xs, mesh, "data")
            (o * w).sum().backward()
            return [o.detach(), *[x.grad for x in xs]]

        got = call()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in got:
            h.update(t.cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        full = torch.cat([t.reshape(-1) for t in got])
        out[scheme] = {"digest": h.hexdigest(), "finite": bool(torch.isfinite(full).all()),
                       **timed_passes(call, 2, False)}
        del got, full
        torch.cuda.empty_cache()
    return out


def dist_child(rank: int, port: str, dest: str) -> None:
    """One process of the dist phase's group (``--dist_child``): training
    on both meshes, then both searches, on the global positions; its
    results under ``dest``."""
    import torch
    import torch.distributed as dist

    from qst_tpu_torch.core.meshes import global_devices, initialize_distributed

    os.environ.update({"QST_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                       "QST_NUM_PROCESSES": "2", "QST_PROCESS_ID": str(rank),
                       "QST_TORCH_VIRTUAL_DEVICES": str(DIST_POSITIONS)})
    torch.backends.cuda.matmul.allow_tf32 = False
    if not initialize_distributed(device="cuda:0", backend="gloo"):
        fail("dist child: the group was not created")
    try:
        # wait for the parent's one-process references: the children's times
        # are then their own (they share the card with each other only)
        t0 = time.perf_counter()
        while not os.path.exists(os.path.join(dest, "go")):
            if time.perf_counter() - t0 > DIST_TIMEOUT:
                fail("dist child: the parent never said go")
            time.sleep(0.05)
        probe = torch.full((2,), float(rank), device="cuda")
        parts = [torch.empty_like(probe) for _ in range(2)]
        try:
            dist.all_gather(parts, probe)
            all_gather = "takes CUDA tensors" if [p[0].item() for p in parts] == [0, 1] \
                else "gathered wrong values"
        except (RuntimeError, ValueError) as e:
            all_gather = f"refuses CUDA tensors: {str(e)[:160]}"
        devices, ranks = global_devices("cuda:0")
        t0 = time.perf_counter()
        res = {"ranks": ranks, "gloo_all_gather": all_gather,
               "train": dist_train(dist_meshes(devices, ranks), child=True)}
        t1 = time.perf_counter()
        search_mesh = dist_meshes(devices, ranks)["DP+TP 4x2"]
        res.update(dist_search(search_mesh, dist_corpora(), child=True))
        res.pop("ivf_queries")
        t2 = time.perf_counter()
        res["layouts"] = dist_layouts(dist_layout_meshes(devices, ranks), child=True)
        res["part_s"] = {"train": t1 - t0, "search": t2 - t1,
                         "layouts": time.perf_counter() - t2}
        torch.save(res, os.path.join(dest, f"dist_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dist(report: dict) -> None:
    """Meshes across processes on one card: two processes of the port
    (``--dist_child``) join a gloo group over cuda:0, four positions each.
    (a) DP 4 x 1 and DP + TP 4 x 2 training (MiniLM-L6, batch 32
    quadruplets, S = 128, bf16, fused layer and loss, dropout 0.1), two
    steps: losses equal on both ranks, the parameters and moments bit-equal
    between the ranks and to this process's one-process mesh of the same
    shape, 12 K1 + 12 K2 and K3 1 + 1 a step in each process. (b) bench.py's
    exact search (1M x 384 bf16, k = 10, Q = 256) and (c) IVF (1,024 cells
    of 2,048, n_probe 8) over 4 x 2: both ranks' answers the one-process
    mesh's bit for bit and the unsharded search's up to ties, 4 K4 + 4 K5
    and 4 K6 in each process. (d)-(g): the pipeline, a split mesh row and
    sequence-sharded attention across the processes (``dist_layouts``,
    ``dist_check_layouts``). Times beside the one-process mesh's: the cost
    of the structure on one card (two processes share it), not scaling."""
    import socket
    import tempfile

    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items() if not k.startswith("QST_")}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dist_") as dest:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist_child",
                                   str(r), port, dest], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        # the one-process references while the children start
        positions = ["cuda:0"] * (2 * DIST_POSITIONS)
        t_ref = time.perf_counter()
        one = dist_train(dist_meshes(positions, [0] * len(positions)))
        corpora = dist_corpora()
        one_search = dist_search(dist_meshes(positions, [0] * len(positions))["DP+TP 4x2"],
                                 corpora)
        plain = dist_search(None, corpora)
        one_layouts = dist_layouts(dist_layout_meshes(positions, [0] * len(positions)))
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t_ref
        with open(os.path.join(dest, "go"), "w"):
            pass
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DIST_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            fail(f"dist: a child ran past its {DIST_TIMEOUT} s limit")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                fail(f"dist: child {r} exited {p.returncode}:\n{text[-3000:]}")
        kids = [torch.load(os.path.join(dest, f"dist_{r}.pt"), weights_only=False)
                for r in range(2)]
    wall = time.perf_counter() - t0
    L = train_config()[0].num_layers
    res = {"gloo_all_gather": kids[0]["gloo_all_gather"], "ranks": kids[0]["ranks"]}
    # a step in each process: K1's attention kernel once a layer and data
    # shard, K2's recompute of it as often, K2's attention backward once,
    # K3's two kernels once
    want_names = dict(zip(TRAIN_MARKS, (2 * L * 2, L * 2, 1, 1)))
    for label, ref in one.items():
        a, b = kids[0]["train"][label], kids[1]["train"][label]
        want = [2 * L * 2, 2 * L * 2, 2, 2]     # two steps, two data shards a process
        ok = (a["losses"] == b["losses"] == ref["losses"] and a["digest"] == b["digest"]
              == ref["digest"] and a["launches"] == b["launches"] == want
              and a["names"] == b["names"] == want_names)
        log(f"dist {label} across 2 processes x {DIST_POSITIONS} positions of cuda:0 (gloo; "
            f"MiniLM-L6, batch 32 quadruplets, S=128, bf16, fused, dropout 0.1): losses "
            f"{a['losses']} / {b['losses']} (one process {ref['losses']}); state after two "
            f"steps bit-equal between the ranks and to one process "
            f"{a['digest'] == b['digest'] == ref['digest']}; launches a process K1 "
            f"{a['launches'][0]}, K2 {a['launches'][1]}, K3 {a['launches'][2]} + "
            f"{a['launches'][3]} over two steps (want {want}); by name a step in a profiled "
            f"window {a['names']} / {b['names']} (want {want_names}); {a['ms']:.2f} / "
            f"{b['ms']:.2f} ms a step against {ref['ms']:.2f} ms on one process's mesh; "
            f"in a pass under the gather clock {a['clocked_ms']:.2f} / {b['clocked_ms']:.2f} ms "
            f"a step, of it gathers {a['gather_ms']:.2f} / {b['gather_ms']:.2f} ms "
            f"({a['gathers']:.0f} a step)")
        if not ok:
            fail(f"dist {label}: ranks or the one-process mesh disagree, or launches "
                 f"{a['launches']} / {b['launches']} (want {want}), or kernels by name "
                 f"{a['names']} / {b['names']} (want {want_names})")
        add_train_launches(report, a["launches"])
        res[label] = {"losses": a["losses"], "launches_per_process": a["launches"],
                      "names_per_process_step": a["names"], "step_ms": [a["ms"], b["ms"]],
                      "one_process_step_ms": ref["ms"],
                      "clocked_step_ms": [a["clocked_ms"], b["clocked_ms"]],
                      "gather_ms": [a["gather_ms"], b["gather_ms"]],
                      "gather_share": [a["gather_share"], b["gather_share"]]}
    rows, queries = corpora[0], corpora[1]
    for name, want in (("exact", {"K4": 4, "K5": 4}), ("ivf", {"K6": 4})):
        a, b, ref, base = kids[0][name], kids[1][name], one_search[name], plain[name]
        launches = {k: v for k, v in a["launches"].items() if v}
        names = dict(zip(SEARCH_MARKS[name], want.values()))
        same = all(torch.equal(x[f], ref[f]) for x in (a, b) for f in ("scores", "ids"))
        if name == "exact":
            true = truth_of(queries.to(torch.bfloat16), rows.to(torch.bfloat16),
                            (base["ids"].cuda(), a["ids"].cuda()))
            near = ids_match_up_to_ties(a["scores"], a["ids"], base["scores"], base["ids"],
                                        true, 1e-4)
        else:
            true = ivf_truth(corpora[2][1], corpora[2][2], one_search["ivf_queries"],
                             (base["ids"], a["ids"]))
            near = rows_match_up_to_ties((a["scores"], a["ids"]), (base["scores"], base["ids"]),
                                         true, 1e-4)
        log(f"dist {name} search at Q={DIST_QUERIES} over 4 x 2 across 2 processes: answers "
            f"bit-equal on both ranks and to one process {same}, the unsharded search's up to "
            f"ties {near}; launches a process {launches} (want {want}), by name "
            f"{a['names']} / {b['names']} (want {names}); {a['ms']:.3f} / {b['ms']:.3f} ms a "
            f"search against {ref['ms']:.3f} ms on one process's mesh and {base['ms']:.3f} ms "
            f"unsharded; under the gather clock {a['clocked_ms']:.3f} / {b['clocked_ms']:.3f} "
            f"ms, of it gathers {a['gather_ms']:.3f} / {b['gather_ms']:.3f} ms")
        if not (same and near and launches == want and b["launches"] == a["launches"]
                and a["names"] == b["names"] == names):
            fail(f"dist {name}: answers or launches disagree ({launches}, want {want}; by "
                 f"name {a['names']} / {b['names']}, want {names})")
        for k, v in launches.items():
            report[k]["launches"] = report[k].get("launches", 0) + v
        res[name] = {"ms": [a["ms"], b["ms"]], "one_process_ms": ref["ms"],
                     "unsharded_ms": base["ms"],
                     "clocked_ms": [a["clocked_ms"], b["clocked_ms"]],
                     "gather_ms": [a["gather_ms"], b["gather_ms"]],
                     "gather_share": [a["gather_share"], b["gather_share"]],
                     "launches_per_process": launches, "names_per_process": a["names"]}
    res["layouts"] = dist_check_layouts(report, one_layouts, [k["layouts"] for k in kids])
    res.update(wall_s=wall, one_process_s=t_ref, child_part_s=[k["part_s"] for k in kids])
    log(f"dist: gloo all_gather {res['gloo_all_gather']}; phase {wall:.1f} s: the one-process "
        f"references {t_ref:.1f} s, then the children by part (s) "
        + " / ".join(", ".join(f"{n} {v:.1f}" for n, v in k["part_s"].items()) for k in kids))
    report["dist"] = res


def dist_check_layouts(report: dict, one: dict, kids: list) -> dict:
    """(d)-(g) of the dist phase: each layout's losses and state (or the
    attention's output and gradients) the same on both ranks and the same
    bits as the one-process mesh of its shape; each child's launches by
    wrapper and by kernel name those of the stages or rows it runs
    (``layout_want``); ms beside the one-process mesh's."""
    out = {}
    for label, (s0, s1, s_one) in LAYOUT_SHARES.items():
        a, b, ref = kids[0][label], kids[1][label], one[label]
        wants = [layout_want(label, n) for n in (s0, s1, s_one)]
        launch_ok = all(x["launches"] == {n: 2 * v for n, v in w[0].items()}
                        for x, w in zip((a, b, ref), wants))
        names_ok = all(x["names"] == w[1] for x, w in zip((a, b), wants))
        same = a["losses"] == b["losses"] == ref["losses"] and \
            a["digest"] == b["digest"] == ref["digest"]
        log(f"dist {label} across 2 processes (gloo on cuda:0; MiniLM-L6, batch 32 "
            f"quadruplets, S=128, bf16, dropout 0.1): losses {a['losses']} / {b['losses']} "
            f"(one process {ref['losses']}); parameters and moments, gathered, bit-equal "
            f"between the ranks and to one process {same}; launches over two steps "
            f"{a['launches']} / {b['launches']} (one process {ref['launches']}; want "
            f"{[{n: 2 * v for n, v in w[0].items()} for w in wants]}); by name a step "
            f"{a['names']} / {b['names']} (want {wants[0][1]} / {wants[1][1]}); "
            f"{a['ms']:.1f} / {b['ms']:.1f} ms a step against {ref['ms']:.1f} ms on one "
            f"process's mesh (the structure's cost on one card, not scaling)")
        log(f"dist {label} by part (s), child 0 / child 1 / one process: "
            + " / ".join(", ".join(f"{n} {v:.2f}" for n, v in x["part_s"].items())
                         for x in (a, b, ref)))
        if not (same and launch_ok and names_ok):
            fail(f"dist {label}: ranks or the one-process mesh disagree, or launches / "
                 f"kernels by name are not the layout's")
        for x in (a, b):
            add_train_launches(report, [x["launches"][n] for n in COUNTED])
            add_keep_launches(report, x["launches"]["K9"])
            for n in ("K7", "K8"):
                report[n]["launches"] = report[n].get("launches", 0) + x["launches"][n]
        out[label] = {"losses": a["losses"], "launches_per_process": [a["launches"],
                                                                      b["launches"]],
                      "names_per_process_step": [a["names"], b["names"]],
                      "step_ms": [a["ms"], b["ms"]], "one_process_step_ms": ref["ms"]}
    for scheme in ("context", "ring"):
        a, b, ref = kids[0][scheme], kids[1][scheme], one[scheme]
        same = a["digest"] == b["digest"] == ref["digest"]
        log(f"dist {scheme} attention over 2 x 1 across 2 processes at {DIST_ATTENTION} f32 "
            f"(B, heads, S, head width): output and q / k / v gradients bit-equal between "
            f"the ranks and to one process {same}, finite {a['finite']}; forward + backward "
            f"{a['ms']:.1f} / {b['ms']:.1f} ms against {ref['ms']:.1f} ms on one process's "
            f"mesh (the structure's cost on one card, not scaling)")
        if not (same and a["finite"]):
            fail(f"dist {scheme} attention: the ranks or the one-process mesh disagree")
        out[scheme] = {"ms": [a["ms"], b["ms"]], "one_process_ms": ref["ms"]}
    return out


# ---------------------------------------------------------------------------
# flash: the long-document path (use_flash_attention) through K7 and K8
# ---------------------------------------------------------------------------
# long documents of the end-to-end encode and search: ExactIndex's dispatch rule
# takes K4 + K5 from PALLAS_MIN_DOCS (65,536) documents on
FLASH_DOCS = 65536
FLASH_QUERIES = 256
FLASH_SEQS = (128, 256, 512, 2048)
FLASH_TRAIN_INSTANCES = 80  # 10 steps of 8 quadruplets
# the CUDA kernels of K7 and K8 (bf16), as the profiler names them
K7_KERNEL = "flash_fwd_wgmma_kernel"
K8_KERNELS = ("flash_bwd_prep_kernel", "flash_bwd_wgmma_kernel")


def flash_counters():
    from qst_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention, fa.flash_attention_bwd


def flash_segments(B: int, S: int, dev, gen):
    """(B, S) int32 segment ids as the encoder makes them from its masks (1
    real, 0 padding): sequence 0 all real, 1 padded after two thirds, 2
    all padding, the rest random lengths from S/4 up."""
    import torch

    lens = torch.randint(S // 4, S + 1, (B,), generator=gen)
    lens[0], lens[1] = S, 2 * S // 3
    if B > 2:
        lens[2] = 0
    return (torch.arange(S)[None, :] < lens[:, None]).to(torch.int32).to(dev)


def flash_no_match(seg_kv):
    """seg_q for seg_kv from ``flash_segments`` in which some query rows
    match no key: sequence 0's row 5 and sequence 1's first three rows get
    segments no key has, and sequence 2 (all padding) gets real queries in
    its second half."""
    seg = seg_kv.clone()
    seg[0, 5] = 7
    seg[1, :3] = 3
    if seg.shape[0] > 2:
        seg[2, seg.shape[1] // 2:] = 1
    return seg


def flash_docs(n: int, seed: int) -> list:
    """n documents of 300-450 words of the synthetic vocabulary (w0 .. w4999):
    [CLS], the words and [SEP] land in the 512 bucket."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(5000)]
    return [" ".join([words[j] for j in rng.integers(0, 5000, int(rng.integers(300, 451)))
                      .tolist()]) for _ in range(n)]


def check_flash_kernels(report: dict) -> None:
    """K7 and K8 against their plain versions on the port's (B, S, nh, hd)
    activations seen as (B, nh, S, hd): hd 16 / 32 / 64, S 128 / 256 / 512 /
    2,048, f32 and bf16, a padded sequence and an all-padding one; at S =
    256 with seg_q != seg_kv and query rows that match no key (the library's
    uniform average over every key, which a skipped masked tile would
    break); and in bf16 at the main path's own shapes, 12 heads of 32 at S = 512 with the
    train step's B = 32 and the encode batch's B = 256. f32: o
    within 1e-4, each gradient within 1e-4 of its largest value; bf16: o
    within K1's forward bars, each gradient within 2e-2 of its largest value
    at most and 2^-7 of its mean (K2's); the row statistics within 1e-4
    relative; K8 bit-equal between two calls."""
    import torch

    from qst_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(71)
    worst = {}
    cases = [(dtype, 3, 2, S, hd, False) for dtype in (torch.float32, torch.bfloat16)
             for hd in (16, 32, 64) for S in FLASH_SEQS]
    cases += [(dtype, 3, 2, 256, hd, True) for dtype in (torch.float32, torch.bfloat16)
              for hd in (16, 32, 64)]
    cases += [(torch.bfloat16, 32, 12, 512, 32, False), (torch.bfloat16, 256, 12, 512, 32, False)]
    for dtype, B, nh, S, hd, no_match in cases:
        name, sc = str(dtype).split(".")[-1], hd ** -0.5
        q, k, v, do = (torch.randn((B, S, nh, hd), generator=gen).to(dev, dtype)
                       .transpose(1, 2) for _ in range(4))
        seg = seg_kv = flash_segments(B, S, dev, gen)
        if no_match:   # seg_q != seg_kv: query rows whose segment no key has
            seg = flash_no_match(seg_kv)
        what = (f"K7/K8 {name} B={B} nh={nh} hd={hd} S={S}"
                + (" seg_q != seg_kv, rows matching no key" if no_match else ""))
        o, m, l = fa.flash_attention(q, k, v, seg, seg_kv, sc, return_stats=True)
        o_p, m_p, l_p = fa.flash_attention_plain(q, k, v, seg, seg_kv, sc,
                                                 return_stats=True)
        g = fa.flash_attention_bwd(q, k, v, seg, seg_kv, o, m, l, do, sc)
        g2 = fa.flash_attention_bwd(q, k, v, seg, seg_kv, o, m, l, do, sc)
        g_p = fa.flash_attention_bwd_plain(q, k, v, seg, seg_kv, o, m, l, do, sc)
        torch.cuda.synchronize()
        stats = max(((m - m_p).abs() / (1 + m_p.abs())).max().item(),
                    ((l - l_p).abs() / l_p).max().item())
        if stats > 1e-4:
            fail(f"{what}: row statistics {stats:.3e} from the plain version's")
        if not all(torch.equal(a, b) for a, b in zip(g, g2)):
            fail(f"{what}: two K8 calls differ")
        if dtype == torch.float32:
            o_err = (o - o_p).abs().max().item()
            if o_err > 1e-4:
                fail(f"{what}: K7 max|err| {o_err:.3e} (limit 1e-4)")
        else:
            diff = (o.float() - o_p.float()).abs()
            o_err = diff.max().item()
            ulps = (diff / (bf16_ulp(o_p.float()) + 2.0 ** -7)).max().item()
            mean_rel = (diff.mean() / o_p.float().abs().mean()).item()
            if not (o_err <= 2e-2 * o_p.float().abs().max().item() and ulps <= 2.0
                    and mean_rel <= 2.0 ** -10):
                fail(f"{what}: K7 outside K1's bf16 bars: max|err| {o_err:.3e}, worst "
                     f"element {ulps:.2f} x (ulp + 2^-7), mean rel {mean_rel:.3e}")
        g_err = 0.0
        for gn, a, r in zip("qkv", g, g_p):
            d, r = (a.float() - r.float()).abs(), r.float().abs()
            g_err = max(g_err, d.max().item())
            rel_max = d.max().item() / r.max().item()
            rel_mean = (d.mean() / r.mean()).item()
            limit = (1e-4, None) if dtype == torch.float32 else (2e-2, 2.0 ** -7)
            if rel_max > limit[0] or (limit[1] is not None and rel_mean > limit[1]):
                fail(f"{what}: d{gn} max|err|/max|ref| {rel_max:.3e}, mean "
                     f"{rel_mean:.3e} (limits {limit})")
        w = worst.setdefault(name, {"o": 0.0, "grads": 0.0})
        w["o"], w["grads"] = max(w["o"], o_err), max(w["grads"], g_err)
        if nh == 12:   # the main path's shapes: K7 in encode, K8 in train
            log(f"{what} (the main path's shape): K7 max|err| {o_err:.3e}, K8 "
                f"max|err| {g_err:.3e}, K8 bit-equal between calls")
            if B == 256:
                report["K7"]["max_abs_err"] = o_err
            else:
                report["K8"]["max_abs_err"] = g_err
        del q, k, v, do, o, o_p, g, g2, g_p
    report["flash"]["kernel_max_abs_err"] = worst
    log(f"K7/K8 against the plain versions at hd 16/32/64, S {FLASH_SEQS}, f32 and bf16 "
        f"(padded and all-padding sequences; seg_q != seg_kv with rows that match no key at "
        f"S = 256), and bf16 at (32 and 256, 12, 512, 32); K8 bit-equal between calls: "
        f"worst max|err| {worst}")
    torch.cuda.empty_cache()


def flash_encode_search(report: dict, vocab: str) -> None:
    """MiniLM-L6 at full width with use_flash_attention and max_seq_length
    512 behind the native WordPiece tokenizer: 65,536 documents of 300-450
    words through Retriever.build (SentenceEncoder.encode → ExactIndex,
    bf16), 256 queries through Retriever.search (K4 + K5); 6 K7 launches an
    encode batch; the answers against the plain scan over the same query
    embeddings; the embeddings against the einsum path's (flag off, same
    weights) at cosine >= 0.999; no library attention kernel, and no GEMM
    for attention, in a profiled encode batch."""
    import dataclasses

    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params
    from qst_tpu_torch.models.tokenizer import load_tokenizer
    from qst_tpu_torch.native import FastWordPieceTokenizer, native_available
    from qst_tpu_torch.ops import topk
    from qst_tpu_torch.retrieval import Retriever

    cfg = EncoderConfig.minilm_l6(use_flash_attention=True, max_seq_length=512)
    tok = load_tokenizer(vocab, vocab_size=cfg.vocab_size)
    if not (native_available() and isinstance(tok, FastWordPieceTokenizer)
            and tok._handle is not None):
        fail("load_tokenizer did not give the native WordPiece tokenizer (g++ build failed?)")
    params = init_params(cfg, torch.Generator().manual_seed(31), device="cuda")
    enc = SentenceEncoder(cfg, params, tok, device="cuda")
    t0 = time.perf_counter()
    docs = flash_docs(FLASH_DOCS, seed=32)
    rng = np.random.default_rng(33)
    queries = []
    for d in rng.integers(0, FLASH_DOCS, FLASH_QUERIES):
        ws = docs[d].split()
        lo = int(rng.integers(0, len(ws) - 30))
        queries.append(" ".join(ws[lo:lo + 30] + [f"w{j}" for j in rng.integers(0, 5000, 2)]))
    gen_s = time.perf_counter() - t0
    k7, k8 = flash_counters()
    counts = (k7, k8, topk.bucket_maxima, topk.rescore_buckets)
    for c in counts:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    retr = Retriever(enc, score="dot_score", index_dtype="bfloat16").build(docs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = [c.launches for c in counts]
    t0 = time.perf_counter()
    answers = retr.search(queries, k=10)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = [c.launches for c in counts]
    batches = -(-FLASH_DOCS // 256)
    log(f"flash encode + search: {FLASH_DOCS} docs of 300-450 words ({gen_s:.1f} s to make) "
        f"encoded and indexed in {build_s:.1f} s ({FLASH_DOCS / build_s:.0f} docs/s, "
        f"tokenization included), {FLASH_QUERIES} queries searched in {search_s:.3f} s; "
        f"launches K7 {launches[0]} (build {build_launches[0]}), K8 {launches[1]}, "
        f"K4 {launches[2]}, K5 {launches[3]}")
    if build_launches[0] != 6 * batches or launches[0] != build_launches[0]:
        fail(f"K7 launched {build_launches[0]} times in the encode ({6 * batches} wanted: "
             f"6 a batch of 256 at S=512) and {launches[0] - build_launches[0]} in the search")
    if launches[1] or launches[2] - build_launches[2] < 1 or launches[3] - build_launches[3] < 1:
        fail(f"the search did not take K4 + K5 (or K8 ran): {launches}")
    report["K7"]["launches"] = report["K7"].get("launches", 0) + launches[0]

    # the answers against the plain scan over the same query embeddings
    q_emb = enc.encode(queries, convert_to_numpy=False)
    ps, pi = retr.index.search(q_emb, k=10, backend="xla")
    true = (q_emb.to(torch.bfloat16).float() @ retr.index.embeddings.float().T).cpu().numpy()
    ss = np.array([[r[1] for r in row] for row in answers])
    si = np.array([[r[0] for r in row] for row in answers])
    if not ids_match_up_to_ties(ss, si, ps, pi, true, 1e-4):
        fail("the flash path's search answers differ from the plain scan")
    del true

    # the embeddings against the einsum path's: cosine per document
    off = dataclasses.replace(cfg, use_flash_attention=False)
    enc_off = SentenceEncoder(off, params, tok, device="cuda")
    sub = docs[:4096]
    e_on = enc.encode(sub, convert_to_numpy=False)
    e_off = enc_off.encode(sub, convert_to_numpy=False)
    cos = torch.nn.functional.cosine_similarity(e_on, e_off, dim=1).min().item()
    log(f"flash embeddings against the einsum path's (flag off, same weights), "
        f"{len(sub)} documents at S=512: min cosine {cos:.6f} (limit 0.999); search answers "
        f"equal to the plain scan up to ties")
    if not cos >= 0.999:
        fail("the flash path's embeddings disagree with the einsum path's")

    # one encode batch under the profiler: K7 six times, no library attention
    # kernel; the library GEMMs are the projections' (6 a layer), the einsum
    # path's two attention products a layer are gone
    ids, mask = tok.batch_encode(docs[:256], max_length=512)
    ids = torch.from_numpy(ids.astype(np.int64)).cuda()
    mask = torch.from_numpy(mask.astype(np.int64)).cuda()
    L = cfg.num_layers

    def n_lib_gemms(counts: dict) -> int:
        return sum(lib_kernels(counts, LIBRARY_GEMM_MARKS).values())

    names = kernel_counts(lambda: enc.encode_ids(ids, mask),
                          done=lambda c: sum(v for n, v in c.items() if K7_KERNEL in n) == L)
    names_off = kernel_counts(lambda: enc_off.encode_ids(ids, mask),
                              done=lambda c: n_lib_gemms(c) >= n_lib_gemms(names) + 2 * L)
    k7_names = {n: c for n, c in names.items() if K7_KERNEL in n}
    # the einsum path's softmax counts as library attention here
    att = lib_kernels(names, LIBRARY_ATTENTION_MARKS + ("softmax",))
    gemm_off = lib_kernels(names_off, LIBRARY_GEMM_MARKS)
    n_gemm, n_gemm_off = n_lib_gemms(names), n_lib_gemms(names_off)
    log(f"one flash encode batch (256 x 512) under the profiler: K7 {k7_names}; library "
        f"attention kernels {att or 'none'}; library GEMM launches {n_gemm:g} (the einsum "
        f"path's {n_gemm_off:g}: {sorted(set(map(short_name, gemm_off)))})")
    if sum(k7_names.values()) != L or att or n_gemm > 6 * L or n_gemm_off < n_gemm + 2 * L:
        fail("the flash encode ran library attention or GEMMs for attention, or not K7 "
             "once a layer")
    report["flash"].update(encode_search={
        "docs": FLASH_DOCS, "build_s": build_s, "docs_per_s": FLASH_DOCS / build_s,
        "search_s": search_s, "launches": dict(zip(("K7", "K8", "K4", "K5"), launches)),
        "min_cosine_vs_einsum": cos, "library_gemms_per_batch": n_gemm,
        "einsum_library_gemms_per_batch": n_gemm_off})
    del retr, e_on, e_off
    torch.cuda.empty_cache()


def flash_train(report: dict, vocab: str, tmp: str) -> None:
    """Trainer.train with use_flash_attention at S = 512 (MiniLM-L6, bf16,
    batch 8 quadruplets = 32 sequences, attention dropout 0, hidden dropout
    0.1 from the host generator, the fused γ loss): 10 steps, K7 and K8
    each 6 times a step, finite losses; the first step's gradients at
    dropout 0 against the plain versions (cosine >= 0.999; per tensor 5e-2,
    or twice the plain versions' distance from an f32 step where that is
    over 2.5e-2, as the mpnet phase holds them; the key bias, whose true
    gradient is 0, may instead meet the train phase's rule); a falling loss
    on a repeated batch; K7's and K8's kernels by name in one profiled step;
    two captured calls of 2 steps at dropout 0 against 4 eager steps."""
    import dataclasses

    import torch

    from qst_tpu_torch.core.config import EncoderConfig, LossConfig, TrainConfig
    from qst_tpu_torch.core.telemetry import JsonLogSink
    from qst_tpu_torch.data import QuadrupletCollator, QuadrupletDataset
    from qst_tpu_torch.models.tokenizer import load_tokenizer
    from qst_tpu_torch.train import (Trainer, create_train_state, dropout_key, make_multi_step,
                                     make_train_step)
    from qst_tpu_torch.train.train_step import encoder_apply_fn, loss_from_config

    dev = torch.device("cuda")
    enc_cfg = EncoderConfig.minilm_l6(use_flash_attention=True, max_seq_length=512,
                                      attention_dropout=0.0)
    loss_cfg = LossConfig(kind="gamma", use_fused_kernel=True)
    base = TrainConfig(batch_size=8)
    tok = load_tokenizer(vocab, vocab_size=enc_cfg.vocab_size)
    root = f"{tmp}/flash_chunks"
    write_long_chunks(root, FLASH_TRAIN_INSTANCES, seed=35)
    ds = QuadrupletDataset(root, seed=35)
    collator = QuadrupletCollator(tok, max_length=enc_cfg.max_seq_length)
    cfg = dataclasses.replace(base, epochs=1, evaluation_steps=1, checkpoint_save_steps=0,
                              save_best_model=False, experiment_dir=f"{tmp}/flash_exp")
    trainer = Trainer(enc_cfg, loss_cfg, cfg, ds, collator, device=dev)
    k7, k8 = flash_counters()
    k7.launches = k8.launches = 0
    t0 = time.perf_counter()
    result = trainer.train()
    wall = time.perf_counter() - t0
    launches = [k7.launches, k8.launches]
    losses = [e["loss"] for e in JsonLogSink(f"{cfg.experiment_dir}/train_loss.json").read()]
    steps = result.state.step
    log(f"flash Trainer.train: {steps} steps of MiniLM-L6 (8 quadruplets = 32 sequences of "
        f"S=512, bf16, attention dropout 0, hidden 0.1) in {wall:.1f} s, "
        f"{result.steps_per_sec:.2f} steps/s in the loop; launches K7 {launches[0]}, K8 "
        f"{launches[1]}; losses {['%.4f' % v for v in losses]}")
    if steps != FLASH_TRAIN_INSTANCES // 8 or len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"flash Trainer.train: {steps} steps, losses {losses}")
    if launches != [6 * steps, 6 * steps]:
        fail(f"flash Trainer.train: K7 / K8 launched {launches}, want 6 a step each")
    report["K7"]["launches"] = report["K7"].get("launches", 0) + launches[0]
    report["K8"]["launches"] = report["K8"].get("launches", 0) + launches[1]
    batch = collator(ds.sample_batch(range(8), step=0))
    steps_per_s = result.steps_per_sec
    del trainer, result

    # the first step's gradients at dropout 0: K7/K8 against the plain versions
    cfg0 = dataclasses.replace(enc_cfg, hidden_dropout=0.0)
    state, _ = create_train_state(cfg0, base, torch.Generator().manual_seed(36), 10, loss_cfg,
                                  device=dev)
    ids = torch.from_numpy(batch.input_ids.reshape(32, -1).astype(np.int64)).to(dev)
    mask = torch.from_numpy(batch.attention_mask.reshape(32, -1).astype(np.int64)).to(dev)
    grads = []
    for plain in (False, True):
        state.model.zero_grad(set_to_none=True)
        with plain_kernels() if plain else contextlib.nullcontext():
            emb = encoder_apply_fn(cfg0)(state.model, ids, mask, None).reshape(4, 8, -1)
            loss_from_config(loss_cfg)(*emb.unbind(0)).backward()
        torch.cuda.synchronize()
        grads.append({n: p.grad.detach().clone() for n, p in state.model.named_parameters()})
    # the same step in f32 through the plain versions: the reference both
    # bf16 paths round away from
    m32 = type(state.model)(dataclasses.replace(cfg0, dtype="float32")).to(dev)
    m32.load_state_dict(state.model.state_dict())
    with plain_kernels():
        emb = encoder_apply_fn(cfg0)(m32, ids, mask, None).reshape(4, 8, -1)
        loss_from_config(loss_cfg)(*emb.unbind(0)).backward()
    torch.cuda.synchronize()
    exact = {n: p.grad.detach() for n, p in m32.named_parameters()}
    kern, ref = grads
    cos = torch.nn.functional.cosine_similarity(
        torch.cat([g.flatten() for g in kern.values()]),
        torch.cat([g.flatten() for g in ref.values()]), dim=0).item()
    # Per tensor |g_k - g_p| <= 5e-2 |g_p|, as the train phase holds, where
    # the plain bf16 gradient is itself within 2.5e-2 of the f32 one; where
    # it is not, the tensor's gradient is bf16 rounding noise of a sum that
    # cancels (each row of dS sums to 0, so a key component common to the
    # tokens drops out of dQ but its rounding does not), and the kernels'
    # distance from the f32 gradient is held to twice the plain versions'
    # own (the mpnet phase's rule). The key bias's true gradient is 0, so
    # it is that noise alone; it may instead meet the train phase's rule,
    # within 5e-2 of the plain versions' at the query bias's scale
    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    worst, noisy = (0.0, ""), []
    for n, g in ref.items():
        e_kp, e_p32, e_k32 = rel(kern[n], g), rel(g, exact[n]), rel(kern[n], exact[n])
        if e_p32 <= 2.5e-2:
            worst = max(worst, (e_kp, n))
        else:
            noisy.append((n, e_k32, e_p32))
            q_bias = ref[n.replace("key", "query")] if n.endswith("self.key.bias") else None
            if e_k32 > 2 * e_p32 and not (
                    q_bias is not None
                    and (kern[n] - g).norm().item() <= 5e-2 * q_bias.norm().item()):
                fail(f"flash gradient {n}: {e_k32:.3e} from the f32 one, the plain "
                     f"versions' {e_p32:.3e}")
    log(f"flash first step's gradients (S=512, dropout 0), K7/K8 against the plain versions: "
        f"cosine {cos:.6f} (limit 0.999); worst per-tensor |g_k - g_p|/|g_p| {worst[0]:.3e} "
        f"({worst[1]}; limit 5e-2) over {len(ref) - len(noisy)} tensors; {len(noisy)} "
        f"tensors whose plain bf16 gradient is > 2.5e-2 from the f32 one, distance from f32 "
        f"kernels / plain (limit 2x): "
        + ", ".join(f"{n.removeprefix('encoder.layer.')} {a:.3f}/{b:.3f}" for n, a, b in noisy))
    if not (cos >= 0.999 and worst[0] <= 5e-2):
        fail("the flash path's gradients disagree with the plain versions")
    report["flash"]["noise_dominated_grads"] = len(noisy)
    del state, grads, kern, ref, exact, m32

    # a falling loss: 10 steps on one repeated batch, hidden dropout 0.1
    state, _ = create_train_state(enc_cfg, dataclasses.replace(base, learning_rate=1e-4,
                                                               warmup_steps=2),
                                  torch.Generator().manual_seed(37), 10, loss_cfg, device=dev)
    step = make_train_step(enc_cfg, loss_cfg)
    rep = []
    for i in range(10):
        state, loss = step(state, batch.input_ids, batch.attention_mask, dropout_key(38, i + 1))
        rep.append(loss.item())
    log(f"flash: 10 steps on one repeated batch (lr 1e-4, warmup 2): loss {rep[0]:.4f} -> "
        f"{rep[-1]:.4f}")
    if not (all(np.isfinite(rep)) and np.mean(rep[-3:]) < np.mean(rep[:3])):
        fail(f"flash: the loss did not fall: {rep}")
    # one step under the profiler: K7's and K8's CUDA kernels by name, once a
    # layer each (K8 is the statistics pre-pass and the key-block sweep)
    def per_kernel(counts: dict) -> dict:
        return {w: sum(c for n, c in counts.items() if w in n)
                for w in (K7_KERNEL,) + K8_KERNELS}

    names = kernel_counts(
        lambda: step(state, batch.input_ids, batch.attention_mask, dropout_key(38, 11)),
        done=lambda c: all(v == enc_cfg.num_layers for v in per_kernel(c).values()))
    per = per_kernel(names)
    log(f"one flash train step under the profiler: {per} (want {enc_cfg.num_layers} each)")
    if any(c != enc_cfg.num_layers for c in per.values()):
        fail("the flash train step did not run K7's and K8's kernels once a layer")
    report["flash"]["train_step_kernels"] = per
    del state

    # two captured calls of K = 2 steps at dropout 0 (K7/K8 in the graph)
    # against 4 eager steps from the same state
    K = 2
    cfg00 = dataclasses.replace(cfg0, attention_dropout=0.0)
    cids = torch.from_numpy(np.stack([batch.input_ids] * 2 * K).astype(np.int64))
    cmask = torch.from_numpy(np.stack([batch.attention_mask] * 2 * K).astype(np.int64))

    def state_for():
        return create_train_state(cfg00, base, torch.Generator().manual_seed(39), 100,
                                  loss_cfg, device=dev)[0]

    graph_st, eager_st = state_for(), state_for()
    multi = make_multi_step(cfg00, loss_cfg, None, K)
    k7.launches = k8.launches = 0
    graph_losses = []
    for call in range(2):
        graph_st, ls = multi(graph_st, cids[call * K:(call + 1) * K],
                             cmask[call * K:(call + 1) * K], None)
        graph_losses.append(ls)
    torch.cuda.synchronize()
    graph_launches = [k7.launches, k8.launches]
    step = make_train_step(cfg00, loss_cfg)
    eager_losses = []
    for j in range(2 * K):
        eager_st, loss = step(eager_st, cids[j], cmask[j])
        eager_losses.append(loss)
    torch.cuda.synchronize()
    graph_losses, eager_losses = torch.cat(graph_losses), torch.stack(eager_losses)
    tensors = list(zip(graph_st.optimizer.state_tensors(), eager_st.optimizer.state_tensors()))
    names = [f"{n}{part}" for n, p in graph_st.model.named_parameters()
             for part in ("", ".mu", ".nu")]
    differ = [n for n, (a, b) in zip(names, tensors) if not torch.equal(a, b)]
    unequal = len(differ)
    same = torch.equal(graph_losses, eager_losses)
    diff = (graph_losses - eager_losses).abs().max().item()
    log(f"flash captured steps (S=512, dropout 0): 2 calls of {K} against {2 * K} eager "
        f"steps: losses {'bit-equal' if same else f'DIFFER by {diff:.3e}'}, "
        f"{len(tensors) - unequal} of {len(tensors)} state tensors bit-equal"
        + (f" (differ: {differ})" if differ else "") + f"; K7 / K8 "
        f"launches {graph_launches} (the warm-up's and one replay's: want {[6 * 2 * K] * 2})")
    if multi._graph is None or not same or unequal or graph_launches != [12 * K, 12 * K]:
        fail("flash: the captured steps differ from the eager ones")
    report["flash"]["train"] = {"trainer_steps_per_s": steps_per_s,
                                "grad_cosine": cos, "captured_bit_equal": True}
    del graph_st, eager_st, multi
    torch.cuda.empty_cache()


def ir_eval_by_part(enc, ir_set) -> dict:
    """One IR evaluation as the evaluator runs it, timed by part on the host
    clock (synchronised): tokenizing every query and document alone, the
    encode of queries and corpus (tokenization included) into an
    ExactIndex, the cos and dot searches at k = 100 and the metrics."""
    import torch

    from qst_tpu_torch.evals import ir_metrics
    from qst_tpu_torch.retrieval.index import ExactIndex

    qids = [q for q in ir_set.queries if ir_set.relevant.get(q)]
    queries, cids = [ir_set.queries[q] for q in qids], list(ir_set.corpus)
    corpus = [ir_set.corpus[c] for c in cids]
    rel = [ir_set.relevant[q] for q in qids]
    enc.encode(queries[:256], convert_to_numpy=False)          # warm
    out = {}
    t0 = time.perf_counter()
    for texts in (queries, corpus):
        for i in range(0, len(texts), 256):
            enc.tokenizer.batch_encode(texts[i:i + 256], max_length=enc.cfg.max_seq_length)
    out["tokenize_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_emb = enc.encode(queries, convert_to_numpy=False)
    index = ExactIndex(enc.encode(corpus, convert_to_numpy=False), ids=cids)
    torch.cuda.synchronize()
    out["encode_s"] = time.perf_counter() - t0
    out["search_s"] = out["metrics_s"] = 0.0
    for fn in ("cos_sim", "dot_score"):
        index.search_ids(q_emb, k=100, score=fn)                # warm
        t0 = time.perf_counter()
        _, ranked = index.search_ids(q_emb, k=100, score=fn)
        t1 = time.perf_counter()
        ir_metrics(ranked, rel, accuracy_at_k=(1, 3, 5, 10), precision_recall_at_k=(1, 3, 5, 10),
                   mrr_at_k=(10,), ndcg_at_k=(10,), map_at_k=(100,))
        out["search_s"] += t1 - t0
        out["metrics_s"] += time.perf_counter() - t1
    return out


def flash_times(report: dict, vocab: str, tmp: str) -> None:
    """K7 and K8 at B = 64, S = 512, 12 heads of 32 (bf16), on the
    ``flash_segments`` ids and with every row real, beside their plain
    versions, torch's scaled_dot_product_attention with the same segment
    mask (forward; backward alone, K8's yardstick; forward + backward) and
    their bounds (the full S² count either way); K7 at
    the encode batch (256 x 256 and 256 x 512); encode sentences/s at S = 256
    and 512, flash against the einsum nn.Module path in turns; tokenization
    docs/s at S = 512, native against Python; one IR evaluation by part
    with the Python and the native tokenizer, in turns."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.evals import create_ir_evaluation_set
    from qst_tpu_torch.data import ChunkStore
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params
    from qst_tpu_torch.models.tokenizer import WordPieceTokenizer, load_tokenizer
    from qst_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(40)
    B, nh, S, hd = 64, 12, 512, 32
    H, sc = nh * hd, hd ** -0.5
    q, k, v, do = (torch.randn((B, S, nh, hd), generator=gen).to(dev, torch.bfloat16)
                   .transpose(1, 2) for _ in range(4))
    seg = flash_segments(B, S, dev, gen)
    allowed = (seg[:, None, :, None] == seg[:, None, None, :])
    o, m, l = fa.flash_attention(q, k, v, seg, seg, sc, return_stats=True)
    r7, r8 = report["K7"], report["K8"]
    r7["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, seg, seg, sc), 20)
    r7["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, seg, seg, sc), 3)
    r7["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=allowed, scale=sc), 20)
    r8["ms"] = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, seg, seg, o, m, l, do, sc), 20)
    r8["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, seg, seg, o, m, l, do, sc), 3)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    # K8's yardstick: SDPA's backward alone, over a retained graph
    out = F.scaled_dot_product_attention(*leaves, attn_mask=allowed, scale=sc)
    r8["library_ms"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                               20)
    r8["library_call"] = "scaled_dot_product_attention backward (autograd.grad, retained graph)"
    del out
    r8["library_fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, attn_mask=allowed, scale=sc), leaves, do), 20)
    r8["k7_k8_autograd_ms"] = cuda_ms(lambda: torch.autograd.grad(fa.FlashAttention.apply(
        *leaves, seg, seg, sc), leaves, do), 20)
    # every row real: every tile one segment, so no tile's mask can hide in the times
    real = torch.ones_like(seg)
    o_r, m_r, l_r = fa.flash_attention(q, k, v, real, real, sc, return_stats=True)
    r7["all_real_ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, real, real, sc), 20)
    r8["all_real_ms"] = cuda_ms(lambda: fa.flash_attention_bwd(
        q, k, v, real, real, o_r, m_r, l_r, do, sc), 20)
    del o_r, m_r, l_r
    # bounds: K7 reads q, k, v and the ids, writes o and (m, l); two products
    # of S x S x hd a (sequence, head). K8 reads q, k, v, o, dO, (m, l) and
    # the ids, writes dq, dk, dv; five products (s again, dV, dP, dK, dQ)
    qkv_bytes, ids_bytes, stat_bytes = 3 * B * S * H * 2, 2 * B * S * 4, 2 * B * nh * S * 4
    r7.update(bound(qkv_bytes + ids_bytes + B * S * H * 2 + stat_bytes,
                    4.0 * B * nh * S * S * hd, "bfloat16"))
    r8.update(bound(qkv_bytes + 2 * B * S * H * 2 + stat_bytes + ids_bytes + 3 * B * S * H * 2,
                    10.0 * B * nh * S * S * hd, "bfloat16"))
    r7["shape"] = r8["shape"] = [B, nh, S, hd]
    log(f"K7 at (B={B}, 12 heads, S={S}, hd={hd}) bf16: {r7['ms']:.4f} ms (all rows real "
        f"{r7['all_real_ms']:.4f}; bound {r7['bound_ms']:.4f} ms by {r7['bound_by']}), plain "
        f"{r7['plain_ms']:.3f} ms, SDPA {r7['library_ms']:.4f} ms; K8 {r8['ms']:.4f} ms (all "
        f"rows real {r8['all_real_ms']:.4f}; bound {r8['bound_ms']:.4f} ms by "
        f"{r8['bound_by']}), plain {r8['plain_ms']:.3f} ms, SDPA backward alone "
        f"{r8['library_ms']:.4f} ms, SDPA forward + backward {r8['library_fwd_bwd_ms']:.4f} ms "
        f"against K7 + K8 through autograd {r8['k7_k8_autograd_ms']:.4f} ms")
    del q, k, v, do, o, m, l, leaves, allowed
    enc_shapes = {}
    for Se in (256, 512):
        qe, ke, ve = (torch.randn((256, Se, nh, hd), generator=gen).to(dev, torch.bfloat16)
                      .transpose(1, 2) for _ in range(3))
        sege = flash_segments(256, Se, dev, gen)
        ms = cuda_ms(lambda: fa.flash_attention(qe, ke, ve, sege, sege, sc), 10)
        bd = bound(4 * 256 * Se * H * 2 + 2 * 256 * Se * 4 + 2 * 256 * nh * Se * 4,
                   4.0 * 256 * nh * Se * Se * hd, "bfloat16")
        enc_shapes[f"256x{Se}"] = {"ms": ms, **bd}
    r7["encode_shapes"] = enc_shapes
    log(f"K7 at the encode batch: {enc_shapes}")
    torch.cuda.empty_cache()

    # encode sentences/s, B = 256: flash against the einsum nn.Module path,
    # in turns (flash, einsum, einsum, flash)
    cfg = EncoderConfig.minilm_l6(use_flash_attention=True, max_seq_length=512)
    tok = load_tokenizer(vocab, vocab_size=cfg.vocab_size)
    params = init_params(cfg, torch.Generator().manual_seed(41), device="cuda")
    enc = SentenceEncoder(cfg, params, tok, device="cuda")
    enc_off = SentenceEncoder(dataclasses.replace(cfg, use_flash_attention=False), params, tok,
                              device="cuda")
    rates = {}
    for Se in (256, 512):
        ids = torch.randint(5, cfg.vocab_size, (256, Se), generator=gen).to(dev)
        mask = flash_segments(256, Se, dev, gen).long()
        mask[2, 0] = 1                       # the encoder's pad-row rule: never all zero
        turns = {"flash": [], "einsum": []}
        for name in ("flash", "einsum", "einsum", "flash"):
            e = enc if name == "flash" else enc_off
            turns[name].append(cuda_ms(lambda: e.encode_ids(ids, mask), 5))
        rates[f"S={Se}"] = {n: 256e3 / min(t) for n, t in turns.items()}
    log(f"encode sentences/s at B=256 (flash against the einsum path, in turns): {rates}")
    report["flash"]["encode_sentences_per_s"] = rates
    del enc_off
    torch.cuda.empty_cache()
    embedding_forms(report, gen)

    # tokenization docs/s at S = 512: native against Python
    docs = flash_docs(2048, seed=42)
    py_tok = WordPieceTokenizer.from_vocab_file(vocab)
    tok_rates = {}
    for name, t, texts in (("native", tok, docs), ("python", py_tok, docs[:512]),
                           ("native ", tok, docs)):
        t0 = time.perf_counter()
        for i in range(0, len(texts), 256):
            t.batch_encode(texts[i:i + 256], max_length=512)
        tok_rates.setdefault(name.strip(), []).append(len(texts) / (time.perf_counter() - t0))
    tok_rates = {n: max(v) for n, v in tok_rates.items()}
    log(f"tokenization at S=512, 300-450 words a doc: native {tok_rates['native']:.0f} docs/s, "
        f"Python {tok_rates['python']:.0f} docs/s")
    report["flash"]["tokenize_docs_per_s"] = tok_rates

    # one IR evaluation by part, the Python and the native tokenizer in turns
    # (the evaluate phase's recipe: MiniLM-L6 through K1 at S = 128)
    root = f"{tmp}/flash_ir"
    write_quadruplet_chunks(root, 2800, seed=43)
    ir_set = create_ir_evaluation_set(list(ChunkStore(root).iter_instances()))
    ecfg = EncoderConfig.minilm_l6(use_fused_layer=True)
    eparams = init_params(ecfg, torch.Generator().manual_seed(44), device="cuda")
    parts = {"python": [], "native": []}
    for name in ("python", "native", "native", "python"):
        t = py_tok if name == "python" else tok
        parts[name].append(ir_eval_by_part(SentenceEncoder(ecfg, eparams, t, device="cuda"),
                                           ir_set))
    best = {n: min(runs, key=lambda r: r["encode_s"]) for n, runs in parts.items()}
    log(f"one IR evaluation ({len(ir_set.queries)} queries x {len(ir_set.corpus)} docs, "
        f"MiniLM-L6 through K1) by part, Python tokenizer: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in best["python"].items())
        + "; native: " + ", ".join(f"{k} {v:.3f} s" for k, v in best["native"].items()))
    report["flash"]["ir_eval_by_part"] = {"runs": parts, "n_queries": len(ir_set.queries),
                                          "n_docs": len(ir_set.corpus)}


def embedding_forms(report: dict, gen) -> None:
    """The nn.Module BERT embeddings' forward + backward (bf16, hidden
    dropout off) as they read positions and token types — one (1, S)
    position lookup and a selection among the type rows, so the backward
    is reproducible — against the F.embedding lookups of (B, S) ids they
    replaced, in turns, at the nn.Module train step's rows (128 x 128) and
    the flash train step's (32 x 512)."""
    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.bert import BertEmbeddings, _layer_norm_f32

    dev = torch.device("cuda")
    emb = BertEmbeddings(EncoderConfig.minilm_l6()).to(dev)

    def lookups(ids, types, pos):
        dt = torch.bfloat16
        x = (emb.word_embeddings(ids).to(dt) + emb.position_embeddings(pos).to(dt)
             + emb.token_type_embeddings(types).to(dt))
        return _layer_norm_f32(emb.LayerNorm, x).to(dt)

    out = {}
    for B, S in ((128, 128), (32, 512)):
        ids = torch.randint(5, 30522, (B, S), generator=gen).to(dev)
        types = torch.zeros_like(ids)
        types[:, S // 2:] = 1
        pos = torch.arange(S, device=dev)[None, :]
        g = torch.randn((B, S, 384), generator=gen).to(dev, torch.bfloat16)
        forms = {"selection": lambda: emb(ids, types, pos).backward(g),
                 "lookup": lambda: lookups(ids, types, pos.expand(B, S)).backward(g)}
        turns = {"selection": [], "lookup": []}
        for name in ("selection", "lookup", "lookup", "selection"):
            turns[name].append(cuda_ms(forms[name], 20, 3))
        out[f"{B}x{S}"] = {n: min(t) for n, t in turns.items()}
    log("BERT embeddings forward + backward (ms, in turns): selection form (the nn.Module "
        "path's) against the F.embedding lookups it replaced: " + "; ".join(
            f"{k} {v['selection']:.4f} / {v['lookup']:.4f}" for k, v in out.items()))
    report["flash"]["embedding_forms_ms"] = out


def flash(report: dict) -> None:
    """The long-document path: K7/K8 against their plain versions, encode +
    search and train through them behind the native tokenizer, times."""
    import tempfile

    import torch

    from qst_tpu_torch.kernels import build

    report["flash"] = {}
    # the bf16 kernels' resources as ptxas reported them in the build
    res = {}
    for name, line in build.resource_report("flash_").items():
        m = re.search(r"(flash_\w+?_kernel)ILi(\d+)E", name)
        if m and ("wgmma" in m.group(1) or "prep" in m.group(1)):
            res[f"{m.group(1)}<{m.group(2)}>"] = line
    log("K7/K8 kernels, ptxas -v: " + "; ".join(f"{n}: {v}" for n, v in sorted(res.items())))
    if len(res) != 9:
        fail(f"ptxas reported {len(res)} of K7/K8's 9 bf16 kernels")
    report["flash"]["ptxas"] = res
    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        vocab = f"{tmp}/vocab.txt"
        with open(vocab, "w") as f:
            f.write("\n".join(checkpoint_vocab(30522)) + "\n")
        for name, fn in (("kernels", lambda: check_flash_kernels(report)),
                         ("encode_search", lambda: flash_encode_search(report, vocab)),
                         ("train", lambda: flash_train(report, vocab, tmp)),
                         ("times", lambda: flash_times(report, vocab, tmp))):
            t0 = time.perf_counter()
            fn()
            parts[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    report["flash"]["part_s"] = parts
    log("flash phase by part (s): " + ", ".join(f"{n} {v:.1f}" for n, v in parts.items()))


# ------------------------------------------------------------------ roberta
ROBERTA_DOCS = 65536        # the reranked Retriever's corpus
ROBERTA_QUERIES = 32
ROBERTA_PAIRS = 1024        # pairs each predict form scores (8 batches of 128)
ROBERTA_IR_INSTANCES = 68   # 16 queries; 52 references + 3 x 68 positives = 256 docs
ROBERTA_IR_QUERIES = 16
ROBERTA_IR_DOCS = ROBERTA_IR_INSTANCES - ROBERTA_IR_QUERIES + 3 * ROBERTA_IR_INSTANCES
ROBERTA_MERGES = 2000
ROBERTA_SPECIAL = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]


def pseudo_words(n: int, seed: int) -> list:
    """n distinct lower-case words of one to three consonant-vowel
    syllables: text a byte-level BPE and a WordPiece vocabulary can both
    learn, unlike the w0 .. w4999 ids of the other phases."""
    rng = np.random.default_rng(seed)
    cons = list("bcdfghjklmnprstvwz") + ["ch", "sh", "th", "st", "tr", "br"]
    vows = ["a", "e", "i", "o", "u", "ea", "ou", "ai"]
    out = set()
    while len(out) < n:
        syl = "".join(cons[int(rng.integers(len(cons)))] + vows[int(rng.integers(len(vows)))]
                      for _ in range(int(rng.integers(1, 4))))
        out.add(syl + (cons[int(rng.integers(len(cons)))] if rng.random() < 0.5 else ""))
    return sorted(out)


def pseudo_texts(words: list, n: int, seed: int, lo: int = 300, hi: int = 450) -> list:
    """n sentences of lo-hi characters drawn from ``words``, capitalised and
    ended with a full stop, with a comma now and then."""
    rng = np.random.default_rng(seed)
    per = hi // 3
    picks = rng.integers(0, len(words), (n, per)).tolist()
    lens = rng.integers(lo, hi + 1, n).tolist()
    out = []
    for row, L in zip(picks, lens):
        text = " ".join([words[j] for j in row])[:L].rsplit(" ", 1)[0]
        cut = text.find(" ", len(text) // 2)
        if cut > 0:
            text = text[:cut] + "," + text[cut:]
        out.append(text[:1].upper() + text[1:] + ".")
    return out


def learn_bpe(texts: list, n_merges: int) -> list:
    """The ``n_merges`` most frequent adjacent-symbol merges of the GPT-2
    pre-tokenized byte symbols of ``texts``, greedily, as a BPE vocabulary
    is learned (each merge recounts only the words that held the pair)."""
    import collections

    from qst_tpu_torch.models.bpe_tokenizer import bytes_to_unicode, pretokenize_pattern

    bm, pat = bytes_to_unicode(), pretokenize_pattern()
    counted = collections.Counter(tuple(bm[b] for b in piece.encode("utf-8"))
                                  for t in texts for piece in pat.findall(t))
    words = [[list(w), c] for w, c in counted.items()]
    pairs, where = collections.Counter(), collections.defaultdict(set)
    for i, (w, c) in enumerate(words):
        for a, b in zip(w, w[1:]):
            pairs[a, b] += c
            where[a, b].add(i)
    merges = []
    for _ in range(n_merges):
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        for i in list(where[best]):
            w, c = words[i]
            for a, b in zip(w, w[1:]):
                pairs[a, b] -= c
                if pairs[a, b] <= 0:
                    del pairs[a, b]
            out, j = [], 0
            while j < len(w):
                if j + 1 < len(w) and (w[j], w[j + 1]) == best:
                    out.append(w[j] + w[j + 1])
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            words[i][0] = out
            for a, b in zip(out, out[1:]):
                pairs[a, b] += c
                where[a, b].add(i)
    return merges


def bpe_vocab(merges: list, size: int) -> dict:
    """A RoBERTa vocab.json of ``size`` entries: the specials at RoBERTa's
    ids (<s> 0, <pad> 1, </s> 2, <unk> 3), the 256 byte symbols, the merged
    tokens, and unused fillers up to the model's vocabulary size."""
    from qst_tpu_torch.models.bpe_tokenizer import bytes_to_unicode

    tokens = list(dict.fromkeys(ROBERTA_SPECIAL + list(bytes_to_unicode().values())
                                + [a + b for a, b in merges]))
    tokens += [f"<unused{i}>" for i in range(size - len(tokens))]
    return {t: i for i, t in enumerate(tokens)}


def wordpiece_list(words: list, size: int) -> list:
    return (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ","] + words
            + [f"t{i}" for i in range(size - len(words) - 7)])


def roberta_pairs(words: list, n: int, seed: int) -> list:
    return list(zip(pseudo_texts(words, n, seed), pseudo_texts(words, n, seed + 1)))


def k7_against_plain(what: str, q, k, v, seg) -> float:
    """K7 against its plain version on one view: f32 within 1e-4, bf16
    within K1's forward bars, the row statistics within 1e-4 relative
    (check_flash_kernels' bars). → max|err|."""
    import torch

    from qst_tpu_torch.ops import flash_attention as fa

    sc = q.shape[-1] ** -0.5
    o, m, l = fa.flash_attention(q, k, v, seg, seg, sc, return_stats=True)
    o_p, m_p, l_p = fa.flash_attention_plain(q, k, v, seg, seg, sc, return_stats=True)
    torch.cuda.synchronize()
    stats = max(((m - m_p).abs() / (1 + m_p.abs())).max().item(),
                ((l - l_p).abs() / l_p).max().item())
    diff = (o.float() - o_p.float()).abs()
    err = diff.max().item()
    if stats > 1e-4:
        fail(f"{what}: row statistics {stats:.3e} from the plain version's")
    if q.dtype == torch.float32:
        if err > 1e-4:
            fail(f"{what}: K7 max|err| {err:.3e} (limit 1e-4)")
    else:
        ulps = (diff / (bf16_ulp(o_p.float()) + 2.0 ** -7)).max().item()
        mean_rel = (diff.mean() / o_p.float().abs().mean()).item()
        if not (err <= 2e-2 * o_p.float().abs().max().item() and ulps <= 2.0
                and mean_rel <= 2.0 ** -10):
            fail(f"{what}: K7 outside K1's bf16 bars: max|err| {err:.3e}, worst element "
                 f"{ulps:.2f} x (ulp + 2^-7), mean rel {mean_rel:.3e}")
    return err


def roberta_segments(tok, pairs: list, S: int, dev):
    """The (B, S) int32 attention mask of a predict batch of ``pairs``,
    padded as predict pads its last chunk (pad rows keep their first
    token) — K7's segment ids in the cross-encoder."""
    import torch

    _, mask, _ = tok.batch_encode_pairs(pairs, max_length=S)
    mask[:, 0] = 1
    return torch.from_numpy(mask).to(dev, torch.int32)


def roberta_cross_encoder_dir(tmp: str, words: list) -> dict:
    """A random RoBERTa-large cross-encoder (seeded) written as an HF
    RobertaForSequenceClassification directory with a BPE vocabulary learned
    from seeded text, and loaded back through load_cross_encoder_dir and
    load_tokenizer on the card. The head's bias is set so that the median
    f32 score of 256 pairs is the relevance threshold 0.4 (a random trunk
    scores every pair alike; this splits them)."""
    import dataclasses

    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.bpe_tokenizer import RobertaBPETokenizer
    from qst_tpu_torch.models.cross_encoder import CrossEncoder, init_cross_encoder
    from qst_tpu_torch.models.hf_export import save_cross_encoder_dir
    from qst_tpu_torch.models.hf_import import load_cross_encoder_dir
    from qst_tpu_torch.models.tokenizer import load_tokenizer

    t0 = time.perf_counter()
    cfg = EncoderConfig.roberta_large()
    merges = learn_bpe(pseudo_texts(words, 512, seed=61), ROBERTA_MERGES)
    vocab = bpe_vocab(merges, cfg.vocab_size)
    learn_s = time.perf_counter() - t0
    sd = init_cross_encoder(cfg, torch.Generator().manual_seed(62), device="cuda")
    ce32 = CrossEncoder(dataclasses.replace(cfg, dtype="float32"), sd,
                        RobertaBPETokenizer(vocab, merges), device="cuda")
    s = ce32.predict(roberta_pairs(words, 256, seed=63)).astype(np.float64)
    logits = np.log(s / (1 - s))
    sd["classifier.out_proj.bias"] += float(np.log(0.4 / 0.6) - np.median(logits))
    del ce32
    t1 = time.perf_counter()
    d = save_cross_encoder_dir({k: v.cpu() for k, v in sd.items()}, cfg, f"{tmp}/stsb_roberta",
                               vocab=vocab, merges=merges)
    write_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    cfg_l, sd_l, vocab_path = load_cross_encoder_dir(d)
    tok = load_tokenizer(vocab_path, vocab_size=cfg_l.vocab_size)
    load_s = time.perf_counter() - t1
    want = ("roberta", 1024, 24, 16, 4096, 50265, 1, 1e-5, 1, 514, 128)
    got = (cfg_l.arch, cfg_l.hidden_size, cfg_l.num_layers, cfg_l.num_heads,
           cfg_l.intermediate_size, cfg_l.vocab_size, cfg_l.type_vocab_size, cfg_l.layer_norm_eps,
           cfg_l.pad_token_id, cfg_l.max_position_embeddings, cfg_l.max_seq_length)
    if got != want or not isinstance(tok, RobertaBPETokenizer):
        fail(f"RoBERTa-large directory: config {got} (want {want}), tokenizer {type(tok)}")
    if sd_l.keys() != sd.keys() or not all(torch.equal(sd_l[k], sd[k].cpu()) for k in sd):
        fail("RoBERTa-large directory: the loaded weights are not the written ones")
    n_params = sum(v.numel() for v in sd_l.values())
    log(f"RoBERTa-large cross-encoder directory: {n_params / 1e6:.1f} M parameters, "
        f"{len(merges)} BPE merges learned in {learn_s:.1f} s, written in {write_s:.1f} s, "
        f"loaded (load_cross_encoder_dir + load_tokenizer) in {load_s:.1f} s; init head's "
        f"logits over 256 pairs: mean {logits.mean():.4f}, std {logits.std():.4f}")
    del sd
    return {"dir": d, "cfg": cfg_l, "sd": {k: v.to("cuda") for k, v in sd_l.items()},
            "tok": tok, "vocab": vocab, "merges": merges, "logit_std": float(logits.std())}


def roberta_predict(report: dict, ce: dict, words: list) -> dict:
    """CrossEncoder.predict at batch 128, S = 128 over 1,024 pairs of
    300-450-character texts in three forms: (a) bf16 einsum attention, (b)
    bf16 with use_flash_attention (K7, 24 launches a batch), (c) f32. (a)
    and (b) within 1e-2 of (c) on the sigmoid scores and on the same side of
    the threshold 0.4 where (c) is 1e-2 or more from it; (c) within 1e-4 of
    the CPU plain path on 8 pairs."""
    import dataclasses

    import torch

    from qst_tpu_torch.models.cross_encoder import CrossEncoder

    k7, _ = flash_counters()
    cfg, sd, tok = ce["cfg"], ce["sd"], ce["tok"]
    pairs = roberta_pairs(words, ROBERTA_PAIRS, seed=64)
    forms = {"einsum": cfg, "flash": dataclasses.replace(cfg, use_flash_attention=True),
             "f32": dataclasses.replace(cfg, dtype="float32")}
    enc = tok.batch_encode_pairs(pairs[:128], max_length=128)
    ids, mask, types = (torch.from_numpy(a.astype(np.int64)).cuda() for a in enc)
    scores, out = {}, {}
    for name, c in forms.items():
        model = CrossEncoder(c, sd, tok, device="cuda")
        model.predict(pairs[:128])                       # warm-up
        k7.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores[name] = model.predict(pairs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k7.launches
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: model.model(ids, mask, types), 5)
        want = 24 * ROBERTA_PAIRS // 128 if name == "flash" else 0
        if launches != want:
            fail(f"RoBERTa-large predict ({name}): K7 launched {launches} times, want {want}")
        if name == "flash":
            report["K7"]["launches"] = report["K7"].get("launches", 0) + launches
        out[name] = {"pairs_per_s": ROBERTA_PAIRS / wall, "forward_ms_per_batch": fwd_ms,
                     "k7_launches": launches}
        del model
        torch.cuda.empty_cache()
    ref = scores["f32"]
    near = np.abs(ref - 0.4) < 1e-2
    for name in ("einsum", "flash"):
        err = float(np.abs(scores[name] - ref).max())
        flips = int(((scores[name] >= 0.4) != (ref >= 0.4))[~near].sum())
        out[name].update(max_abs_err_vs_f32=err, threshold_flips_away_from_ties=flips)
        if not (np.isfinite(scores[name]).all() and err <= 1e-2 and flips == 0):
            fail(f"RoBERTa-large predict ({name}): {err:.3e} from f32 (limit 1e-2), {flips} "
                 f"pairs on the other side of 0.4 away from near ties")
    cpu = CrossEncoder(forms["f32"], {k: v.cpu() for k, v in sd.items()}, tok, device="cpu")
    t0 = time.perf_counter()
    plain = cpu.predict(pairs[:8], batch_size=8)
    cpu_s = time.perf_counter() - t0
    cpu_err = float(np.abs(plain - ref[:8]).max())
    if cpu_err > 1e-4:
        fail(f"RoBERTa-large predict: f32 on the card {cpu_err:.3e} from the CPU (limit 1e-4)")
    del cpu
    log(f"RoBERTa-large CrossEncoder.predict, {ROBERTA_PAIRS} pairs at batch 128, S=128 "
        f"(tokenization included): einsum bf16 {out['einsum']['pairs_per_s']:.0f} pairs/s, flash "
        f"bf16 {out['flash']['pairs_per_s']:.0f} pairs/s, f32 {out['f32']['pairs_per_s']:.0f} "
        f"pairs/s; forward alone a batch {out['einsum']['forward_ms_per_batch']:.2f} / "
        f"{out['flash']['forward_ms_per_batch']:.2f} / {out['f32']['forward_ms_per_batch']:.2f} "
        f"ms; K7 launches (flash) {out['flash']['k7_launches']}; bf16 against f32: einsum "
        f"{out['einsum']['max_abs_err_vs_f32']:.3e}, flash {out['flash']['max_abs_err_vs_f32']:.3e}"
        f" (limit 1e-2; {int(near.sum())} of {len(ref)} pairs within 1e-2 of 0.4, "
        f"{int((ref >= 0.4).sum())} at or above it); f32 against the CPU on 8 pairs "
        f"{cpu_err:.3e} (limit 1e-4, {cpu_s:.1f} s on the host)")
    out["cpu_max_abs_err"] = cpu_err
    out["scores_f32"] = {"min": float(ref.min()), "max": float(ref.max()),
                         "at_or_above_0.4": int((ref >= 0.4).sum()), "near_0.4": int(near.sum())}
    return out


def roberta_k7(report: dict, ce: dict, words: list, times: bool) -> None:
    """K7 at the cross-encoder's own view: (B, S, 16, 64) activations of
    H = 1,024 seen as (128, 16, 128, 64), head stride 64, sequence stride
    1,024, one 128-key block a row, on a predict batch's masks. Before the
    rest of the phase: against its plain version in f32 and bf16. With
    ``times``: its time beside the plain version's,
    scaled_dot_product_attention's with the segment mask and its bound."""
    import torch
    import torch.nn.functional as F

    from qst_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(65)
    B, S, nh, hd = 128, 128, 16, 64
    seg = roberta_segments(ce["tok"], roberta_pairs(words, 120, seed=66), S, dev)
    seg = torch.cat([seg, torch.zeros((8, S), dtype=torch.int32, device=dev)])
    seg[120:, 0] = 1                                   # predict's pad rows
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((B, S, nh * hd), generator=gen).to(dev, dtype)
                   .reshape(B, S, nh, hd).transpose(1, 2) for _ in range(3))
        if q.stride() != (S * nh * hd, hd, nh * hd, 1):
            fail(f"K7 view strides {q.stride()}")
        name = str(dtype).split(".")[-1]
        errs[name] = k7_against_plain(f"K7 {name} at the cross-encoder's view {B, nh, S, hd}",
                                      q, k, v, seg)
    r = report["K7"].setdefault("roberta_shape", {"shape": [B, nh, S, hd]})
    r["max_abs_err"] = errs
    log(f"K7 at the RoBERTa-large cross-encoder's view (128, 16, 128, 64), strides "
        f"{tuple(q.stride())}, a predict batch's masks: max|err| against plain {errs}")
    if not times:
        return
    sc = hd ** -0.5
    allowed = seg[:, None, :, None] == seg[:, None, None, :]
    r["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, seg, seg, sc), 50)
    r["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, seg, seg, sc), 5)
    r["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=allowed, scale=sc), 50)
    r.update(bound(4 * B * S * nh * hd * 2 + 2 * B * S * 4 + 2 * B * nh * S * 4,
                   4.0 * B * nh * S * S * hd, "bfloat16"))
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    log(f"K7 at (128, 16, 128, 64) bf16: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"SDPA with the segment mask {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
        f"{r['bound_by']} ({100 * r['share_of_bound']:.1f}% of it)")


def roberta_rerank(report: dict, ce: dict, words: list, tmp: str) -> dict:
    """Retriever with the MiniLM-L6 bi-encoder (random, a WordPiece vocab of
    the phase's words, bf16 index, dot_score: K4 + K5) over 65,536 docs and
    reranker= the RoBERTa-large CrossEncoder: search(k=10, rerank_k=100)
    for 32 queries, each answer held to the first stage's 100 candidates
    scored directly by predict."""
    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.cross_encoder import CrossEncoder
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params
    from qst_tpu_torch.models.tokenizer import load_tokenizer
    from qst_tpu_torch.ops import topk
    from qst_tpu_torch.retrieval import Retriever

    vocab = f"{tmp}/wordpiece.txt"
    with open(vocab, "w") as f:
        f.write("\n".join(wordpiece_list(words, 30522)) + "\n")
    cfg = EncoderConfig.minilm_l6()
    enc = SentenceEncoder(cfg, init_params(cfg, torch.Generator().manual_seed(67), device="cuda"),
                          load_tokenizer(vocab, vocab_size=cfg.vocab_size), device="cuda")
    reranker = CrossEncoder(ce["cfg"], ce["sd"], ce["tok"], device="cuda")
    docs = pseudo_texts(words, ROBERTA_DOCS, seed=68)
    rng = np.random.default_rng(69)
    queries = [docs[int(i)][:int(rng.integers(60, 120))].rsplit(" ", 1)[0]
               for i in rng.integers(0, ROBERTA_DOCS, ROBERTA_QUERIES)]
    t0 = time.perf_counter()
    retr = Retriever(enc, score="dot_score", reranker=reranker,
                     index_dtype="bfloat16").build(docs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    retr.search(queries[:2], k=10, rerank_k=100)           # warm-up
    k7, _ = flash_counters()
    for c in (topk.bucket_maxima, topk.rescore_buckets, k7):
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = retr.search(queries, k=10, rerank_k=100)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K4": topk.bucket_maxima.launches, "K5": topk.rescore_buckets.launches,
                "K7": k7.launches}
    if launches["K4"] < 1 or launches["K5"] < 1 or launches["K7"]:
        fail(f"reranked search: launches {launches} (the first stage through K4 + K5, no K7)")
    for n in ("K4", "K5"):
        report[n]["launches"] = report[n].get("launches", 0) + launches[n]
    first = retr.search(queries, k=100)
    worst = 0.0
    for q, row, cand in zip(queries, rows, first):
        ids = [i for i, _ in cand]
        s = reranker.predict([(q, docs[i]) for i in ids])
        order = np.argsort(-s)[:10]
        want = [(ids[int(j)], float(s[int(j)])) for j in order]
        got_s, want_s = np.array([x[1] for x in row]), np.array([x[1] for x in want])
        worst = max(worst, float(np.abs(got_s - want_s).max()))
        if len(row) != 10 or worst > 1e-6:
            fail(f"reranked answer for {q[:30]!r}: scores {got_s} against predict's {want_s}")
        for (gi, gs), (wi, _) in zip(row, want):
            # an id may differ from predict's only where its score ties another's
            if gi != wi and np.sum(np.abs(s - gs) <= 1e-6) < 2:
                fail(f"reranked answer for {q[:30]!r}: {row} against predict's {want}")
    log(f"reranked Retriever (MiniLM-L6 first stage, bf16 index, dot_score, over "
        f"{ROBERTA_DOCS} docs built in {build_s:.1f} s; RoBERTa-large bf16 reranker): "
        f"{ROBERTA_QUERIES} queries at k=10, rerank_k=100 in {wall:.2f} s = "
        f"{1e3 * wall / ROBERTA_QUERIES:.1f} ms a query; launches {launches}; answers equal to "
        f"predict over the first stage's candidates (max score diff {worst:.1e})")
    del retr, reranker, enc
    torch.cuda.empty_cache()
    return {"ms_per_query": 1e3 * wall / ROBERTA_QUERIES, "build_s": build_s,
            "launches": launches}


def roberta_ir_eval(report: dict, ce: dict, words: list, tmp: str) -> dict:
    """``python -m qst_tpu_torch.cli.ir_eval_main --use_cross_encoder
    --cross_encoder_dir <dir>`` over 68 instances (16 queries x 256 docs,
    4,096 pairs labeled): the relevant sets are the positives and the docs
    whose captured scores reach 0.4, and the first four queries' scores are
    predict's on a CrossEncoder of the directory as the phase loaded it."""
    import torch

    from qst_tpu_torch.cli import ir_eval_main
    from qst_tpu_torch.data import write_chunk, write_meta
    from qst_tpu_torch.models import cross_encoder as mce

    root = f"{tmp}/roberta_ir"
    texts = pseudo_texts(words, 4 * ROBERTA_IR_INSTANCES, seed=70)
    insts = [{"id": i, "reference": texts[4 * i], "positive": texts[4 * i + 1:4 * i + 3],
              "part_positive": [texts[4 * i + 3]]} for i in range(ROBERTA_IR_INSTANCES)]
    for c in range(0, ROBERTA_IR_INSTANCES, 64):
        write_chunk(root, c // 64, insts[c:c + 64], dataset_name="synthetic-roberta")
    write_meta(root, -(-ROBERTA_IR_INSTANCES // 64))
    captured = []
    predict = mce.CrossEncoder.predict

    def timed(self, pairs, batch_size=128):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = predict(self, pairs, batch_size)
        captured.append((list(pairs), out, time.perf_counter() - t0))
        return out

    mce.CrossEncoder.predict = timed
    out_root = f"{tmp}/roberta_ir_out"
    t0 = time.perf_counter()
    try:
        rc = ir_eval_main.main(["--dataset_root", root, "--output_root", out_root,
                                "--use_cross_encoder", "--cross_encoder_dir", ce["dir"],
                                "--n_queries", str(ROBERTA_IR_QUERIES),
                                "--score_functions", "cos_sim",
                                "dot_score", *IR_GRID])
    finally:
        mce.CrossEncoder.predict = predict
    wall = time.perf_counter() - t0
    if rc != 0 or len(captured) != 1:
        fail(f"ir_eval_main --use_cross_encoder: rc {rc}, {len(captured)} predict calls")
    pairs, scores, label_s = captured[0]
    [out] = os.listdir(out_root)
    with open(f"{out_root}/{out}/ir_eval_set.json") as f:
        ir_set = json.load(f)
    qids, dids = list(ir_set["queries"]), list(ir_set["corpus"])
    n_pairs = ROBERTA_IR_QUERIES * ROBERTA_IR_DOCS
    if (len(qids), len(dids), len(pairs)) != (ROBERTA_IR_QUERIES, ROBERTA_IR_DOCS, n_pairs):
        fail(f"ir_eval_main: {len(qids)} queries x {len(dids)} docs, {len(pairs)} pairs")
    grid = scores.reshape(len(qids), len(dids))
    for qi, q in enumerate(qids):
        iid = q[1:]
        own = {f"pos{iid}_0", f"pos{iid}_1", f"part{iid}_0"}
        want = own | {dids[j] for j in np.nonzero(grid[qi] >= 0.4)[0]}
        if set(ir_set["relevant"][q]) != want:
            fail(f"ir_eval_main: relevant set of {q} is not the threshold of its scores")
    direct = mce.CrossEncoder(ce["cfg"], ce["sd"], ce["tok"], device="cuda").predict(pairs[:2048])
    err = float(np.abs(direct - scores[:2048]).max())
    if err > 1e-6:
        fail(f"ir_eval_main: the labeling's scores are {err:.3e} from a direct predict")
    labeled = int((grid >= 0.4).sum())
    log(f"ir_eval_main --use_cross_encoder --cross_encoder_dir (RoBERTa-large, bf16): "
        f"{ROBERTA_IR_QUERIES} queries x {ROBERTA_IR_DOCS} docs = {n_pairs} pairs labeled in "
        f"{label_s:.1f} s ({n_pairs / label_s:.0f} pairs/s, "
        f"BPE tokenization included), {labeled} pairs at or above 0.4; the whole CLI (baseline "
        f"MiniLM-L6 evaluation included) {wall:.1f} s; relevant sets equal the thresholded "
        f"scores, the first 2,048 scores {err:.1e} from a direct predict")
    return {"label_s": label_s, "pairs_per_s": n_pairs / label_s, "cli_s": wall,
            "labeled": labeled}


def roberta_bi_encoder(report: dict, ce: dict, words: list, tmp: str) -> dict:
    """A RoBERTa bi-encoder directory at all-distilroberta-v1's published
    width (H 768, 6 layers, 12 heads, FFN 3,072, vocab 50,265, pad 1, mean
    pooling) written by the port's exporter and loaded by
    load_hf_checkpoint_dir: bf16 encode at S = 128 held to f32 (cosine >=
    0.999 a row); two Trainer steps with use_flash_attention at S = 256
    (K7 and K8 six times a step); the first step's gradients, flash against
    the einsum path, at dropout 0 (cosine >= 0.999)."""
    import dataclasses

    import torch

    from qst_tpu_torch.core.config import EncoderConfig, LossConfig, TrainConfig
    from qst_tpu_torch.data import (QuadrupletCollator, QuadrupletDataset, write_chunk,
                                    write_meta)
    from qst_tpu_torch.models.hf_export import save_checkpoint_dir
    from qst_tpu_torch.models.hf_import import load_hf_checkpoint_dir
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params
    from qst_tpu_torch.models.tokenizer import load_tokenizer
    from qst_tpu_torch.train import Trainer, create_train_state
    from qst_tpu_torch.train.train_step import encoder_apply_fn, loss_from_config

    dev = torch.device("cuda")
    width = EncoderConfig(name="all-distilroberta-v1", arch="roberta", vocab_size=50265,
                          hidden_size=768, num_layers=6, num_heads=12, intermediate_size=3072,
                          max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
                          pad_token_id=1, max_seq_length=128)
    sd0 = init_params(width, torch.Generator().manual_seed(71), device="cpu")
    d = save_checkpoint_dir(sd0, width, f"{tmp}/distilroberta", vocab=ce["vocab"],
                            merges=ce["merges"])
    cfg, sd, vocab = load_hf_checkpoint_dir(d)
    if (cfg.arch, cfg.hidden_size, cfg.num_layers, cfg.pooling, cfg.max_seq_length) != (
            "roberta", 768, 6, "mean", 128):
        fail(f"distilroberta directory: config {cfg}")
    tok = load_tokenizer(vocab)
    texts = pseudo_texts(words, 64, seed=72)
    e16 = SentenceEncoder(cfg, sd, tok, device="cuda").encode(texts)
    e32 = SentenceEncoder(dataclasses.replace(cfg, dtype="float32"), sd, tok,
                          device="cuda").encode(texts)
    cos = float((e16 * e32).sum(1).min())              # unit-norm rows
    if not (np.isfinite(e16).all() and cos >= 0.999):
        fail(f"distilroberta bf16 encode against f32: worst row cosine {cos:.6f}")

    root = f"{tmp}/roberta_train"
    long = pseudo_texts(words, 16 * 6, seed=73, lo=900, hi=1200)
    insts = [{"id": i, "reference": long[6 * i], "positive": long[6 * i + 1:6 * i + 4],
              "part_positive": long[6 * i + 4:6 * i + 6]} for i in range(16)]
    write_chunk(root, 0, insts, dataset_name="synthetic-roberta-long")
    write_meta(root, 1)
    enc_cfg = dataclasses.replace(cfg, use_flash_attention=True, max_seq_length=256,
                                  attention_dropout=0.0)
    loss_cfg = LossConfig(kind="gamma", use_fused_kernel=True)
    base = TrainConfig(batch_size=8)
    ds = QuadrupletDataset(root, seed=74)
    collator = QuadrupletCollator(tok, max_length=256)
    tcfg = dataclasses.replace(base, epochs=1, evaluation_steps=1, checkpoint_save_steps=0,
                               save_best_model=False, experiment_dir=f"{tmp}/roberta_exp")
    trainer = Trainer(enc_cfg, loss_cfg, tcfg, ds, collator, initial_params=sd, device=dev)
    k7, k8 = flash_counters()
    k7.launches = k8.launches = 0
    t0 = time.perf_counter()
    result = trainer.train()
    wall = time.perf_counter() - t0
    launches = [k7.launches, k8.launches]
    steps = result.state.step
    if steps != 2 or launches != [12, 12]:
        fail(f"distilroberta flash Trainer: {steps} steps, K7 / K8 launched {launches} "
             f"(want 2 steps, 6 each a step)")
    report["K7"]["launches"] = report["K7"].get("launches", 0) + launches[0]
    report["K8"]["launches"] = report["K8"].get("launches", 0) + launches[1]
    batch = collator(ds.sample_batch(range(8), step=0))
    full = int(batch.attention_mask.sum(-1).max())
    del trainer, result

    cfg0 = dataclasses.replace(enc_cfg, hidden_dropout=0.0)
    ids = torch.from_numpy(batch.input_ids.reshape(32, -1).astype(np.int64)).to(dev)
    mask = torch.from_numpy(batch.attention_mask.reshape(32, -1).astype(np.int64)).to(dev)
    grads = []
    for flash in (True, False):
        c = dataclasses.replace(cfg0, use_flash_attention=flash)
        state, _ = create_train_state(c, base, torch.Generator().manual_seed(75), 10, loss_cfg,
                                      initial_params=sd, device=dev)
        emb = encoder_apply_fn(c)(state.model, ids, mask, None).reshape(4, 8, -1)
        loss_from_config(loss_cfg)(*emb.unbind(0)).backward()
        grads.append(torch.cat([p.grad.flatten() for p in state.model.parameters()]))
        del state
    gcos = torch.nn.functional.cosine_similarity(grads[0], grads[1], dim=0).item()
    if not gcos >= 0.999:
        fail(f"distilroberta: flash gradients against the einsum path's: cosine {gcos:.6f}")
    log(f"all-distilroberta-v1-width directory (RoBERTa, H 768, 6 layers, vocab 50,265): "
        f"bf16 encode at S=128 against f32, worst row cosine {cos:.6f} (limit 0.999); "
        f"Trainer with use_flash_attention at S=256 (longest row {full} tokens): {steps} steps "
        f"in {wall:.1f} s, K7 / K8 launches {launches}; first step's gradients, flash against "
        f"einsum: cosine {gcos:.6f} (limit 0.999)")
    del grads
    torch.cuda.empty_cache()
    return {"encode_cosine": cos, "train_s": wall, "grad_cosine": gcos}


def roberta_mlm(report: dict, words: list, tmp: str) -> dict:
    """MLMAugmenter (substitute and insert) at MiniLM-L6 width (vocab
    30,522, S = 128, bf16) over 1,024 captions in chunks of 256: texts/s;
    the mask-slot logits held to the f32 head's (within 2e-2 of their
    largest magnitude, cosine >= 0.999 a row) and, in f32, to the rows of
    mlm_logits_fn's full (B, S, V) logits (1e-4)."""
    import dataclasses

    import torch

    from qst_tpu_torch.augment import MLMAugmenter
    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.mlm import init_mlm_params, mlm_logits_fn
    from qst_tpu_torch.models.tokenizer import WordPieceTokenizer

    cfg = EncoderConfig.minilm_l6()
    vocab = wordpiece_list(words, cfg.vocab_size)
    tok = WordPieceTokenizer({w: i for i, w in enumerate(vocab)})
    params = init_mlm_params(cfg, torch.Generator().manual_seed(76), device="cuda")
    caps = pseudo_texts(words, 1024, seed=77, lo=40, hi=90)
    rates, changed = {}, {}
    for action in ("substitute", "insert"):
        aug = MLMAugmenter(cfg, params, tok, action=action, seed=78)
        aug.augment(caps[:256])                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [t for i in range(0, len(caps), 256) for t in aug.augment(caps[i:i + 256])]
        torch.cuda.synchronize()
        rates[action] = len(caps) / (time.perf_counter() - t0)
        changed[action] = sum(a != b for a, b in zip(out, caps))
        if len(out) != len(caps) or changed[action] < len(caps) // 2:
            fail(f"MLMAugmenter {action}: {len(out)} texts, {changed[action]} changed")
    ids, mask = tok.batch_encode(caps[:64], max_length=cfg.max_seq_length)
    rng = np.random.default_rng(79)
    lens = mask.sum(1)
    rows = np.repeat(np.arange(64), 2)
    slots = np.array([int(rng.integers(1, n - 1)) for n in np.repeat(lens, 2)])
    ids[rows, slots] = tok.mask_id
    got = aug._slot_logits(ids, mask, rows, slots)
    aug32 = MLMAugmenter(dataclasses.replace(cfg, dtype="float32"), params, tok)
    ref = aug32._slot_logits(ids, mask, rows, slots)
    full = mlm_logits_fn(dataclasses.replace(cfg, dtype="float32"))(params, ids, mask)
    full_err = float(np.abs(full[torch.from_numpy(rows), torch.from_numpy(slots)].cpu().numpy()
                            - ref).max())
    err = float(np.abs(got - ref).max())
    cos = float(((got * ref).sum(1) / (np.linalg.norm(got, axis=1)
                                       * np.linalg.norm(ref, axis=1))).min())
    if not (err <= 2e-2 * np.abs(ref).max() and cos >= 0.999 and full_err <= 1e-4):
        fail(f"MLM logits: bf16 {err:.3e} from f32 (max |ref| {np.abs(ref).max():.3f}), row "
             f"cosine {cos:.6f}; f32 slot rows {full_err:.3e} from the full logits")
    log(f"MLMAugmenter at MiniLM-L6 width (vocab 30,522, S=128, bf16), 1,024 captions in chunks "
        f"of 256: substitute {rates['substitute']:.0f} texts/s, insert {rates['insert']:.0f} "
        f"texts/s ({changed}); mask-slot logits bf16 against f32 max|err| {err:.3e} (max |ref| "
        f"{np.abs(ref).max():.3f}), worst row cosine {cos:.6f}; f32 slot rows against the full "
        f"(B, S, V) logits {full_err:.1e}")
    return {"texts_per_s": rates, "logits_max_abs_err": err, "logits_cosine": cos}


def roberta(report: dict) -> None:
    """RoBERTa, byte-level BPE, the cross-encoder and the MLM head: K7 at
    the cross-encoder's view first, then the RoBERTa-large directory,
    predict in three forms, K7's times, reranking, ir_eval_main's labeling,
    the distilroberta-width bi-encoder and the MLM augmenter."""
    import tempfile

    import torch

    report["roberta"] = {}
    words = pseudo_words(3000, seed=60)
    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ce = roberta_cross_encoder_dir(tmp, words)
        parts["directory"] = time.perf_counter() - t0
        steps = (("k7_check", lambda: roberta_k7(report, ce, words, times=False)),
                 ("predict", lambda: roberta_predict(report, ce, words)),
                 ("k7_times", lambda: roberta_k7(report, ce, words, times=True)),
                 ("rerank", lambda: roberta_rerank(report, ce, words, tmp)),
                 ("ir_eval", lambda: roberta_ir_eval(report, ce, words, tmp)),
                 ("bi_encoder", lambda: roberta_bi_encoder(report, ce, words, tmp)),
                 ("mlm", lambda: roberta_mlm(report, words, tmp)))
        for name, fn in steps:
            t0 = time.perf_counter()
            got = fn()
            if got is not None:
                report["roberta"][name] = got
            parts[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        del ce
    torch.cuda.empty_cache()
    report["roberta"]["part_s"] = parts
    log("roberta phase by part (s): " + ", ".join(f"{n} {v:.1f}" for n, v in parts.items()))


# ---------------------------------------------------------------- marian
MARIAN_PAIRS = 64          # teacher-forced pairs, card against CPU
MARIAN_GEN_ROWS = 8        # rows through the uncached decoders too
MARIAN_CPU_ROWS = 8        # rows beam-searched on the CPU as well
MARIAN_CAPTIONS = 128      # the roundtrip's captions (4 batches of 32)
MARIAN_IMAGES = 8          # dataset_main's images with Marian part-positives (~2 s each:
                           # the whole run's time limit)
MARIAN_TOL = 1e-4          # relative to the largest magnitude / the best score


class HashWordTok:
    """A word-level tokenizer with the HF Marian surface (``__call__`` →
    input_ids / attention_mask, ``batch_decode``), on the pattern of
    tests/test_marian_backend.py's WordTok over the full vocabulary: the
    language prefix is id 2, ``tok<N>`` is id N, any other word an id by a
    fixed hash (never EOS or PAD); EOS appended, right-padded. It decodes an
    id to ``tok<N>``, so the fr→en hop reads what the en→fr hop wrote."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.special = (cfg.pad_token_id, cfg.eos_token_id)

    def _id(self, word: str) -> int:
        import zlib

        if word.startswith(">>"):
            return 2
        if word.startswith("tok") and word[3:].isdigit() and int(word[3:]) < self.cfg.vocab_size:
            return int(word[3:])
        return 1 + zlib.crc32(word.encode()) % (self.cfg.vocab_size - 2)

    def __call__(self, texts, padding=True, truncation=True, max_length=128,
                 return_tensors="np"):
        rows = [[self._id(w) for w in t.split()][: max_length - 1] + [self.cfg.eos_token_id]
                for t in texts]
        width = max(map(len, rows))
        ids = np.full((len(rows), width), self.cfg.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)], mask[i, :len(r)] = r, 1
        return {"input_ids": ids, "attention_mask": mask}

    def batch_decode(self, ids, skip_special_tokens=True):
        return [" ".join(f"tok{int(t)}" for t in row if int(t) not in self.special)
                for row in np.asarray(ids)]


def marian_captions(n: int, seed: int) -> list:
    """n captions of 8-24 pseudo-English words."""
    words = pseudo_words(3000, seed)
    rng = np.random.default_rng(seed)
    return [" ".join(words[int(i)] for i in rng.integers(0, len(words), int(rng.integers(8, 25))))
            for _ in range(n)]


def marian_dirs(report: dict, tmp: str) -> dict:
    """The en→fr and fr→en directories at Seq2SeqConfig()'s width (the
    published opus-mt one) with the published generation settings, written
    from two seeds through save_marian_dir; loaded through load_marian_dir
    and moved to the card, each parameter bit-equal to the written one."""
    import torch

    from qst_tpu_torch.models.hf_export import save_marian_dir
    from qst_tpu_torch.models.hf_import import load_marian_dir
    from qst_tpu_torch.models.seq2seq import Seq2SeqConfig, init_seq2seq

    cfg = Seq2SeqConfig()
    gen = {"num_beams": 4, "max_length": 512, "bad_words_ids": [[cfg.pad_token_id]],
           "forced_eos_token_id": 0}
    out = {"cfg": cfg}
    for name, seed in (("opus-mt-en-fr", 140), ("opus-mt-fr-en", 141)):
        written = init_seq2seq(cfg, torch.Generator().manual_seed(seed), device="cpu")
        path = save_marian_dir(written, cfg, os.path.join(tmp, name), generation=gen)
        got_cfg, sd, got_gen = load_marian_dir(path)
        params = {k: v.cuda() for k, v in sd.items()}
        bad = [k for k in written if not torch.equal(params[k].cpu(), written[k])]
        if got_cfg != cfg or bad or set(params) != set(written) or (
                got_gen["num_beams"], got_gen["max_length"], got_gen["suppress_tokens"],
                got_gen["forced_eos"]) != (4, 512, (cfg.pad_token_id,), 0):
            fail(f"{name}: load_marian_dir read back {got_cfg}, {got_gen}; {len(bad)} "
                 f"parameters differ from the written ones ({bad[:3]})")
        out[name] = {"path": path, "cpu": sd, "cuda": params, "gen": got_gen}
    n = sum(v.numel() for k, v in sd.items() if "embed_positions" not in k)
    log(f"marian: two directories at d_model {cfg.d_model}, {cfg.encoder_layers} + "
        f"{cfg.decoder_layers} layers, {cfg.num_heads} heads, FFN {cfg.ffn_dim}, vocab "
        f"{cfg.vocab_size}: {n / 1e6:.1f} M parameters each, read back bit for bit; "
        f"generation {got_gen}")
    report["marian"]["parameters"] = n
    return out


def marian_scores(model, ids, mask, seqs, cfg, length_penalty: float):
    """Each generated sequence's score as beam_decode ranks it, by teacher
    forcing: the processed log-probs (log_softmax, the suppress bias, the
    forced EOS at the last slot) of its tokens up to its first EOS, summed,
    over (1 + their count) ** length_penalty."""
    import torch

    from qst_tpu_torch.models.seq2seq import _forced_eos_mask, _suppress_bias

    with torch.no_grad():
        dec, tgt = seqs[:, :-1], seqs[:, 1:]
        hidden = model._decode_hidden(dec, torch.ones_like(dec), model.encode(ids, mask), mask)
        sup = _suppress_bias(cfg.vocab_size, (cfg.pad_token_id,), seqs.device)
        logp = torch.log_softmax(model._logits(hidden), dim=-1) + sup
        last = seqs.shape[1] - 2
        logp[:, last] = _forced_eos_mask(logp[:, last], last, seqs.shape[1], 0)
        tok = logp.gather(-1, tgt[..., None])[..., 0]
        eos = (tgt == cfg.eos_token_id).long()
        live = (eos.cumsum(1) - eos) == 0
        return (tok * live).sum(1) / (1.0 + live.sum(1)).pow(length_penalty)


def marian_parity(report: dict, dirs: dict, tok, caps: list) -> None:
    """Teacher forcing at full width: encode + full-prefix decode logits on
    the card against the same code on the CPU, and decode_token step by step
    against the full decode on the card (f32, 1e-4 of the largest
    magnitude); the next-token logits' spread."""
    import torch

    from qst_tpu_torch.augment.backtranslation import format_batch_texts
    from qst_tpu_torch.models.seq2seq import marian_module

    cfg, d = dirs["cfg"], dirs["opus-mt-en-fr"]
    src = tok(format_batch_texts(caps[:MARIAN_PAIRS]))
    tgt = tok(caps[MARIAN_PAIRS:2 * MARIAN_PAIRS])
    n = len(caps[:MARIAN_PAIRS])
    start = np.full((n, 1), cfg.decoder_start_token_id)
    dec = np.concatenate([start, tgt["input_ids"][:, :-1]], 1)
    dmask = np.concatenate([np.ones((n, 1), np.int64), tgt["attention_mask"][:, :-1]], 1)
    args = [torch.from_numpy(a) for a in (src["input_ids"], src["attention_mask"], dec, dmask)]
    card, cpu = marian_module(cfg, d["cuda"]), marian_module(cfg, d["cpu"])
    with torch.no_grad():
        got = card(*(a.cuda() for a in args))
        ref = cpu(*args)
        real = torch.from_numpy(dmask).bool()
        err = float((got.cpu() - ref)[real].abs().max())
        top = float(ref[real].abs().max())
        enc = card.encode(args[0].cuda(), args[1].cuda())
        caches = card.init_decode_cache(enc, dec.shape[1])
        step_err = 0.0
        for t in range(dec.shape[1]):
            logits, caches = card.decode_token(args[2][:, t:t + 1].cuda(), t, args[1].cuda(),
                                               caches)
            rows = real[:, t].cuda()
            step_err = max(step_err, float((logits - got[:, t])[rows].abs().max()))
        spread = float(got[:, 0].std(dim=-1).mean())
    log(f"marian teacher forcing, {n} pairs of 8-24 words (source {args[0].shape[1]} / target "
        f"{dec.shape[1]} wide), f32: card against CPU max|err| {err:.3e} (max|ref| "
        f"{top:.3f}); decode_token against the full decode {step_err:.3e}; next-token logits "
        f"spread (std over the vocabulary) {spread:.3f} nats")
    if not (err <= MARIAN_TOL * top and step_err <= MARIAN_TOL * top):
        fail(f"marian logits: card {err:.3e}, decode_token {step_err:.3e} against "
             f"{MARIAN_TOL} x {top:.3f}")
    report["marian"]["teacher_forced"] = {"max_abs_err": err, "max_ref": top,
                                          "decode_token_err": step_err, "logit_spread": spread}


def marian_generate(report: dict, dirs: dict, tok, caps: list) -> None:
    """greedy_decode_cached and beam_decode_cached (4 beams, max_length 128,
    PAD suppressed, forced EOS) on the card against the uncached forms on 8
    rows, and the card's beams on 8 rows scored on the CPU against the CPU's
    own beam search; rows that differ must do so at a near tie."""
    import torch

    from qst_tpu_torch.augment.backtranslation import format_batch_texts
    from qst_tpu_torch.models import seq2seq as ts

    cfg, d = dirs["cfg"], dirs["opus-mt-en-fr"]
    kw = dict(max_length=128, suppress_tokens=(cfg.pad_token_id,), forced_eos=0)
    src = tok(format_batch_texts(caps[:MARIAN_CPU_ROWS]))
    ids, mask = (torch.from_numpy(src[k]) for k in ("input_ids", "attention_mask"))
    ids8, mask8 = ids[:MARIAN_GEN_ROWS].cuda(), mask[:MARIAN_GEN_ROWS].cuda()
    card = ts.marian_module(cfg, d["cuda"])
    out, ties = {}, {}
    for name in ("greedy_decode", "beam_decode"):
        beam = {"num_beams": 4} if name == "beam_decode" else {}
        cached = getattr(ts, name + "_cached")(d["cuda"], ids8, mask8, cfg, **kw, **beam)
        plain = getattr(ts, name)(d["cuda"], ids8, mask8, cfg, **kw, **beam)
        if not (cached.is_cuda and cached.shape == (MARIAN_GEN_ROWS, 128)):
            fail(f"{name}_cached gave {tuple(cached.shape)} on {cached.device}")
        differ = [i for i in range(MARIAN_GEN_ROWS) if not torch.equal(cached[i], plain[i])]
        for i in differ:
            if beam:
                s = marian_scores(card, ids8[i:i + 1].expand(2, -1), mask8[i:i + 1].expand(2, -1),
                                  torch.stack([cached[i], plain[i]]), cfg, 1.0)
                ok = float(s[0]) >= float(s[1]) - MARIAN_TOL * abs(float(s[1]))
            else:                # the first differing token: its logit margin
                t = int((cached[i] != plain[i]).nonzero()[0])
                with torch.no_grad():
                    h = card._decode_hidden(plain[i:i + 1, :t], torch.ones_like(plain[i:i + 1, :t]),
                                            card.encode(ids8[i:i + 1], mask8[i:i + 1]),
                                            mask8[i:i + 1])
                    row = card._logits(h[:, -1])[0]
                ok = abs(float(row[cached[i, t]] - row[plain[i, t]])) <= (
                    MARIAN_TOL * float(row.abs().max()))
            if not ok:
                fail(f"{name}: cached and uncached row {i} differ beyond a near tie")
        ties[name] = len(differ)
        out[name] = cached
    # card against CPU: the CPU's own beam search at this width, both scored there
    t0 = time.perf_counter()
    cpu_beams = ts.beam_decode_cached(d["cpu"], ids, mask, cfg, num_beams=4, **kw)
    cpu_s = time.perf_counter() - t0
    card_beams = ts.beam_decode_cached(d["cuda"], ids.cuda(), mask.cuda(), cfg, num_beams=4,
                                       **kw).cpu()
    cpu = ts.marian_module(cfg, d["cpu"])
    s_card = marian_scores(cpu, ids, mask, card_beams, cfg, 1.0)
    s_cpu = marian_scores(cpu, ids, mask, cpu_beams, cfg, 1.0)
    same = [bool(torch.equal(a, b)) for a, b in zip(card_beams, cpu_beams)]
    short = (s_cpu - MARIAN_TOL * s_cpu.abs()) - s_card
    log(f"marian generation at max_length 128, PAD suppressed, forced EOS: cached against "
        f"uncached on {MARIAN_GEN_ROWS} rows, greedy {MARIAN_GEN_ROWS - ties['greedy_decode']} "
        f"token-identical + {ties['greedy_decode']} at near ties, 4 beams "
        f"{MARIAN_GEN_ROWS - ties['beam_decode']} + {ties['beam_decode']}; card against the "
        f"CPU's own beam search ({cpu_s:.1f} s on the host) on {MARIAN_CPU_ROWS} rows: "
        f"{sum(same)} token-identical, {len(same) - sum(same)} differ at near ties; worst "
        f"score shortfall {float((s_cpu - s_card).max()):.3e} (scores {float(s_cpu.min()):.3f} "
        f"to {float(s_cpu.max()):.3f})")
    if bool((short > 0).any()):
        fail(f"marian: the card's beams score below the CPU's by more than {MARIAN_TOL} of "
             f"the best: {(s_cpu - s_card).tolist()}")
    report["marian"]["generation"] = {
        "cached_vs_uncached_near_ties": ties, "card_vs_cpu_identical": sum(same),
        "card_vs_cpu_near_ties": len(same) - sum(same), "cpu_beam_s": cpu_s,
        "worst_shortfall": float((s_cpu - s_card).max())}


def marian_roundtrip(report: dict, dirs: dict, tok, caps: list) -> object:
    """get_backtranslator(backend="jax") over 128 captions at batch 32, f32:
    translations/s a hop and for the round trip, ms a cached decode step,
    the busy share and the kernel launches of a decode step; the same
    memoized instance on a second call. → the backtranslator."""
    import torch

    from qst_tpu_torch.augment import backtranslation as bt_mod
    from qst_tpu_torch.models import seq2seq as ts

    en_fr, fr_en = dirs["opus-mt-en-fr"]["path"], dirs["opus-mt-fr-en"]["path"]
    bt_mod.reset_backtranslator()
    bt = bt_mod.get_backtranslator(en_fr, fr_en, backend="jax", tokenizers=(tok, tok))
    if not isinstance(bt, bt_mod.JaxMarianBacktranslator) or bt_mod.get_backtranslator(
            en_fr, fr_en, backend="jax", tokenizers=(tok, tok)) is not bt:
        fail(f"get_backtranslator(backend='jax') gave {type(bt).__name__}, not one memoized "
             "on-card Marian")
    if not all(v.is_cuda for p in (bt.fwd_params, bt.bwd_params) for v in p.values()):
        fail("the backtranslator's parameters are not on the card")
    bt.backtranslate(caps[:32])                          # warm-up
    t0 = time.perf_counter()
    fr = bt._translate(bt_mod.format_batch_texts(caps), bt.fwd_cfg, bt.fwd_params, bt.tok_fwd,
                       bt.fwd_gen)
    t1 = time.perf_counter()
    back = bt._translate(fr, bt.bwd_cfg, bt.bwd_params, bt.tok_bwd, bt.bwd_gen)
    t2 = time.perf_counter()
    if len(back) != len(caps) or not all(t.startswith("tok") for t in back):
        fail(f"the roundtrip gave {len(back)} texts: {back[:2]}")
    # one batch of the first hop, 127 steps and 1
    enc = tok(bt_mod.format_batch_texts(caps[:32]), max_length=128)
    S = bt._bucket(enc["input_ids"].shape[1], 128)
    ids = np.pad(enc["input_ids"], ((0, 0), (0, S - enc["input_ids"].shape[1])),
                 constant_values=bt.fwd_cfg.pad_token_id)
    mask = np.pad(enc["attention_mask"], ((0, 0), (0, S - enc["input_ids"].shape[1])))
    ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    kw = dict(num_beams=4, suppress_tokens=(bt.fwd_cfg.pad_token_id,), forced_eos=0)

    def run(length):
        def go():
            toks = ts.beam_decode_cached(bt.fwd_params, ids, mask, bt.fwd_cfg,
                                         max_length=length, **kw)
            if not toks.is_cuda:
                fail("the generated tokens are not on the card")
        return go

    times = {}
    for length in (2, 128, 2, 128):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(length)()
        torch.cuda.synchronize()
        times.setdefault(length, []).append(time.perf_counter() - t)
    step_ms = (min(times[128]) - min(times[2])) * 1e3 / 126
    # one decode step by kernel: 33 steps less 1, profiled
    (wall_a, a), (wall_b, b) = ((w["wall_ms_per_step"], w["kernels"])
                                for w in (window(run(34), 1), window(run(2), 1)))
    by_name = {k: ((a[k][0] - b.get(k, (0, 0.0))[0]) / 32, (a[k][1] - b.get(k, (0, 0.0))[1]) / 32)
               for k in a}
    per_step = sum(n for n, _ in by_name.values())
    dev_ms = sum(ms for _, ms in by_name.values())
    wall_ms = (wall_a - wall_b) / 32
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    rates = {"en_fr": len(caps) / (t1 - t0), "fr_en": len(caps) / (t2 - t1),
             "roundtrip": len(caps) / (t2 - t0)}
    log(f"marian roundtrip, get_backtranslator(backend='jax'), {len(caps)} captions at batch "
        f"32 x 4 beams, max_length 128, f32: en->fr {rates['en_fr']:.1f}, fr->en "
        f"{rates['fr_en']:.1f}, round trip {rates['roundtrip']:.1f} translations/s; a cached "
        f"decode step {step_ms:.3f} ms (batch of 32 at 128 steps {1e3 * min(times[128]):.1f} "
        f"ms, at 1 step {1e3 * min(times[2]):.1f} ms); profiled, a step {wall_ms:.3f} ms of "
        f"wall, {dev_ms:.3f} ms on the device (busy {100 * dev_ms / wall_ms:.1f}%), "
        f"{per_step:.1f} kernel launches; by kernel (launches, device ms a step): "
        + "; ".join(f"{short_name(k)} {n:.1f} {ms:.4f}" for k, (n, ms) in top))
    report["marian"]["roundtrip"] = {
        "translations_per_s": rates, "step_ms": step_ms, "busy": dev_ms / wall_ms,
        "device_ms_per_step": dev_ms, "profiled_wall_ms_per_step": wall_ms,
        "launches_per_step": per_step,
        "batch_ms": {n: 1e3 * min(v) for n, v in times.items()},
        "kernels_per_step": {short_name(k): v for k, v in top}}
    return bt


def marian_dataset(report: dict, bt) -> None:
    """dataset_main with adaptive_crop_augment over 8 synthetic images while
    the on-card Marian is the memoized backtranslator: its chunks, every
    part-positive a Marian roundtrip (counted by wrapping backtranslate),
    images/s and backtranslation's share of the wall."""
    from qst_tpu_torch.augment import backtranslation as bt_mod
    from qst_tpu_torch.cli import dataset_main
    from qst_tpu_torch.data import QuadrupletDataset
    from qst_tpu_torch.data.chunks import discover_chunks, read_meta
    from qst_tpu_torch.experiments.ablation import make_coco_annotations

    tmp = work_dir("marian_dataset")
    ann = f"{tmp}/captions.json"
    make_coco_annotations(ann, MARIAN_IMAGES, np.random.default_rng(142))
    cls, spent = bt_mod.JaxMarianBacktranslator, {"calls": 0, "rows": 0, "s": 0.0}
    backtranslate = cls.backtranslate

    def counted(self, texts):
        t0 = time.perf_counter()
        out = backtranslate(self, texts)
        spent["s"] += time.perf_counter() - t0
        spent["calls"] += 1
        spent["rows"] += len(texts)
        return out

    cls.backtranslate = counted
    try:
        if bt_mod.get_backtranslator() is not bt:
            fail("the memoized backtranslator is not the on-card Marian")
        t0 = time.perf_counter()
        code = dataset_main.main(["--ann_file", ann, "--output_root", f"{tmp}/out",
                                  "--chunk_dim", str(MARIAN_IMAGES // 2),
                                  "--part_pos_algorithm", "adaptive_crop_augment"])
        wall = time.perf_counter() - t0
    finally:
        cls.backtranslate = backtranslate
        bt_mod.reset_backtranslator()
    root = f"{tmp}/out/CoCoCaptionDataset"
    insts = list(QuadrupletDataset(root, seed=14).store.iter_instances())
    parts = [p for i in insts for p in i["part_positive"]]
    marian = sum(all(w.startswith("tok") for w in p.split()) and bool(p) for p in parts)
    log(f"marian in dataset_main (adaptive_crop_augment): {MARIAN_IMAGES} images in "
        f"{wall:.1f} s = {MARIAN_IMAGES / wall:.2f} images/s; backtranslate called "
        f"{spent['calls']} times on {spent['rows']} rows, {spent['s']:.1f} s "
        f"({100 * spent['s'] / wall:.1f}% of the wall); {marian} of {len(parts)} part-positives "
        f"are Marian roundtrips; chunks {discover_chunks(root)}")
    if (code != 0 or read_meta(root) != 2 or discover_chunks(root) != [0, 1]
            or len(insts) != MARIAN_IMAGES or spent["rows"] < len(parts) or not parts
            or marian != len(parts)):
        fail("dataset_main with the on-card Marian did not write the expected chunks")
    report["marian"]["dataset"] = {"wall_s": wall, "images_per_s": MARIAN_IMAGES / wall,
                                   "backtranslate_calls": spent["calls"],
                                   "rows": spent["rows"], "backtranslate_s": spent["s"],
                                   "share": spent["s"] / wall}


def marian(report: dict) -> None:
    """Marian seq2seq and the on-card backtranslator at opus-mt width:
    directories, teacher-forced parity, generation, the roundtrip's rates
    and dataset_main's use of it. No kernel of the port runs here:
    the JAX package computes Marian in plain XLA."""
    import torch

    report["marian"] = {}
    parts = {}
    t0 = time.perf_counter()
    dirs = marian_dirs(report, work_dir("marian"))
    parts["directories"] = time.perf_counter() - t0
    tok = HashWordTok(dirs["cfg"])
    caps = marian_captions(MARIAN_CAPTIONS, seed=143)

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(report, *args)
        parts[name] = time.perf_counter() - t0
        return out

    timed("parity", marian_parity, dirs, tok, caps)
    timed("generation", marian_generate, dirs, tok, caps)
    bt = timed("roundtrip", marian_roundtrip, dirs, tok, caps)
    timed("dataset", marian_dataset, bt)
    del dirs, bt
    torch.cuda.empty_cache()
    report["marian"]["part_s"] = parts
    log("marian phase by part (s): " + ", ".join(f"{n} {v:.1f}" for n, v in parts.items()))


def main() -> None:
    global ABLATION_STEPS
    default_steps = ABLATION_STEPS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--ablation_steps", type=int, default=default_steps,
                    help="train steps an arm in the ablation phase (2000: the decisive run, "
                    "all its quality bars)")
    ap.add_argument("--dist_child", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)      # a process of the dist phase's group
    args = ap.parse_args()
    if args.dist_child:
        dist_child(int(args.dist_child[0]), args.dist_child[1], args.dist_child[2])
        return
    ABLATION_STEPS = args.ablation_steps
    phases = args.phases.split(",")
    if any(p not in PHASES for p in phases):
        fail(f"unknown phase in {phases}; choices {PHASES}")
    if "pq" in phases:
        # kineto's accounting of each window on stderr, read by pq's C2 probe
        # (kineto reads the level once, before torch loads it)
        os.environ.setdefault("KINETO_LOG_LEVEL", "1")
    try:
        import torch

        from qst_tpu_torch.kernels import build
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain references in full f32
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    report = {n: {} for n in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9")}
    # the phases run in the order given (PHASES' by default)
    fns = {"check": check_kernels, "serve": serve, "ivf": ivf, "train": train, "times": times,
           "profile": profile_phase, "evaluate": evaluate, "dataset": dataset,
           "capture": capture, "ablation": ablation, "mpnet": mpnet, "flash": flash,
           "roberta": roberta, "marian": marian, "train_mesh": train_mesh, "dist": dist,
           "mesh": mesh, "pq": pq}
    for phase in phases:
        if phase in fns:
            t0 = time.perf_counter()
            fns[phase](report)
            log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    if "tree" in _WORK:
        _WORK.pop("tree").cleanup()
    log(json.dumps({k: v for k, v in report.items()
                    if k in ("encode", "search", "search_q256", "k4_yardsticks", "k5_forms",
                             "train", "train_steps_per_s", "ivf", "ivf_times", "ivf_times_4m", "layer_gemm",
                             "evaluate", "encode_depth", "capture", "ablation", "mpnet",
                             "mpnet_kernel_names", "pq", "flash", "roberta", "marian",
                             "train_mesh", "dist", "mesh")}))
    if "dataset" in report:
        log(json.dumps({"dataset": {k: v for k, v in report["dataset"].items() if k != "root"}}))
    log(json.dumps({"K1_training_layer": {k: report["K1"].get(k) for k in (
        "train_ms", "train_no_dropout_ms", "dropout_max_abs_err", "module_layer_ms")},
        "K1_pieces_ms": report["K1"].get("pieces_ms"),
        "K2_pieces_ms": report["K2"].get("pieces_ms"),
        "layer_gemm_max_rel_err": report["K1"].get("gemm_max_rel_err"),
        "K5_gather_ms": report["K5"].get("gather_ms")}))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    rows = []
    for name, src, replaces in (
            ("K1 fused_bert_layer", "qst_tpu_torch/kernels/csrc/fused_layer.cu",
             "qst_tpu/ops/fused_layer_pallas.py:111"),
            ("K2 fused_bert_layer_bwd", "qst_tpu_torch/kernels/csrc/fused_layer_bwd.cu",
             "qst_tpu/ops/fused_layer_pallas.py:345"),
            ("K3 fused_gamma_quadruplet_loss", "qst_tpu_torch/kernels/csrc/quadruplet.cu",
             "qst_tpu/ops/quadruplet_pallas.py:33"),
            ("K4 bucket_maxima", "qst_tpu_torch/kernels/csrc/topk.cu",
             "qst_tpu/ops/topk_pallas.py:92"),
            ("K5 rescore_buckets", "qst_tpu_torch/kernels/csrc/topk.cu",
             "qst_tpu/ops/topk_pallas.py:251"),
            ("K6 ivf_cell_scores", "qst_tpu_torch/kernels/csrc/ivf.cu",
             "qst_tpu/ops/ivf_pallas.py:34"),
            ("K7 flash_attention", "qst_tpu_torch/kernels/csrc/flash_attention.cu",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:758"),
            ("K8 flash_attention_bwd", "qst_tpu_torch/kernels/csrc/flash_attention.cu",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
            ("K9 module_keep_mask", "qst_tpu_torch/kernels/csrc/fused_layer.cu",
             "qst_tpu/models/bert.py:109")):
        r = report[name[:2]]
        if name[:2] in ("K7", "K8"):
            # the library kernel qst_tpu calls at qst_tpu/models/bert.py:96;
            # one PyTorch call computes the same function:
            # scaled_dot_product_attention with the segment mask
            rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                         "launches": r.get("launches"), "max_abs_err": r.get("max_abs_err"),
                         "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                         "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
                         "library_ms": r.get("library_ms"), "shape": r.get("shape"),
                         "all_real_ms": r.get("all_real_ms"),
                         **({"also_replaces": "jax/experimental/pallas/ops/tpu/"
                             "flash_attention.py:1456", "library_call": r.get("library_call"),
                             "library_fwd_bwd_ms": r.get("library_fwd_bwd_ms"),
                             "k7_k8_autograd_ms": r.get("k7_k8_autograd_ms")}
                            if name[:2] == "K8" else
                            {"encode_shapes": r.get("encode_shapes"),
                             "roberta_shape": r.get("roberta_shape")})})
            continue
        # library_ms: no single PyTorch call computes any of these functions
        # (a layer, its backward, the quadruplet loss, a product fused with
        # bucket maxima, two gathers fused with a product), so none is timed
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": r.get("launches"), "max_abs_err": r.get("max_abs_err"),
               "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
               "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
               "library_ms": None}
        if name[:2] in ("K1", "K2"):
            # the mpnet phase's shapes: MPNet-base with rel_bias / drel at
            # S = 128 and 384 and MiniLM-L6 at S = 128 and 256, and the worst
            # error against the plain versions up to S = 512
            row["mpnet_long_s"] = r.get("mpnet_long_s")
            row["mpnet_max_abs_err"] = r.get("mpnet_max_abs_err")
        if name[:2] == "K9":
            # no TPU kernel: the nn.Module path's dropout, which qst_tpu draws
            # with jax.random in flax's nn.Dropout (bert.py:55, :109, :115,
            # :134); torch.rand's draw, which it replaced, timed beside it
            row.update(replaces_note="flax nn.Dropout's jax.random draw, no Pallas kernel",
                       torch_rand_ms=r.get("torch_rand_ms"), shape=r.get("shape"))
        if name[:2] in ("K4", "K5"):
            # the pq phase's shapes: one decoded 2M-row bf16 slice of the
            # PQ index's kernels' path, Q = 256 at k = 80 and Q = 4096 at 10
            row["pq_slice"] = r.get("pq_slice")
        rows.append(row)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
