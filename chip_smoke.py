"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU (serving to datasets).

    python3 chip_smoke.py                          # every phase, one GPU
    python3 chip_smoke.py --phases build,check     # a new kernel's first, short call
    python3 chip_smoke.py --phases build,check,train
    python3 chip_smoke.py --phases build,check,ivf
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
   peak rate); encode sentences/s at B=256, S=128; a 65,536-text encode to
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
   then random mode -1; IR + quadruplet + loss evaluation every 10 steps):
   the evaluations at epoch -1 and each evaluation step, finite losses, and
   K1 / K2 / K3 launches exactly the steps', the miner's and the
   evaluators'; the evaluators on the trained model against their plain
   versions (IR metrics and accuracies within 0.005, the loss within 2e-2
   relative) and the logged validation loss recomputed; ir_eval_main over
   the 11,200 (cos and dot, k up to 128) for baseline and trained through
   the exact index (one K4 and one K5 a dot search), for the baseline
   through the IVF index (K6), and the trained model's evaluation through
   the plain versions; one evaluation timed by part; the miner's table
   refresh, steps/s with and without the miner, the device's busy share.
9. dataset — qst_tpu_torch.cli.dataset_main as a user calls it: 4,000
   synthetic images (20,000 captions, the ablation's recipe), positives
   mined by MiniLM-L6 on the card, adaptive-crop partial positives, chunks
   of 500, the verbose check; the eight chunks and the metadata read back;
   wall time, images/s, encode calls and the encoder's share.
10. capture — the captured train step on those chunks at the training
   configuration: four steps a call as one CUDA graph (the first call runs
   eagerly and captures) against eager steps from the same state, bit for
   bit in losses, parameters and Adam moments, at dropout 0.1, at dropout 0
   and with accumulation 2, with K1 / K2 / K3 launches exact across
   replays; train_main at --steps_per_call 1 and 4 in turns, with and
   without the miner (steps/s, equal final weights, busy share).
11. ablation — the port's quadruplet-vs-triplet ablation at the JAX run's
   decisive configuration (WordPiece, MiniLM-L6 through the fused layer,
   hard mining), four steps a call, 500 steps an arm (the JAX script's
   default: the ordering bars) or, with --ablation_steps 2000 (its own call:
   --phases build,ablation), the decisive run and all its quality bars; the
   RESULTS.md table beside the JAX rows.

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
   against eager steps, train_main --hf_checkpoint_dir (24 steps at
   S = 384) and ir_eval_main --hf_checkpoint_dir over the evaluate phase's
   11,200 instances (one K4 and one K5); K1/K2 times at MPNet-base S = 128
   and 384 and MiniLM-L6 S = 128 and 256 beside their bounds, encode
   sentences/s and the MPNet-base train step with its busy share (no
   library GEMM or attention kernel in a profiled encode or train step).

The last lines are the card's name and power limit (nvidia-smi), one JSON
object with a row per kernel, and {"ok": true, "device": {...}}.

Imports torch, numpy, the standard library and qst_tpu_torch only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

PHASES = ("build", "check", "serve", "ivf", "train", "times", "profile", "evaluate", "dataset",
          "capture", "ablation", "mpnet")


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


LIBRARY_KERNEL_MARKS = ("gemm", "gemv", "nvjet", "cutlass", "cublas", "xmma", "flash", "fmha",
                        "sdpa", "attention")


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
    from torch.profiler import ProfilerActivity, profile

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
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):   # the trace may miss the first kernel after it starts
                    qn @ index.centroids.T
                torch.cuda.synchronize()
            centroid_kernels = set(library_kernels(prof))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        return " ".join(words[j] for j in ws)

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


class plain_kernels:
    """Within the block, the training path's kernel wrappers are their plain
    versions (so the same step runs through K1/K2/K3's plain versions on
    the card, for the gradient comparison); restored on exit."""

    def __enter__(self):
        from qst_tpu_torch.ops import fused_layer as fl
        from qst_tpu_torch.ops import quadruplet as qd

        self.saved = [(fl, "fused_bert_layer", fl.fused_bert_layer_plain),
                      (fl, "fused_bert_layer_bwd", fl.fused_bert_layer_bwd_plain),
                      (qd, "fused_gamma_quadruplet_loss_fwd", qd.fused_gamma_quadruplet_loss_plain),
                      (qd, "fused_gamma_quadruplet_loss_bwd",
                       qd.fused_gamma_quadruplet_loss_bwd_plain)]
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


EVAL_STEPS = 10
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
    t0 = time.perf_counter()
    with logged("qst_tpu_torch.cli.train") as records:
        if train_main.main(argv) != 0:
            fail(f"train_main --hard_contrastive_mode {mode} failed")
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
            "miner_k1": miner, "steps_k1": 6 * steps, "evaluators_k1": len(evals) * per_eval}


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
    t0 = time.perf_counter()
    if ir_eval_main.main(argv) != 0:
        fail(f"ir_eval_main --eval_index {index} failed")
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
    return {"results": results, "wall_s": wall, "eval_set": f"{out_root}/{out}/ir_eval_set.json"}


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
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def evaluate(report: dict) -> None:
    """Training with validation and negative mining, and IR evaluation, from
    the command line: a synthetic dataset of 11,200 instances (66,200 IR
    docs from 1,000 queries) and its first 960 instances; train_main on the
    960 in modes 1 and -1 with every evaluator each 10 steps; the
    evaluators against their plain versions on the trained model;
    ir_eval_main over the 11,200 through the exact index (K4 + K5 in the
    dot searches) for baseline and trained, and the IVF index (K6) for the
    baseline; the trained model's evaluation again through the plain
    versions; then the times of one evaluation and of the miner."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        big, small = f"{tmp}/big", f"{tmp}/small"
        write_quadruplet_chunks(big, 11200, seed=21)
        write_quadruplet_chunks(small, 960, seed=21)      # the first 960 of the same draws
        runs = {mode: train_main_run(report, small, f"{tmp}/exp{mode}", mode)
                for mode in ("1", "-1")}
        parity = compare_evaluators(f"{tmp}/exp1", small, tmp)
        exact = ir_eval_run(report, big, f"{tmp}/exp1", f"{tmp}/ir_exact", "exact")
        ivf_run = ir_eval_run(report, big, None, f"{tmp}/ir_ivf", "ivf")
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


DATASET_IMAGES = 4000     # the ablation's recipe: five captions an image


def dataset(report: dict) -> None:
    """dataset_main as a user calls it on the card: MiniLM-L6 (random init,
    its nn.Module path, as the JAX CLI leaves the fused flag off) mining the
    positives of 4,000 synthetic images (20,000 captions) at cos >= 0.6,
    adaptive-crop partial positives, chunks of 500 and the verbose check;
    then the eight chunks and the metadata read back through
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
    if (code != 0 or read_meta(root) != 8 or discover_chunks(root) != list(range(8))
            or len(ds) != DATASET_IMAGES or not checked
            or any(len(i["positive"]) != 4 or len(i["part_positive"]) != 8 for i in insts)):
        fail("dataset_main did not write the expected eight chunks")
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
    kernels) of ``run()``, per step, and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms = sum(device_us(e) for e in prof.key_averages() if is_kernel(e)) / 1e3
    return {"wall_ms_per_step": wall * 1e3 / steps, "device_ms_per_step": dev_ms / steps,
            "busy": dev_ms / (wall * 1e3)}


def capture(report: dict) -> None:
    """The captured train step on the dataset phase's chunks, at the training
    configuration (MiniLM-L6, fused layer and loss, batch 32 quadruplets,
    S = 128): K = 4 steps a call, two calls (the first runs its steps
    eagerly and captures, the second replays) against eight eager steps from
    the same state — losses, parameters and Adam moments bit for bit — at
    dropout 0.1, at dropout 0 and with accumulation 2, and K1 / K2 / K3
    launches exactly the steps'. Then train_main at --steps_per_call 1 and
    4 in turns, with the miner and without, over 1,000 instances (31
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
        for K_call in (1, K, K, 1):
            name = f"{'mined' if mined else 'plain'} K={K_call}"
            before = [c.launches for c in counters]
            result = trainer_for(K_call, mined, name.replace(" ", "_")).train()
            rates.setdefault(name, []).append(result.steps_per_sec)
            finals.setdefault(name, {n: t.detach().clone() for n, t in
                                     result.state.model.state_dict().items()})
            add_train_launches(report, [c.launches - b for c, b in zip(counters, before)])
    same = {m: all(torch.equal(finals[f"{m} K=1"][n], t) for n, t in finals[f"{m} K={K}"].items())
            for m in ("mined", "plain")}
    log(f"train_main, 31 steps at --steps_per_call 1 and {K} in turns (steps/s in the loop, "
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
            busy[f"{'mined' if mined else 'plain'} K={K_call}"] = w
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
                          "table": {k: abl.table_row(v) for k, v in out["results"].items()}}


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
    # starts, and a second trace is taken when this one lost the forward too
    for attempt in range(2):
        seq = device_sequence(lambda: (one.clone(), unbound()))
        while seq and "quadruplet_" not in seq[0]:
            seq.pop(0)
        if seq and "quadruplet_fwd_kernel" in seq[0]:
            break
        log(f"the trace lost K3's forward (attempt {attempt + 1} of 2): {seq}")
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
    report["train_steps_per_s"] = train_step_rates(gen)

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

    # SentenceEncoder.encode of 65,536 texts to numpy, the evaluators' and the
    # miner's call: dispatch_depth 1 (each batch's copy waited for) against 4,
    # in turns (1, 4, 4, 1), host clock
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder
    from qst_tpu_torch.models.tokenizer import HashTokenizer

    sent = SentenceEncoder(cfg, model.state_dict(), HashTokenizer(cfg.vocab_size))
    docs = synthetic_docs(65536, seed=31)
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
    log(f"encode of 65,536 texts to numpy (fused MiniLM-L6, batches of 256): dispatch_depth 1 "
        f"{['%.3f' % t for t in depth[1]]} s, 4 {['%.3f' % t for t in depth[4]]} s "
        f"(identical arrays)")
    report["encode_depth"] = {"texts": 65536, "depth1_s": depth[1], "depth4_s": depth[4]}

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


def train_step_rates(gen) -> dict:
    """Steps/s (host clock, synchronised) of the kernel path one step a
    call, the same steps captured four a call (one CUDA graph replay), and
    the nn.Module path with the plain loss, timed in turns: kernels,
    captured, module, module, captured, kernels; 20 steps each after warm-up
    (3 steps; the captured path's first call runs eagerly and captures)."""
    import dataclasses

    import torch

    from qst_tpu_torch.train import dropout_key, make_multi_step

    dev = torch.device("cuda")
    enc_cfg, loss_cfg, _ = train_config()
    paths = {"kernels": (enc_cfg, loss_cfg), "captured": (enc_cfg, loss_cfg),
             "module": (dataclasses.replace(enc_cfg, use_fused_layer=False),
                        dataclasses.replace(loss_cfg, use_fused_kernel=False))}
    rates = {"kernels": [], "captured": [], "module": []}
    K = 4
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
        t0 = time.perf_counter()
        for c in timed:
            c()
        torch.cuda.synchronize()
        rates[name].append(n / (time.perf_counter() - t0))
        del state
    log(f"train steps/s, MiniLM-L6, batch 32 quadruplets, S=128, bf16, dropout 0.1: "
        f"kernel path {rates['kernels']}, captured {K} a call {rates['captured']}, "
        f"nn.Module path with plain loss {rates['module']}")
    return rates


def device_us(event) -> float:
    """A profiler event's own device time in µs (the name varies by torch)."""
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


def profiled(fn, reps: int):
    """torch.profiler over ``reps`` calls of ``fn``, after three marker
    kernels (``torch.cuda._sleep``): the trace can miss the first kernels
    after it starts, and the markers take that loss. → the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
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


def ban_library_kernels(kernels: dict, what: str) -> None:
    """Fail if a library's GEMM or attention kernel ran (``device_ms``'s names)."""
    banned = sorted(n for n in kernels if "qst::" not in n
                    and any(b in n.lower() for b in LIBRARY_KERNEL_MARKS))
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
            time.sleep(6.0)
            after, n1, window = server._search_batcher.stats(), len(lat), time.perf_counter() - t0
            busy = None
            if n_clients == 64:                   # busy share, still under load
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    fused layer and loss: 24 steps at batch 32 quadruplets, every batch at
    S = 384; K2 and K3's backward launched exactly 12 and 1 times a step."""
    import torch

    from qst_tpu_torch.cli import train_main
    from qst_tpu_torch.data import ChunkStore

    data = f"{tmp}/long"
    write_long_chunks(data, 768, seed=31)
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
    big = f"{tmp}/big"
    write_quadruplet_chunks(big, 11200, seed=21)
    run = ir_eval_run(report, big, None, f"{tmp}/ir_mpnet", "exact",
                      extra=["--hf_checkpoint_dir", mpnet_dir])
    report["mpnet"]["ir_eval_main_s"] = run["wall_s"]
    report["mpnet"]["ir_eval_map100"] = {
        f: m["map@100"] for f, m in run["results"]["baseline"]["metrics"].items()}


def mpnet_times(report: dict) -> None:
    """K1 and K2 at MPNet-base (S = 128 and 384) and MiniLM-L6 (S = 128 and
    256) beside their bounds and plain versions; encode sentences/s at
    B = 256, S = 128 and 384, fused against nn.Module; the MPNet-base train
    step (batch 32 quadruplets, S = 128) through the kernels and the
    nn.Module path, with the device's busy share."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(10):
                state, _ = step(state, ids, mask, dropout_key(14, i + 4))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 10
        dev_ms = sum(device_us(e) for e in prof.key_averages()
                     if e.device_type.name == "CUDA"
                     and not getattr(e, "is_user_annotation", False)
                     and not e.key.startswith("Optimizer.")) / 1e3 / 10
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


def main() -> None:
    global ABLATION_STEPS
    default_steps = ABLATION_STEPS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--ablation_steps", type=int, default=default_steps,
                    help="train steps an arm in the ablation phase (2000: the decisive run, "
                    "all its quality bars)")
    args = ap.parse_args()
    ABLATION_STEPS = args.ablation_steps
    phases = args.phases.split(",")
    if any(p not in PHASES for p in phases):
        fail(f"unknown phase in {phases}; choices {PHASES}")
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
    report = {n: {} for n in ("K1", "K2", "K3", "K4", "K5", "K6")}
    # evaluate last: its trainer threads and profiled steps come after the
    # timing phases' profiles
    for phase, fn in (("check", check_kernels), ("serve", serve), ("ivf", ivf), ("train", train),
                      ("times", times), ("profile", profile_phase), ("evaluate", evaluate),
                      ("dataset", dataset), ("capture", capture), ("ablation", ablation),
                      ("mpnet", mpnet)):
        if phase in phases:
            t0 = time.perf_counter()
            fn(report)
            log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    if "tree" in _WORK:
        _WORK.pop("tree").cleanup()
    log(json.dumps({k: v for k, v in report.items()
                    if k in ("encode", "search", "search_q256", "k4_yardsticks", "k5_forms",
                             "train", "train_steps_per_s", "ivf", "ivf_times", "ivf_times_4m", "layer_gemm",
                             "evaluate", "encode_depth", "capture", "ablation", "mpnet",
                             "mpnet_kernel_names")}))
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
             "qst_tpu/ops/ivf_pallas.py:34")):
        r = report[name[:2]]
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
        rows.append(row)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
