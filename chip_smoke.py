"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py                          # every phase, one GPU
    python3 chip_smoke.py --phases build,check     # a new kernel's first, short call
    python3 chip_smoke.py --phases build,check,train

Phases (any failure exits non-zero and prints no result):

1. build  — compile qst_tpu_torch/kernels/csrc/*.cu with nvcc (sm_90a), one
   nvcc per source, all at once.
2. check  — each kernel against its plain PyTorch version on the card at the
   main paths' shapes: K1 (fused BERT layer, MiniLM width, f32 and bf16),
   K4 (bucket maxima, f32/bf16/int8, N = 65,536 + 77, with and without
   n_real), K5 (winning-bucket rescore), topk_v2 against reference_topk;
   the dropout masks bit for bit, K1 with dropout, K2 (the layer's
   backward, with and without dropout) at B = 128, S = 128, and K3 (the
   fused quadruplet loss, forward and backward).
3. serve  — random-init MiniLM-L6 with use_fused_layer, a bfloat16 Retriever
   over 65,536 synthetic docs (so "auto" search takes K4 + K5), a
   RetrievalServer on port 0 answering concurrent POST /search, POST /encode
   and GET /healthz; answers held against the plain path; every kernel's
   launch count must rise.
4. train  — Trainer.train on a synthetic quadruplet dataset at the training
   configuration (MiniLM-L6, batch 32 quadruplets, S = 128, bf16, dropout
   0.1, fused γ loss, AdamW): finite losses, 6 K1 and 6 K2 launches and one
   K3 forward and backward per step; the first step's gradients at dropout
   0 against the plain versions; a falling loss on a repeated batch.
5. times  — kernel against plain at the main paths' shapes, encode
   sentences/s at B=256, S=128, search QPS over 1M x 384 bf16, Q=4096, and
   train steps/s of the kernel path against the nn.Module path.
6. profile — where the time goes: device time per kernel and the device's
   busy share for encode, a train step and search, and served req/s with
   p50/p99 latency at 1, 8 and 64 closed-loop clients.

The last lines are the card's name and power limit (nvidia-smi), one JSON
object with a row per kernel, and {"ok": true, "device": {...}}.

Imports torch, numpy, the standard library and qst_tpu_torch only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

PHASES = ("build", "check", "serve", "train", "times", "profile")


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
    # vectors (exact products, f32 sums in another order); int8 exactly equal
    N, D, Q, k = 65536 + 77, 384, 256, 10
    base = torch.nn.functional.normalize(torch.randn((N, D), generator=gen), dim=1)
    qbase = torch.nn.functional.normalize(torch.randn((Q, D), generator=gen), dim=1)
    k4_err = k5_err = 0.0
    for name in ("float32", "bfloat16", "int8"):
        if name == "int8":
            corpus = torch.round(base * 127).to(torch.int8).to(dev)
            queries = torch.round(qbase * 127).to(torch.int8).to(dev)
            tol = 0.0
        else:
            dt = getattr(torch, name)
            corpus, queries = base.to(dev, dt), qbase.to(dev, dt)
            tol = 1e-4
        for n_real in (None, N - 300):
            bm = topk.bucket_maxima(queries, corpus, n_real)
            bm_ref = topk.bucket_maxima_plain(queries, corpus, n_real)
            fin = torch.isfinite(bm_ref)
            if not torch.equal(torch.isfinite(bm), fin):
                fail(f"K4 {name} n_real={n_real}: -inf pattern differs")
            err = (bm[fin] - bm_ref[fin]).abs().max().item()
            log(f"K4 {name:8s} n_real={n_real}: max|err| {err:.3e} (limit {tol:.0e})")
            if not err <= tol:
                fail(f"K4 {name}: max|err| {err} > {tol}")
            if name == "bfloat16":
                k4_err = max(k4_err, err)
        ids = topk._hierarchical_top_buckets(bm_ref, k)
        ids[:, -1] = bm_ref.shape[1] + 3          # out of range: must read -inf
        rs = topk.rescore_buckets(queries, corpus, ids, k)
        rs_ref = topk.rescore_buckets_plain(queries, corpus, ids, k)
        fin = torch.isfinite(rs_ref)
        if not torch.equal(torch.isfinite(rs), fin):
            fail(f"K5 {name}: -inf pattern differs")
        err = (rs[fin] - rs_ref[fin]).abs().max().item()
        log(f"K5 {name:8s} k={k}: max|err| {err:.3e} (limit {tol:.0e})")
        if not err <= tol:
            fail(f"K5 {name}: max|err| {err} > {tol}")
        if name == "bfloat16":
            k5_err = max(k5_err, err)
        s, i = topk.topk_v2(queries, corpus, k)
        gs, gi = topk.reference_topk(queries, corpus, k)
        true = (queries.float() @ corpus.float().T).cpu().numpy()
        if not ids_match_up_to_ties(s.cpu(), i.cpu(), gs.cpu(), gi.cpu(), true, max(tol, 1e-6)):
            fail(f"topk_v2 {name}: answers differ from reference_topk")
        log(f"topk_v2 {name:8s}: matches reference_topk (ids up to ties)")
    report["K4"] = {"max_abs_err": k4_err}
    report["K5"] = {"max_abs_err": k5_err}
    check_training_kernels(report)


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

    # K3 forward and backward, f32, 1e-5 absolute (summation order only)
    Bq, D = 32, 384
    emb = [torch.nn.functional.normalize(torch.randn((Bq, D), generator=gen), dim=1).to(dev)
           for _ in range(4)]
    consts = dict(gamma=0.6, m_pn=1.0, m_pt=0.5, m_tn=0.5)
    loss, dists = qd.fused_gamma_quadruplet_loss_fwd(*emb, **consts)
    rloss, rdists = qd.fused_gamma_quadruplet_loss_plain(*emb, **consts)
    scale = torch.full((Bq,), 1.0 / Bq, device=dev)
    grads = qd.fused_gamma_quadruplet_loss_bwd(*emb, rdists, scale, **consts)
    rgrads = qd.fused_gamma_quadruplet_loss_bwd_plain(*emb, rdists, scale, **consts)
    err = max((loss - rloss).abs().max().item(), (dists - rdists).abs().max().item(),
              *[(a - b).abs().max().item() for a, b in zip(grads, rgrads)])
    log(f"K3 f32 B={Bq} D={D}: max|err| over loss, distances and 4 gradients {err:.3e} "
        f"(limit 1e-5)")
    if not err <= 1e-5:
        fail(f"K3: max|err| {err} > 1e-5")
    report["K3"] = {"max_abs_err": err}


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
        answers, errors = {}, []

        def ask(j):
            try:
                answers[j] = post(port, "/search", {"queries": [queries[j]], "k": 10})
            except Exception as e:  # reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=ask, args=(j,)) for j in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors or len(answers) != len(queries):
            fail(f"/search failed: {errors}")
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
    ss = np.array([[r[1] for r in answers[j]["results"][0]] for j in range(len(queries))])
    si = np.array([[r[0] for r in answers[j]["results"][0]] for j in range(len(queries))])
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
    banned = [n for n in names if "qst::" not in n and any(b in n.lower() for b in (
        "gemm", "gemv", "nvjet", "cutlass", "cublas", "xmma", "flash", "fmha", "sdpa",
        "attention"))]
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

    from qst_tpu_torch.core.telemetry import JsonLogSink
    from qst_tpu_torch.data import QuadrupletCollator, QuadrupletDataset
    from qst_tpu_torch.models.tokenizer import HashTokenizer
    from qst_tpu_torch.ops import fused_layer as fl
    from qst_tpu_torch.ops import quadruplet as qd
    from qst_tpu_torch.train import Trainer, create_train_state, make_train_step
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
            loss_from_config(loss_cfg)(*emb).backward()
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

    # a falling loss: 20 steps on one repeated batch, warmup 4
    state, _ = create_train_state(enc_cfg, dataclasses.replace(base, learning_rate=1e-4,
                                                               warmup_steps=4),
                                  torch.Generator().manual_seed(15), 20, loss_cfg, device=dev)
    step = make_train_step(enc_cfg, loss_cfg)
    losses = []
    for i in range(20):
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        state, loss = step(state, batch.input_ids, batch.attention_mask, gen)
        losses.append(loss.item())
    log(f"20 steps on one repeated batch (lr 1e-4, warmup 4): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {['%.3f' % v for v in losses]}")
    if not (all(np.isfinite(losses)) and np.mean(losses[-3:]) < np.mean(losses[:3])):
        fail(f"the loss did not fall: {losses}")


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
    k3_dev = device_ms(lambda: k3(qd.fused_gamma_quadruplet_loss_fwd,
                                  qd.fused_gamma_quadruplet_loss_bwd), 20)
    log(f"K3 forward + backward: {1e3 * report['K3']['ms']:.1f} us per call on CUDA events, "
        f"of which {1e3 * sum(k3_dev.values()):.1f} us on the device (the rest is launch "
        f"and host time)")

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
    report["encode"] = {"sentences_per_s": B / enc_ms * 1e3,
                        "module_path_sentences_per_s": B / mod_ms * 1e3}

    # search over 1M x 384 bf16, Q = 4096, k = 10
    N, D, Q, k = 1 << 20, 384, 4096, 10
    unit = torch.nn.functional.normalize
    corpus = unit(torch.randn((N, D), device=dev), dim=1).to(torch.bfloat16)
    queries = unit(torch.randn((Q, D), device=dev), dim=1).to(torch.bfloat16)
    report["K4"]["ms"] = cuda_ms(lambda: topk.bucket_maxima(queries, corpus), 5)
    report["K4"]["plain_ms"] = cuda_ms(lambda: [
        topk.bucket_maxima_plain(queries[lo:lo + 512], corpus) for lo in range(0, Q, 512)], 2)
    bm = topk.bucket_maxima(queries, corpus)
    bids = topk._hierarchical_top_buckets(bm, k)
    report["K5"]["ms"] = cuda_ms(lambda: topk.rescore_buckets(queries, corpus, bids, k), 10)
    report["K5"]["plain_ms"] = cuda_ms(
        lambda: topk.rescore_buckets_plain(queries, corpus, bids, k), 2)
    v2_ms = cuda_ms(lambda: topk.topk_v2(queries, corpus, k), 5)
    scan_ms = cuda_ms(lambda: exact_topk(queries.float(), corpus, k, "dot_score"), 2)
    report["search"] = {"qps": Q / v2_ms * 1e3, "plain_scan_qps": Q / scan_ms * 1e3}


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
    """Steps/s (host clock, synchronised) of the kernel path and of the
    nn.Module path with the plain loss, timed in turns: kernels, module,
    module, kernels; 20 steps each after 3 warm-up steps."""
    import dataclasses

    import torch

    dev = torch.device("cuda")
    enc_cfg, loss_cfg, _ = train_config()
    paths = {"kernels": (enc_cfg, loss_cfg),
             "module": (dataclasses.replace(enc_cfg, use_fused_layer=False),
                        dataclasses.replace(loss_cfg, use_fused_kernel=False))}
    rates = {"kernels": [], "module": []}
    for name in ("kernels", "module", "module", "kernels"):
        state, step, ids, mask = train_setup(*paths[name], gen, dev)
        gens = [torch.Generator(device=dev).manual_seed(i) for i in range(23)]
        for g in gens[:3]:
            step(state, ids, mask, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in gens[3:]:
            step(state, ids, mask, g)
        torch.cuda.synchronize()
        rates[name].append(20 / (time.perf_counter() - t0))
        del state
    log(f"train steps/s, MiniLM-L6, batch 32 quadruplets, S=128, bf16, dropout 0.1: "
        f"kernel path {rates['kernels']}, nn.Module path with plain loss {rates['module']}")
    return rates


def device_us(event) -> float:
    """A profiler event's own device time in µs (the name varies by torch)."""
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def device_ms(fn, reps: int) -> dict:
    """Device time per call of each kernel ``fn`` runs, from torch.profiler:
    {kernel name: ms per call}. Fails when the profiler saw no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # kernels only: a record_function range (the optimizer's step) also
    # carries device time, which would count its kernels twice
    out = {e.key: device_us(e) / 1e3 / reps for e in prof.key_averages()
           if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
           and not e.key.startswith("Optimizer.")}
    if not out:
        fail("the profiler saw no device kernels")
    return out


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
        parts.append("largest other: " + "; ".join(f"{n[:70]} {ms:.3f} ms" for n, ms in top))
    return ", ".join(parts)


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
        log(f"profile encode {name} B={B} S={S}: {wall:.3f} ms per call, device busy "
            f"{100 * sum(k.values()) / wall:.1f}%: " + shares(k, (
                ("attention", ("attention_kernel",)),
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
    tgen = torch.Generator(device=dev).manual_seed(3)
    for _ in range(2):
        step(state, tids, tmask, tgen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(state, tids, tmask, tgen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    k = device_ms(lambda: step(state, tids, tmask, tgen), 3)
    log(f"profile train step, batch 32 quadruplets, S=128, bf16, dropout 0.1: {wall:.3f} ms "
        f"per step, device busy {100 * sum(k.values()) / wall:.1f}%: " + shares(k, (
            ("attention forward (K1 + K2 recompute)", ("attention_kernel",)),
            ("forward GEMMs (K1 + K2 recompute)", tuple(f"gemm_bf16_kernel<{e}," for e in
                                                        range(4))),
            ("attention backward (K2)", ("attention_bwd_kernel",)),
            ("backward GEMMs (K2: dX and split-K dW)", tuple(f"gemm_bf16_kernel<{e}," for e in
                                                             range(4, 9))),
            ("LayerNorm forward and backward, ordered sums", ("layernorm_kernel",
                                                              "layernorm_bwd_kernel",
                                                              "sum_rows_kernel")),
            ("K3", ("quadruplet_",)),
            ("optimizer (foreach)", ("foreach", "multi_tensor", "MultiTensor")),
            ("library GEMM", ("gemm", "nvjet", "cutlass", "xmma"))), name_other=6))
    del state

    N, D = 1 << 20, 384
    unit = torch.nn.functional.normalize
    corpus = unit(torch.randn((N, D), device=dev), dim=1).to(torch.bfloat16)
    for Q in (8, 64, 256, 4096):
        queries = unit(torch.randn((Q, D), device=dev), dim=1).to(torch.bfloat16)
        wall = cuda_ms(lambda: topk.topk_v2(queries, corpus, 10), 10)
        k = device_ms(lambda: topk.topk_v2(queries, corpus, 10), 5)
        log(f"profile search Q={Q} over 1M x 384 bf16, k=10: {wall:.3f} ms per call, "
            f"device busy {100 * sum(k.values()) / wall:.1f}%: " + shares(k, (
                ("K4", ("bucket_max",)), ("K5", ("rescore_kernel",)))))
    del corpus

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
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
    report = {n: {} for n in ("K1", "K2", "K3", "K4", "K5")}
    for phase, fn in (("check", check_kernels), ("serve", serve), ("train", train),
                      ("times", times), ("profile", profile_phase)):
        if phase in phases:
            t0 = time.perf_counter()
            fn(report)
            log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({k: v for k, v in report.items()
                    if k in ("encode", "search", "train", "train_steps_per_s")}))
    log(json.dumps({"K1_training_layer": {k: report["K1"].get(k) for k in (
        "train_ms", "train_no_dropout_ms", "dropout_max_abs_err")}}))

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
             "qst_tpu/ops/topk_pallas.py:251")):
        r = report[name[:2]]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": r.get("launches"), "max_abs_err": r.get("max_abs_err"),
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms")})
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
