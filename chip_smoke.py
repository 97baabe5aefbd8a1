"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py                          # every phase, one GPU
    python3 chip_smoke.py --phases build,check     # a new kernel's first, short call

Phases (any failure exits non-zero and prints no result):

1. build  — compile qst_tpu_torch/kernels/csrc/*.cu with nvcc (sm_90a).
2. check  — each kernel against its plain PyTorch version on the card at the
   main path's shapes: K1 (fused BERT layer, MiniLM width, f32 and bf16),
   K4 (bucket maxima, f32/bf16/int8, N = 65,536 + 77, with and without
   n_real), K5 (winning-bucket rescore), and topk_v2 against reference_topk.
3. serve  — random-init MiniLM-L6 with use_fused_layer, a bfloat16 Retriever
   over 65,536 synthetic docs (so "auto" search takes K4 + K5), a
   RetrievalServer on port 0 answering concurrent POST /search, POST /encode
   and GET /healthz; answers held against the plain path; every kernel's
   launch count must rise.
4. times  — kernel against plain at the main path's shapes, encode
   sentences/s at B=256, S=128 and search QPS over 1M x 384 bf16, Q=4096.
5. profile — where the time goes: device time per kernel and the device's
   busy share for encode and search, and served req/s with p50/p99 latency
   at 1, 8 and 64 closed-loop clients.

The last lines are the card's name and power limit (nvidia-smi), one JSON
object with a row per kernel, and {"ok": true, "device": {...}}.

Imports torch, numpy, the standard library and qst_tpu_torch only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

PHASES = ("build", "check", "serve", "times", "profile")


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


def times(report: dict) -> None:
    import torch

    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoderModule, embed_fn, init_params
    from qst_tpu_torch.ops import fused_layer as fl
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
    out = {e.key: device_us(e) / 1e3 / reps
           for e in prof.key_averages() if e.device_type.name == "CUDA"}
    if not out:
        fail("the profiler saw no device kernels")
    return out


def shares(kernels: dict, groups) -> str:
    """'label ms (share%)' for each (label, name substrings) group of
    kernels, then the rest, as a share of all device time."""
    total = sum(kernels.values())
    left = dict(kernels)
    parts = []
    for label, keys in groups:
        ms = sum(left.pop(n) for n in list(left) if any(k in n for k in keys))
        parts.append(f"{label} {ms:.3f} ms ({100 * ms / total:.1f}%)")
    rest = sum(left.values())
    parts.append(f"other {rest:.3f} ms ({100 * rest / total:.1f}%)")
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
                ("QKV GEMM", ("gemm_bf16_kernel<0>",)),
                ("FFN-up GELU GEMM", ("gemm_bf16_kernel<1>",)),
                ("out-proj/FFN-down residual GEMMs", ("gemm_bf16_kernel<2>",)),
                ("layernorm", ("layernorm_kernel",)),
                ("library GEMM", ("gemm", "nvjet", "cutlass", "xmma")))))

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
    report = {n: {} for n in ("K1", "K4", "K5")}
    for phase, fn in (("check", check_kernels), ("serve", serve), ("times", times),
                      ("profile", profile_phase)):
        if phase in phases:
            t0 = time.perf_counter()
            fn(report)
            log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({k: v for k, v in report.items() if k in ("encode", "search")}))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    rows = []
    for name, src, replaces in (
            ("K1 fused_bert_layer", "qst_tpu_torch/kernels/csrc/fused_layer.cu",
             "qst_tpu/ops/fused_layer_pallas.py:111"),
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
