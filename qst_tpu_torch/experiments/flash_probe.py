"""Where K7's and K8's time goes on a GPU: builds of `flash_attention.cu`
with one piece removed or changed, each timed in a process of its own, and
`clock64()` ticks by phase.

    python3 -m qst_tpu_torch.experiments.flash_probe [--only base,k7_prof,...]
        [--work _local/flash_probe]        # from a tree's root, on a GPU

Each variant is the package copied under ``--work`` (a directory the
repository's .gitignore lists) with `csrc/flash_attention.cu` edited by text
substitution and only that source (and `topk.cu`, which defines
`qst_error_string`) left to build; every variant builds at once, then each
is timed by a fresh interpreter (two kernel libraries in one process do not
load: each carries its own static CUDA runtime). A variant's results are
garbage where a piece is removed: only its time counts. The times are K7 and
K8 at (64, 12, 512, 32) bf16 on the encoder's activations seen as (B, nh, S,
hd), on padded rows and with every row real; the `*_prof` variants add the
cycles a key block (K7) or a (key block, query tile) pair (K8) a warp spends
in each phase. A substitution that no longer matches the source fails the
run: the variants follow the source they were written against.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import time

B, NH, S, HD = 64, 12, 512, 32

_TICK = ("__device__ unsigned long long fa_prof[132 * 8][8];\n"
         "#define TICK(i) do { unsigned long long t2_ = clock64(); pt[i] += t2_ - t_; "
         "t_ = t2_; } while (0)\n")
_PROF_READ = ('extern "C" int qst_fa_prof(void* out) {\n'
              "  return (int)cudaMemcpyFromSymbol(out, fa_prof, sizeof(fa_prof));\n}\n\n")
_PROF_STORE = ("    if (lane == 0 && blockIdx.x < 132)\n"
               "      for (int i = 0; i < 8; ++i) fa_prof[blockIdx.x * 8 + (tid >> 5)][i] = pt[i];\n")
_PT = "    unsigned long long pt[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_ = clock64();\n"

MMA_HELPERS = """// The B fragments of two neighbouring m16n8k16 n-tiles (nb, nb + 1) for
// k-step k0 .. k0 + 15 of a tile whose rows are the k index, T bytes a row in
// the swizzle of that width (as TMA wrote it): ldmatrix.trans of four 8 x 8
// matrices → {b0, b1} of nb, then of nb + 1.
template <int T>
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&r)[4], uint32_t tile, int k0, int nb,
                                             int lane) {
  const int row = k0 + (lane & 7) + (lane & 8);
  const int ch = nb + (lane >> 4);  // a 16-byte chunk: 8 values along the row
  const uint32_t addr = tile + row * T + ((ch ^ ((row * T >> 7) & (T / 16 - 1))) << 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (a warp's 16 rows x HD, the wgmma accumulator's layout) += a · b on
// mma.sync: a as KS k-steps of A fragments in registers, b the (16·KS, HD)
// tile at `tile` (rows = k). The narrow products (N = hd) go here: a
// m64n32k16 wgmma took ~78 cycles on the card (~220 TFLOP/s), the same
// work on mma.sync a fraction of that.
template <int HD, int KS>
__device__ __forceinline__ void frag_mma(float (&d)[HD / 2], const uint32_t (&a)[KS][4],
                                         uint32_t tile, int lane) {
#pragma unroll
  for (int c = 0; c < KS; ++c)
#pragma unroll
    for (int nb = 0; nb < HD / 8; nb += 2) {
      uint32_t b[4];
      ldsm_b_trans<2 * HD>(b, tile, 16 * c, nb, lane);
      mma_m16n8k16(*reinterpret_cast<float(*)[4]>(&d[4 * nb]), a[c], b[0], b[1]);
      mma_m16n8k16(*reinterpret_cast<float(*)[4]>(&d[4 * nb + 4]), a[c], b[2], b[3]);
    }
}

"""

# name → [(text in flash_attention.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    "k7_noexp": [("s[i] = ex2_approx(fmaf(s[i], c2, -mb[(i >> 1) & 1]));",
                  "s[i] = fmaf(s[i], c2, -mb[(i >> 1) & 1]);")],
    "k7_nosoftmax": [("""        sm.block(s, one_seg && klo == khi && klo == wlo, segk + stage * FA_KB, sq, m, l, keep,
                 inv);""", "        keep[0] = keep[1] = inv[0] = inv[1] = klo == khi ? 1.0f : 0.5f;")],
    "k7_nopv": [("          wgmma_rs<HD, 1>(oc, pa[c], wgmma_desc_sw<T>(vt + 16 * T * c), c > 0);",
                 "          oc[c] = __uint_as_float(pa[c][0]);")],
    "k7_noturn": [("    if (wg == 1) named_barrier_arrive(FW_BAR_TURN, 2 * FW_WG);", ""),
                  ("      named_barrier(FW_BAR_TURN + wg, 2 * FW_WG);", ""),
                  ("      named_barrier_arrive(FW_BAR_TURN + (wg ^ 1), 2 * FW_WG);", "")],
    "k7_notma": [("""          mbar_expect_tx(bar, 4 * L::BOX + FA_KB * 4);
          fa_tma(kd, &map_k, bar, pd, kb * FA_KB, h, b);
          fa_tma(kd + L::BOX, &map_k, bar, pd, kb * FA_KB + FW_BOX, h, b);
          fa_tma(vd, &map_v, bar, pd, kb * FA_KB, h, b);
          fa_tma(vd + L::BOX, &map_v, bar, pd, kb * FA_KB + FW_BOX, h, b);""",
                  "          mbar_expect_tx(bar, FA_KB * 4);")],
    "k7_ieee_div": [("inv[x] = l_next == 0.0f ? 1.0f : recip(l_next);",
                     "inv[x] = l_next == 0.0f ? 1.0f : 1.0f / l_next;")],
    "k7_mma_sync_pv": [
        ("// A fragment of 64 x 64 f32 (k-step c", MMA_HELPERS + "// A fragment of 64 x 64 f32 (k-step c"),
        ("""        const uint32_t vt = base + L::V + cur * 2 * L::BOX;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          wgmma_rs<HD, 1>(oc, pa[c], wgmma_desc_sw<T>(vt + 16 * T * c), c > 0);
        wgmma_commit();""", "        wgmma_commit();"),
        ("        named_barrier_arrive(FW_BAR_TURN + (wg ^ 1), 2 * FW_WG);\n        if (more) {",
         "        named_barrier_arrive(FW_BAR_TURN + (wg ^ 1), 2 * FW_WG);\n"
         "        for (int i = 0; i < HD / 2; ++i) oc[i] = 0.0f;\n"
         "        frag_mma<HD, 8>(oc, pa, base + L::V + cur * 2 * L::BOX, lane);\n"
         "        if (more) {")],
    "adder_pack": [
        ("// A fragment of 64 x 64 f32 (k-step c", """// bf16 RNE on the FP32 adders: x + s - s, s = ±2^(e(x)+16)
__device__ __forceinline__ uint32_t pack_bf16_fma(float lo, float hi) {
  const uint32_t ul = __float_as_uint(lo), uh = __float_as_uint(hi);
  const float sl = __uint_as_float((ul & 0xFF800000u) + 0x08000000u);
  const float sh = __uint_as_float((uh & 0xFF800000u) + 0x08000000u);
  const uint32_t rl = __float_as_uint(__fsub_rn(__fadd_rn(lo, sl), sl)) | (ul & 0x80000000u);
  const uint32_t rh = __float_as_uint(__fsub_rn(__fadd_rn(hi, sh), sh)) | (uh & 0x80000000u);
  return __byte_perm(rl, rh, 0x7632);
}

// A fragment of 64 x 64 f32 (k-step c"""),
        ("for (int r = 0; r < 4; ++r) pa[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);",
         "for (int r = 0; r < 4; ++r) pa[c][r] = pack_bf16_fma(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);"),
        ("for (int r = 0; r < 4; ++r) a[c][r] = pack_bf16(d[8 * c + 2 * r], d[8 * c + 2 * r + 1]);",
         "for (int r = 0; r < 4; ++r) a[c][r] = pack_bf16_fma(d[8 * c + 2 * r], d[8 * c + 2 * r + 1]);")],
    "k8_noexp": [("                const float p = ex2_approx(ex[c][x]) * ri[c];",
                  "                const float p = ex[c][x] * ri[c];")],
    "k8_nodq": [("            wgmma_ss<HD, 1, 1>(dqp, wgmma_desc_sw<128>(gt + 2048 * c),",
                 "            if (c < 0) wgmma_ss<HD, 1, 1>(dqp, wgmma_desc_sw<128>(gt + 2048 * c),")],
    "k8_notma": [("""            mbar_expect_tx(bar, 2 * L::BOX + BW_TSTAT * 4);
            fa_tma(base + L::Q + qs * L::BOX, &map_q, bar, pd, i * BW_Q, h, b);
            fa_tma(base + L::D + qs * L::BOX, &map_do, bar, pd, i * BW_Q, h, b);""",
                  "            mbar_expect_tx(bar, BW_TSTAT * 4);")],
    "k7_prof": [
        ("// K7's online softmax", _TICK + "// K7's online softmax"),
        ("""    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
    const FwdSoftmax sm""", _PT + """    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
    const FwdSoftmax sm"""),
        ("      mbar_wait(q_full, n & 1);\n", "      mbar_wait(q_full, n & 1);\n      TICK(0);\n"),
        ("      named_barrier(FW_BAR_TURN + wg, 2 * FW_WG);\n      mbar_wait(full",
         "      named_barrier(FW_BAR_TURN + wg, 2 * FW_WG);\n      TICK(1);\n      mbar_wait(full"),
        ("        named_barrier(FW_BAR_TURN + wg, 2 * FW_WG);\n        if (more) mbar_wait(full + 8 * stage, phase);",
         "        TICK(7);\n        named_barrier(FW_BAR_TURN + wg, 2 * FW_WG);\n        TICK(1);\n"
         "        if (more) mbar_wait(full + 8 * stage, phase);\n        TICK(2);"),
        ("        named_barrier_arrive(FW_BAR_TURN + (wg ^ 1), 2 * FW_WG);\n        if (more) {",
         "        named_barrier_arrive(FW_BAR_TURN + (wg ^ 1), 2 * FW_WG);\n        TICK(3);\n        if (more) {"),
        ("          wgmma_wait<1>();  // s of the next block; p·v of this one may still run",
         "          wgmma_wait<1>();\n          TICK(4);"),
        ("          softmax();\n        }\n        wgmma_wait<0>();",
         "          softmax();\n          TICK(5);\n        }\n        wgmma_wait<0>();\n        TICK(6);"),
        ("      store_frag_bf16<HD>(o + lay.head(b, h), lay.ss, acc, row0, lane);",
         "      TICK(6);\n      store_frag_bf16<HD>(o + lay.head(b, h), lay.ss, acc, row0, lane);"),
        ("""    }
  }
}

// ---------------------------------------------------------------------------
// K8, bf16: the statistics pre-pass""", "    }\n" + _PROF_STORE + """  }
}

""" + _PROF_READ + """// ---------------------------------------------------------------------------
// K8, bf16: the statistics pre-pass""")],
    "k8_prof": [
        ("// K7's online softmax", _TICK + "// K7's online softmax"),
        ("    float* acc_smem = reinterpret_cast<float*>(gbase + L::ACC);",
         _PT + "    float* acc_smem = reinterpret_cast<float*>(gbase + L::ACC);"),
        ("          wgmma_wait<0>();  // sᵀ and dPᵀ of this tile", "          wgmma_wait<0>();\n          TICK(0);"),
        ("          uint32_t pa[4][4], da[4][4];", "          TICK(1);\n          uint32_t pa[4][4], da[4][4];"),
        ("          fence_proxy_async();\n          wgmma_fence();",
         "          fence_proxy_async();\n          TICK(2);\n          wgmma_fence();"),
        ("          named_barrier(BW_BAR_STAGED + wg, FW_WG);  // the warpgroup's dSᵀ is written",
         "          TICK(3);\n          named_barrier(BW_BAR_STAGED + wg, FW_WG);\n          TICK(4);"),
        ("          // the next tile's sᵀ and dPᵀ run while this tile's dQ is summed", "          TICK(5);"),
        ("          warp_arrive(q_empty + 8 * cs, lane);", "          warp_arrive(q_empty + 8 * cs, lane);\n          TICK(6);"),
        ("              *pp = v;\n            }\n        }\n", "              *pp = v;\n            }\n          TICK(7);\n        }\n"),
        ("      named_barrier(BW_BAR_DQ, 2 * FW_WG);  // the sums may be overwritten\n    }\n",
         "      named_barrier(BW_BAR_DQ, 2 * FW_WG);  // the sums may be overwritten\n    }\n" + _PROF_STORE),
        ("// The bytes of qst_flash_backward's scratch", _PROF_READ + "// The bytes of qst_flash_backward's scratch")],
}
PROF_PHASES = {
    "k7_prof": ("q_full wait + epilogue", "turn", "full wait", "issue s and p·v", "wait s", "softmax",
                "wait p·v + update", "pack"),
    "k8_prof": ("wait sᵀ/dPᵀ", "exponentials", "pack + stage dSᵀ", "issue dV/dK", "staged barrier",
                "issue dQ", "next sᵀ/dPᵀ + wait", "dQ sum"),
}


def _time_here(name: str) -> None:
    """In a variant's tree: time K7 and K8 (and read the profile)."""
    import torch

    from qst_tpu_torch.kernels import build
    from qst_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(5)
    sc = HD ** -0.5
    q, k, v, do = (torch.randn((B, S, NH, HD), generator=gen).to("cuda", torch.bfloat16)
                   .transpose(1, 2) for _ in range(4))
    lens = torch.randint(S // 4, S + 1, (B,), generator=gen)
    lens[0], lens[1], lens[2] = S, 2 * S // 3, 0
    segs = {"padded": (torch.arange(S)[None, :] < lens[:, None]).to(torch.int32).cuda(),
            "real": torch.ones((B, S), dtype=torch.int32, device="cuda")}

    def ms(fn, reps=20):
        for _ in range(3):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    out = []
    for kind, seg in segs.items():
        o, m, l = fa.flash_attention(q, k, v, seg, seg, sc, return_stats=True)
        t7 = ms(lambda: fa.flash_attention(q, k, v, seg, seg, sc))
        t8 = ms(lambda: fa.flash_attention_bwd(q, k, v, seg, seg, o, m, l, do, sc))
        out.append(f"{kind}: K7 {t7:.4f} K8 {t8:.4f} ms")
    print(f"{name:15s} " + "   ".join(out), flush=True)
    if name in PROF_PHASES:
        import numpy as np

        seg = segs["real"]
        o, m, l = fa.flash_attention(q, k, v, seg, seg, sc, return_stats=True)
        if name == "k8_prof":
            fa.flash_attention_bwd(q, k, v, seg, seg, o, m, l, do, sc)
        torch.cuda.synchronize()
        buf = np.zeros((132 * 8, 8), np.uint64)
        lib = build.load()
        lib.qst_fa_prof.argtypes = [ctypes.c_void_p]
        assert lib.qst_fa_prof(buf.ctypes.data) == 0
        per = B * NH * (S // 128) * (S // (128 if name == "k7_prof" else 64)) / 132
        cyc = buf.astype(np.float64).mean(0) / per
        what = "a key block" if name == "k7_prof" else "a (key block, query tile) pair"
        print(f"  cycles {what} a warp, all rows real: "
              + ", ".join(f"{p} {c:.0f}" for p, c in zip(PROF_PHASES[name], cyc)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(VARIANTS))
    ap.add_argument("--work", default="_local/flash_probe")
    ap.add_argument("--time_variant", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_variant:
        _time_here(args.time_variant)
        return
    from qst_tpu_torch.kernels import build

    names = args.only.split(",")
    src = (build.CSRC / "flash_attention.cu").read_text()
    pkg = build.CSRC.parent.parent
    work = os.path.abspath(args.work)
    shutil.rmtree(work, ignore_errors=True)
    for name in names:
        text = src
        for a, b in VARIANTS[name]:
            if a not in text:
                raise SystemExit(f"variant {name}: its text is not in flash_attention.cu: {a[:60]!r}")
            text = text.replace(a, b)
        shutil.copytree(pkg, os.path.join(work, name, "qst_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        csrc = os.path.join(work, name, "qst_tpu_torch", "kernels", "csrc")
        for f in os.listdir(csrc):
            if f.endswith(".cu") and f not in ("flash_attention.cu", "topk.cu"):
                os.remove(os.path.join(csrc, f))
        with open(os.path.join(csrc, "flash_attention.cu"), "w") as f:
            f.write(text)
    t0 = time.perf_counter()
    env = {n: {**os.environ, "PYTHONPATH": os.path.join(work, n)} for n in names}
    builds = {n: subprocess.Popen([sys.executable, "-c", "from qst_tpu_torch.kernels import build; "
                                   "build.load()"], cwd=os.path.join(work, n), env=env[n],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for n in names}
    for n, p in builds.items():
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {n} did not build:\n{err[-3000:]}")
    print(f"{len(names)} variants built in {time.perf_counter() - t0:.1f} s", flush=True)
    me = os.path.abspath(__file__)
    for rnd in range(2):
        for n in names:
            r = subprocess.run([sys.executable, me, "--time_variant", n], cwd=os.path.join(work, n),
                               env=env[n], capture_output=True, text=True)
            if r.returncode:
                raise SystemExit(f"variant {n} failed:\n{r.stderr[-3000:]}")
            print(r.stdout.rstrip(), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
