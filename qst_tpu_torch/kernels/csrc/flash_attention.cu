// K7 and K8: flash attention with segment ids, forward and backward.
//
// Replaces JAX's library kernel behind `EncoderConfig.use_flash_attention`
// (qst_tpu/models/bert.py:87-101 calls
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention): K7 its
// forward (`_flash_attention_kernel_single_batch` and `..._single_step`,
// pallas_call at flash_attention.py:758); K8 its backward (the dK/dV kernel,
// pallas_call :1121, the dQ kernel, :1456, and di = Σ o·dO, computed in XLA
// at :254-275).
//
// The function, the library's (flash_attention.py:400-560):
//   s = (q·kᵀ in f32)·sm_scale + (seg_q[i] == seg_kv[j] ? 0 : mask_value),
//   mask_value = -0.7·FLT_MAX, keys in blocks of 128 (the library's block_k).
//   One block (S = 128): p = e^(s-m) / l, cast to v's dtype, o = p·v.
//   More: online softmax, p = e^(s - m_next) UNNORMALISED, cast to v's dtype;
//   acc = acc·(α·l_prev / l_next) + (p·v)·(1/l_next), the accumulator kept
//   normalised after every block (:453-473). The output is in q's dtype;
//   (m, l) of every row are saved for the backward, in natural-log units.
// Backward (:820-905, :1177-1255): p = e^(s - m)·(1/l); dV = pᵀ(as dO's
// dtype)·dO; dP = dO·vᵀ; dS = ((dP - di)∘p)·sm_scale; dK = dSᵀ(as dO's
// dtype)·q; dQ = dS(as k's dtype)·k. A padded query row (segment 0) attends
// to the padded keys only, and its gradient flows there.
//
// Rounding points of the bf16 kernels against the library's: e^x is
// ex2.approx(x·log2 e). Where a warp's 16 rows (keys, in the backward) and
// a key block (query tile) share one segment, the mask adds exactly +0 and
// is skipped, and the exponent is one FFMA, s·(sm_scale·log2 e) - m·log2 e,
// with the row maximum taken over the raw s (fl(s·sm_scale) is monotone in
// s, so m is the library's bit for bit). Elsewhere s·sm_scale + mask is
// rounded as the library rounds it and e^(z - m) is ex2((z - m)·log2 e).
// Either way p moves by a few f32 ulp (≈ 1e-6 relative) before its bf16
// cast; ex2.approx flushes results below 2^-126 to zero. K7's 1/l_next is
// rcp.approx with a Newton step (within an ulp of the IEEE quotient), and
// the one-block forward's p / l is p·(1/l), one more f32 ulp. Everything
// else — the block of 128 keys, the order of the accumulator's update,
// (m, l), dS — is as above. The f32 (SIMT) twins keep expf and the
// division: they are the comparison path that holds 1e-4.
//
// What bounds it at the main path's shapes (12 heads of 32, S = 512, bf16):
// per (sequence, head) two products of S x S x hd forward and five backward
// (4·S²·hd and 10·S²·hd operations) against 4 and 8 rows of S·hd bf16 —
// 0.031 / 0.065 ms at B = 64 by the tensor rate. Every logit also needs an
// exponential on the special-function pipe (16 lanes a cycle an SM, ≈ 3.9
// T/s: ≥ 0.052 ms forward) and its bf16 conversion. Measured on the card
// (builds with pieces removed, and clock64 ticks by phase), neither that
// pipe nor the copies is what holds the kernels: it is each warpgroup's
// sequence of waits and issue slots at two consumer warpgroups an SM — the
// narrow products (a m64n32k16 wgmma took ~80 cycles to issue), the softmax
// and the turns take their turn in it. The design keeps one exponential a
// logit, the per-logit work to a few instructions, and the copies and the
// products asynchronous:
// - Products on wgmma, operands fed by TMA: q, k, v, o, dO are (B, nh, S, hd)
//   views, 4-D tensor maps over (hd, and the three other axes by stride),
//   boxes of 64 rows in the swizzle of the row's width (32, 64 or 128 B at
//   hd 16, 32, 64), read by wgmma where TMA put them; the segment ids come
//   with them as bulk copies.
// - Warp-specialised, 384 threads: one producer thread keeps the rings full
//   (its warpgroup hands its registers to the consumers with setmaxnreg), two
//   consumer warpgroups of 64 rows compute; a consumer warp releases a stage
//   with one arrival.
// - K7: persistent (a block an SM), items of 128 query rows of one
//   (sequence, head), q tiles fastest so that neighbouring blocks share k
//   and v in L2. A ring of three key/value blocks (128 keys each). S = q·kᵀ
//   is wgmma m64n128k16 (q and k K-major); the online softmax runs on the
//   accumulator in registers; p, rounded to bf16 pairs in place, is the A
//   operand of o += p·v (m64n{hd}k16, A from registers, v through the
//   transpose bit). The warpgroups take turns at issuing (named barriers),
//   a turn issues the next block's S with this block's p·v, and the next
//   block's softmax runs while p·v is in flight. (p·v on mma.sync through
//   ldmatrix.trans measured slower on the card: 0.184 against 0.160 ms.)
// - K8: a pre-pass writes, per 64 query rows, di = Σ o·dO (16-byte loads)
//   with m·log2 e, 1/l, m and the segment ids, in the order in which the
//   accumulator fragment's columns meet them, and whether the 64 share one
//   segment. Then, persistent, a block takes one (sequence, head) at a time
//   and walks its key blocks of 128 (two of 64, one a warpgroup) in order,
//   each over all query tiles of 64 (ring of three: q, dO and the tile's
//   statistics, which every thread reads as float4s once a tile). Per tile
//   and warpgroup: Sᵀ = k·qᵀ and dPᵀ = v·dOᵀ (m64n64k16, operands in shared
//   memory), then ONE exponential a logit for pᵀ and dSᵀ, which as bf16
//   register pairs are the A operands of dV += pᵀ·dO and dK += dSᵀ·q
//   (transpose bit on dO and q). dSᵀ is also written to a 128-byte-swizzled
//   tile of shared memory whose transposed reading is dS, the A operand of
//   dQ's part; the next tile's Sᵀ and dPᵀ are issued before this tile's
//   products are waited for. Five products and one exponential a logit, and
//   nothing (S, S) reaches device memory.
// - dQ's sum over key blocks: each warpgroup sums its part (its 64 keys) in
//   key-block order into a (S, hd) f32 array of its own — in shared memory
//   when both fit beside the rings (2·S·hd·4 bytes: S ≤ 512 at hd 32), else
//   in the caller's scratch, which only this block touches — and the two
//   are added once a (sequence, head) and written as bf16. No atomics, no
//   hand-off between warpgroups inside the sweep: two calls give the same
//   bits. (Measured on the card at B = 64: 0.342 ms, against 0.405 for the
//   two warpgroups adding to one array in turns and 0.452 for one
//   warpgroup owning each query tile's dQ.)
//
// Launch configuration: strides (sb, sh, ss) in elements of the (b, h, s)
// axes, shared by q, k, v, o, dO, dQ, dK, dV; d contiguous; bf16 rows and
// strides 16-byte multiples. The seg ids are (B, S) int32, the statistics
// (2, B, nh, S) f32 [m, l]; K8's scratch is qst_flash_backward_scratch_bytes.
#include <algorithm>

#include "attention_kb.cuh"

namespace qst {

constexpr int FA_KB = 128;      // the library's block_k (the bf16 rounding of the
                                // unnormalised p depends on it): K7's key block
constexpr int FS_Q = 32;        // f32: query (or key) rows of a block
constexpr int FS_BWD = 32;      // f32 K8: the walk's step
constexpr int FS_THREADS = 256;
// bf16 (wgmma)
constexpr int FW_WG = 128;               // threads of a warpgroup
constexpr int FW_THREADS = 3 * FW_WG;    // two consumer warpgroups, then the producer's
constexpr int FW_WARPS = 2 * FW_WG / 32; // consumer warps: one arrival each frees a stage
constexpr int FW_BOX = 64;               // rows of a TMA box and of a consumer warpgroup
constexpr int FW_Q = 2 * FW_BOX;         // K7: query rows of an item
constexpr int FW_STAGES = 3;             // K7: key/value blocks in flight
constexpr int FW_BAR_TURN = 1;           // + warpgroup: its turn at issuing products
constexpr int BW_Q = 64;                 // K8: query rows of a ring stage
constexpr int BW_QSTAGES = 3, BW_KVSTAGES = 2;
// K8: a query tile's statistics: m·log2 e, 1/l, di, m, seg (64 each, in the
// fragment's column order), then [one segment?, that segment, 0, 0]
constexpr int BW_TSTAT = 5 * BW_Q + 4;
constexpr int BW_BAR_STAGED = 1;         // + warpgroup: its dSᵀ tile is written
constexpr int BW_BAR_DQ = 3;             // both warpgroups' dQ sums are complete / read
constexpr float LOG2E = 1.4426950408889634f;

struct FaLayout {
  long long sb, sh, ss;  // element strides of the batch, head and sequence axes
  __device__ __forceinline__ size_t head(int b, int h) const {
    return (size_t)b * sb + (size_t)h * sh;
  }
};

// the additive segment mask of one logit
__device__ __forceinline__ float seg_bias(int a, int b, float mask_value) {
  return a == b ? 0.0f : mask_value;
}

// ---------------------------------------------------------------------------
// bf16: TMA and fragments
// ---------------------------------------------------------------------------
// The map dimension (1..3) of the sequence, head and batch axes: the three
// sorted by stride, smallest first, so the maps' strides grow outward
struct FaDims {
  int s, h, b;
};

// A consumer warp is done with a stage: one arrival for its 32 lanes (an
// arrival is an atomic on one shared word; 256 a stage serialise)
__device__ __forceinline__ void warp_arrive(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// one 64-row box of (sequence b, head h) from row `row` into dst
__device__ __forceinline__ void fa_tma(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       FaDims pd, int row, int h, int b) {
  const int c1 = pd.s == 1 ? row : pd.h == 1 ? h : b;
  const int c2 = pd.s == 2 ? row : pd.h == 2 ? h : b;
  const int c3 = pd.s == 3 ? row : pd.h == 3 ? h : b;
  tma_load_4d(dst, map, bar, 0, c1, c2, c3);
}

// A 64 x HD accumulator fragment (a warp's 16 rows from row0) as bf16, 8
// bytes a store
template <int HD>
__device__ __forceinline__ void store_frag_bf16(bf16* dst, long long ld, const float (&d)[HD / 2],
                                                int row0, int lane) {
  const int r = row0 + (lane >> 2) + ((lane & 1) << 3);
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
    float e[4];
    quad_regroup(d[4 * nb], d[4 * nb + 1], d[4 * nb + 2], d[4 * nb + 3], lane, e);
    store_bf16x4(dst + (size_t)r * ld + nb * 8 + ((lane & 2) << 1), e);
  }
}

// A fragment of 64 x 64 f32 (k-step c: columns 16c .. 16c + 15) as the
// bf16 A operand of the next product
__device__ __forceinline__ void pack_frag_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[c][r] = pack_bf16(d[8 * c + 2 * r], d[8 * c + 2 * r + 1]);
}

// ---------------------------------------------------------------------------
// K7, bf16
// ---------------------------------------------------------------------------
// 1/x, x a row sum (≥ 1), without the IEEE division, whose slow path is a
// subroutine call (taking it out moved K7 from 0.177 to 0.160 ms on the
// card). rcp.approx and one Newton step: within an ulp of the quotient.
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// K7's online softmax over one key block of a warpgroup's 64 x 128 logits
// (the m64n128 fragment: this thread's rows r0, r0 + 8, columns 8j + 2t + e)
struct FwdSoftmax {
  float scale, c2, mask_value;  // c2 = scale·log2 e
  bool positive;                // scale > 0: the raw maximum is the scaled one's
  int t;
  // s (raw q·kᵀ) → p = e^(s·scale + mask - m_next), unnormalised; (m, l)
  // → the block's; keep = l_corr / l_next and inv = 1 / l_next for the
  // accumulator. `clean`: every row and key of the block in one segment
  __device__ __forceinline__ void block(float (&s)[64], bool clean, const int* sk,
                                        const int (&sq)[2], float (&m)[2], float (&l)[2],
                                        float (&keep)[2], float (&inv)[2]) const {
    float mx[2] = {-INFINITY, -INFINITY};
    clean = clean && positive;
    if (clean) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx[0] = quad_max(mx[0]) * scale;
      mx[1] = quad_max(mx[1]) * scale;
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int2 kc = *reinterpret_cast<const int2*>(sk + 8 * j + 2 * t);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float& z0 = s[4 * j + 2 * x];
          float& z1 = s[4 * j + 2 * x + 1];
          z0 = __fadd_rn(__fmul_rn(z0, scale), seg_bias(sq[x], kc.x, mask_value));
          z1 = __fadd_rn(__fmul_rn(z1, scale), seg_bias(sq[x], kc.y, mask_value));
          mx[x] = fmaxf(mx[x], fmaxf(z0, z1));
        }
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
    }
    float m_next[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 2; ++x) m_next[x] = fmaxf(m[x], mx[x]);
    if (clean) {
      const float mb[2] = {m_next[0] * LOG2E, m_next[1] * LOG2E};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = ex2_approx(fmaf(s[i], c2, -mb[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += s[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = ex2_approx(__fmul_rn(__fsub_rn(s[i], m_next[(i >> 1) & 1]), LOG2E));
        sum[(i >> 1) & 1] += s[i];
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float l_corr = ex2_approx(__fmul_rn(__fsub_rn(m[x], m_next[x]), LOG2E)) * l[x];
      const float l_next = quad_sum(sum[x]) + l_corr;
      inv[x] = l_next == 0.0f ? 1.0f : recip(l_next);
      keep[x] = l_corr * inv[x];
      m[x] = m_next[x];
      l[x] = l_next;
    }
  }
};

template <int HD>
struct FwdSmem {
  static constexpr int T = HD * 2;                  // bytes of a row
  static constexpr int BOX = FW_BOX * T;
  static constexpr int Q = 0;                       // two boxes
  static constexpr int K = Q + 2 * BOX;             // [FW_STAGES][two boxes]
  static constexpr int V = K + FW_STAGES * 2 * BOX;
  static constexpr int SEGK = V + FW_STAGES * 2 * BOX;       // [FW_STAGES][FA_KB] int
  static constexpr int SEGQ = SEGK + FW_STAGES * FA_KB * 4;  // [FW_Q] int
  static constexpr int BAR = SEGQ + FW_Q * 4;       // q_full, q_empty, full[], empty[]
  static constexpr int BYTES = BAR + (2 + 2 * FW_STAGES) * 8 + 1024;  // + aligning the base
};

template <int HD>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, const int* __restrict__ seg_q,
                       const int* __restrict__ seg_kv, bf16* __restrict__ o,
                       float* __restrict__ stats, int B, int nh, int S, FaLayout lay, FaDims pd,
                       float scale, float mask_value) {
  using L = FwdSmem<HD>;
  constexpr int T = L::T;
  extern __shared__ unsigned char fa_smem[];
  const uint32_t base = (smem_u32(fa_smem) + 1023u) & ~1023u;
  unsigned char* gbase = fa_smem + (base - smem_u32(fa_smem));
  const int* segk = reinterpret_cast<const int*>(gbase + L::SEGK);
  const int* segq = reinterpret_cast<const int*>(gbase + L::SEGQ);
  const uint32_t q_full = base + L::BAR, q_empty = q_full + 8, full = q_full + 16,
                 empty = full + 8 * FW_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, FW_WARPS);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, FW_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int nkb = S / FA_KB, nqt = S / FW_Q, items = B * nh * nqt;

  if (tid >= 2 * FW_WG) {
    // ---- producer: one thread issues every copy; the segment ids of the
    // item's rows and of each key block come with q and the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 2 * FW_WG) {
      int stage = 0, n = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int qt = item % nqt, bh = item / nqt, h = bh % nh, b = bh / nh;
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * L::BOX + FW_Q * 4);
        fa_tma(base + L::Q, &map_q, q_full, pd, qt * FW_Q, h, b);
        fa_tma(base + L::Q + L::BOX, &map_q, q_full, pd, qt * FW_Q + FW_BOX, h, b);
        bulk_load(base + L::SEGQ, seg_q + (size_t)b * S + qt * FW_Q, FW_Q * 4, q_full);
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1u);
          const uint32_t bar = full + 8 * stage;
          const uint32_t kd = base + L::K + stage * 2 * L::BOX;
          const uint32_t vd = base + L::V + stage * 2 * L::BOX;
          mbar_expect_tx(bar, 4 * L::BOX + FA_KB * 4);
          fa_tma(kd, &map_k, bar, pd, kb * FA_KB, h, b);
          fa_tma(kd + L::BOX, &map_k, bar, pd, kb * FA_KB + FW_BOX, h, b);
          fa_tma(vd, &map_v, bar, pd, kb * FA_KB, h, b);
          fa_tma(vd + L::BOX, &map_v, bar, pd, kb * FA_KB + FW_BOX, h, b);
          bulk_load(base + L::SEGK + stage * FA_KB * 4, seg_kv + (size_t)b * S + kb * FA_KB,
                    FA_KB * 4, bar);
          if (++stage == FW_STAGES) stage = 0, phase ^= 1u;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes rows 64·wg .. + 63 of every item.
    // The two take turns at issuing products (named barriers), so that one's
    // softmax runs while the other's products do; a turn issues S of the
    // next key block with p·v of this one, and the softmax of the next block
    // runs while p·v is still in flight.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
    const FwdSoftmax sm{scale, scale * LOG2E, mask_value, scale > 0.0f, t};
    const uint32_t qa = base + L::Q + wg * L::BOX;
    int stage = 0, n = 0;
    uint32_t phase = 0;
    if (wg == 1) named_barrier_arrive(FW_BAR_TURN, 2 * FW_WG);  // warpgroup 0 goes first
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const int qt = item % nqt, bh = item / nqt, h = bh % nh, b = bh / nh;
      const int row0 = qt * FW_Q + wg * FW_BOX + warp * 16;  // the warp's 16 rows
      const int r0 = row0 + (lane >> 2);                       // this thread's: r0, r0 + 8
      int sq[2], wlo;   // the rows' segments and their least; all one segment?
      bool one_seg;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, keep[2], inv[2];
      float acc[HD / 2], s[64];
      uint32_t pa[8][4];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
      // s of the key block in `stage` (its softmax follows)
      auto issue_s = [&] {
        const uint32_t kt = base + L::K + stage * 2 * L::BOX;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_m64n128k16<0, 0>(s, wgmma_desc_sw<T>(qa + 32 * kk),
                                 wgmma_desc_sw<T>(kt + 32 * kk), kk > 0);
        wgmma_commit();
      };
      // the softmax of the block in `stage`: s → p in place, (m, l) updated;
      // `clean` where the warp's rows and the block's keys share one segment
      auto softmax = [&] {
        const int4 kv = *reinterpret_cast<const int4*>(segk + stage * FA_KB + 4 * lane);
        const int klo = __reduce_min_sync(~0u, min(min(kv.x, kv.y), min(kv.z, kv.w)));
        const int khi = __reduce_max_sync(~0u, max(max(kv.x, kv.y), max(kv.z, kv.w)));
        sm.block(s, one_seg && klo == khi && klo == wlo, segk + stage * FA_KB, sq, m, l, keep,
                 inv);
        if (nkb == 1) {  // the library's single-step kernel: p / l before the cast
#pragma unroll
          for (int i = 0; i < 64; ++i) s[i] *= inv[(i >> 1) & 1];
        }
      };
      mbar_wait(q_full, n & 1);
      sq[0] = segq[r0 - qt * FW_Q];
      sq[1] = segq[r0 + 8 - qt * FW_Q];
      wlo = __reduce_min_sync(~0u, min(sq[0], sq[1]));
      one_seg = wlo == __reduce_max_sync(~0u, max(sq[0], sq[1]));
      named_barrier(FW_BAR_TURN + wg, 2 * FW_WG);
      mbar_wait(full + 8 * stage, phase);
      wgmma_fence();
      issue_s();
      named_barrier_arrive(FW_BAR_TURN + (wg ^ 1), 2 * FW_WG);
      wgmma_wait<0>();
      if (nkb == 1) warp_arrive(q_empty, lane);  // the next item's q may load
      softmax();
      for (int kb = 0; kb < nkb; ++kb) {
        const int cur = stage;
        const bool more = kb + 1 < nkb;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
        const float keep_kb[2] = {keep[0], keep[1]}, inv_kb[2] = {inv[0], inv[1]};
        if (++stage == FW_STAGES) stage = 0, phase ^= 1u;
        float oc[HD / 2];
        named_barrier(FW_BAR_TURN + wg, 2 * FW_WG);
        if (more) mbar_wait(full + 8 * stage, phase);
        wgmma_fence();
        if (more) issue_s();
        const uint32_t vt = base + L::V + cur * 2 * L::BOX;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          wgmma_rs<HD, 1>(oc, pa[c], wgmma_desc_sw<T>(vt + 16 * T * c), c > 0);
        wgmma_commit();
        named_barrier_arrive(FW_BAR_TURN + (wg ^ 1), 2 * FW_WG);
        if (more) {
          wgmma_wait<1>();  // s of the next block; p·v of this one may still run
          if (kb + 2 == nkb) warp_arrive(q_empty, lane);
          softmax();
        }
        wgmma_wait<0>();
        warp_arrive(empty + 8 * cur, lane);
        if (nkb == 1) {
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) acc[i] = oc[i];
        } else {
#pragma unroll
          for (int i = 0; i < HD / 2; ++i)
            acc[i] = acc[i] * keep_kb[(i >> 1) & 1] + oc[i] * inv_kb[(i >> 1) & 1];
        }
      }
      store_frag_bf16<HD>(o + lay.head(b, h), lay.ss, acc, row0, lane);
      if (t == 0) {
        const size_t N = (size_t)B * nh * S, i0 = ((size_t)b * nh + h) * S;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          stats[i0 + r0 + 8 * x] = m[x];
          stats[N + i0 + r0 + 8 * x] = l[x];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K8, bf16: the statistics pre-pass, then the key-block sweep
// ---------------------------------------------------------------------------
// A warpgroup's dQ sum, (S, HD) f32 in pairs: pair `slot` of row `row` lies
// at slot ^ 4·(a row bit), so that a warp's 8-byte accesses (8 rows x 4
// neighbouring pairs) meet every bank once a half-warp with no padding
template <int HD>
__device__ __forceinline__ int dq_at(int row, int slot) {
  const int swz = HD == 16 ? ((row >> 1) & 1) << 2 : (row & 3) << 2;
  return row * HD + 2 * (slot ^ swz);
}

// a tile's row r → its place: the fragment column 8·jj + 2·t + e lies at
// 16·t + 2·jj + e, so a thread reads its 16 columns as four float4
__device__ __forceinline__ int tstat_pos(int r) {
  return ((r >> 1) & 3) * 16 + (r >> 3) * 2 + (r & 1);
}

// grid (S / 64, nh, B), 256 threads: four a row
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const int* __restrict__ seg_q, const float* __restrict__ stats,
                      float* __restrict__ tstats, int S, FaLayout lay) {
  __shared__ int lo_s[8], hi_s[8];
  constexpr int PER = HD / 4;
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y, nqt = gridDim.x;
  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3, lane = tid & 31, warp = tid >> 5;
  const int row = i * BW_Q + r;
  const size_t off = lay.head(b, h) + (size_t)row * lay.ss + sub * PER;
  float di = 0.0f;
#pragma unroll
  for (int c = 0; c < PER; c += 4) {
    float e[4], f[4];
    load_bf16x4(o + off + c, e);
    load_bf16x4(dout + off + c, f);
#pragma unroll
    for (int x = 0; x < 4; ++x) di = fmaf(e[x], f[x], di);
  }
  di += __shfl_xor_sync(0xffffffffu, di, 1);
  di += __shfl_xor_sync(0xffffffffu, di, 2);
  const int sg = seg_q[(size_t)b * S + row];
  const int lo = __reduce_min_sync(~0u, sg), hi = __reduce_max_sync(~0u, sg);
  if (lane == 0) lo_s[warp] = lo, hi_s[warp] = hi;
  float* out = tstats + (((size_t)b * nh + h) * nqt + i) * BW_TSTAT;
  if (sub == 0) {
    const size_t N = (size_t)gridDim.z * nh * S, ri = ((size_t)b * nh + h) * S + row;
    const float m = stats[ri], l = stats[N + ri];
    const int p = tstat_pos(r);
    out[p] = m * LOG2E;
    out[BW_Q + p] = 1.0f / l;
    out[2 * BW_Q + p] = di;
    out[3 * BW_Q + p] = m;
    out[4 * BW_Q + p] = __int_as_float(sg);
  }
  __syncthreads();
  if (tid == 0) {
    int a = lo_s[0], z = hi_s[0];
    for (int w = 1; w < 8; ++w) a = min(a, lo_s[w]), z = max(z, hi_s[w]);
    *reinterpret_cast<int4*>(out + 5 * BW_Q) = make_int4(a == z, a, 0, 0);
  }
}

template <int HD>
struct BwdSmem {
  static constexpr int T = HD * 2;
  static constexpr int BOX = FW_BOX * T;
  static constexpr int K = 0;                                   // [KVSTAGES][two boxes]
  static constexpr int V = K + BW_KVSTAGES * 2 * BOX;
  static constexpr int Q = V + BW_KVSTAGES * 2 * BOX;            // [QSTAGES][one box]
  static constexpr int D = Q + BW_QSTAGES * BOX;                 // dO, the same
  static constexpr int G = D + BW_QSTAGES * BOX;                 // dSᵀ: [warpgroup][2][8 KB]
  static constexpr int TS = G + 4 * 8192;                        // [QSTAGES][BW_TSTAT] f32
  static constexpr int SEGK = TS + BW_QSTAGES * BW_TSTAT * 4;    // [KVSTAGES][FA_KB] int
  static constexpr int BAR = SEGK + BW_KVSTAGES * FA_KB * 4;     // kv_full/empty, q_full/empty
  static constexpr int ACC = BAR + 2 * (BW_KVSTAGES + BW_QSTAGES) * 8;  // dQ's sums, if they fit
  static size_t bytes(int S, bool acc_in_smem) {
    return ACC + (acc_in_smem ? (size_t)2 * S * HD * 4 : 0) + 1024;
  }
};

template <int HD>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do, const int* __restrict__ seg_kv,
                       const float* __restrict__ tstats, float* __restrict__ dq_acc,
                       bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                       int nh, int S, FaLayout lay, FaDims pd, float scale, float mask_value) {
  using L = BwdSmem<HD>;
  constexpr int T = L::T;
  extern __shared__ unsigned char fa_smem[];
  const uint32_t base = (smem_u32(fa_smem) + 1023u) & ~1023u;
  unsigned char* gbase = fa_smem + (base - smem_u32(fa_smem));
  const uint32_t kv_full = base + L::BAR, kv_empty = kv_full + 8 * BW_KVSTAGES;
  const uint32_t q_full = kv_empty + 8 * BW_KVSTAGES, q_empty = q_full + 8 * BW_QSTAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < BW_KVSTAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, FW_WARPS);
    }
    for (int s = 0; s < BW_QSTAGES; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, FW_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int nkt = S / FA_KB, nqt = S / BW_Q, items = B * nh;

  if (tid >= 2 * FW_WG) {
    // ---- producer: one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 2 * FW_WG) {
      int ks = 0, qs = 0;
      uint32_t kph = 0, qph = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int h = item % nh, b = item / nh;
        const float* tsrc = tstats + (size_t)item * nqt * BW_TSTAT;
        for (int j = 0; j < nkt; ++j) {
          mbar_wait(kv_empty + 8 * ks, kph ^ 1u);
          uint32_t bar = kv_full + 8 * ks;
          const uint32_t kd = base + L::K + ks * 2 * L::BOX, vd = base + L::V + ks * 2 * L::BOX;
          mbar_expect_tx(bar, 4 * L::BOX + FA_KB * 4);
          fa_tma(kd, &map_k, bar, pd, j * FA_KB, h, b);
          fa_tma(kd + L::BOX, &map_k, bar, pd, j * FA_KB + FW_BOX, h, b);
          fa_tma(vd, &map_v, bar, pd, j * FA_KB, h, b);
          fa_tma(vd + L::BOX, &map_v, bar, pd, j * FA_KB + FW_BOX, h, b);
          bulk_load(base + L::SEGK + ks * FA_KB * 4, seg_kv + (size_t)b * S + j * FA_KB,
                    FA_KB * 4, bar);
          if (++ks == BW_KVSTAGES) ks = 0, kph ^= 1u;
          for (int i = 0; i < nqt; ++i) {
            mbar_wait(q_empty + 8 * qs, qph ^ 1u);
            bar = q_full + 8 * qs;
            mbar_expect_tx(bar, 2 * L::BOX + BW_TSTAT * 4);
            fa_tma(base + L::Q + qs * L::BOX, &map_q, bar, pd, i * BW_Q, h, b);
            fa_tma(base + L::D + qs * L::BOX, &map_do, bar, pd, i * BW_Q, h, b);
            bulk_load(base + L::TS + qs * BW_TSTAT * 4, tsrc + (size_t)i * BW_TSTAT,
                      BW_TSTAT * 4, bar);
            if (++qs == BW_QSTAGES) qs = 0, qph ^= 1u;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes keys 64·wg .. + 63 of every block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
    const float c2 = scale * LOG2E;
    const bool positive = scale > 0.0f;
    float* acc_smem = reinterpret_cast<float*>(gbase + L::ACC);
    int ks = 0, qs = 0, np = 0;
    uint32_t kph = 0, qph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int h = item % nh, b = item / nh;
      const size_t head = lay.head(b, h);
      float* acc_head = dq_acc != nullptr ? dq_acc + (size_t)item * 2 * S * HD : acc_smem;
      float* dq_sum = acc_head + (size_t)wg * S * HD;  // this warpgroup's
      for (int j = 0; j < nkt; ++j) {
        const int krow0 = j * FA_KB + wg * FW_BOX + warp * 16;  // the warp's 16 keys
        float dva[HD / 2], dka[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) dva[i] = dka[i] = 0.0f;
        mbar_wait(kv_full + 8 * ks, kph);
        const int* segk = reinterpret_cast<const int*>(gbase + L::SEGK) + ks * FA_KB +
                          wg * FW_BOX + warp * 16 + (lane >> 2);
        const int sk[2] = {segk[0], segk[8]};
        const int klo = __reduce_min_sync(~0u, min(sk[0], sk[1]));
        const bool one_seg = klo == __reduce_max_sync(~0u, max(sk[0], sk[1]));
        const uint32_t kt = base + L::K + ks * 2 * L::BOX + wg * L::BOX;
        const uint32_t vt = base + L::V + ks * 2 * L::BOX + wg * L::BOX;
        // sᵀ = k·qᵀ and dPᵀ = v·dOᵀ of the query tile in stage qs
        float st[32], dp[32];
        auto issue_sdp = [&] {
          const uint32_t qt = base + L::Q + qs * L::BOX, dt = base + L::D + qs * L::BOX;
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<64, 0, 0>(st, wgmma_desc_sw<T>(kt + 32 * kk), wgmma_desc_sw<T>(qt + 32 * kk),
                               kk > 0);
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<64, 0, 0>(dp, wgmma_desc_sw<T>(vt + 32 * kk), wgmma_desc_sw<T>(dt + 32 * kk),
                               kk > 0);
          wgmma_commit();
        };
        mbar_wait(q_full + 8 * qs, qph);
        wgmma_fence();
        issue_sdp();
        for (int i = 0; i < nqt; ++i, ++np) {
          const int cs = qs;
          const float* ts = reinterpret_cast<const float*>(gbase + L::TS + cs * BW_TSTAT * 4);
          const uint32_t qt = base + L::Q + cs * L::BOX, dt = base + L::D + cs * L::BOX;
          const int4 hdr = *reinterpret_cast<const int4*>(ts + 5 * BW_Q);
          const bool clean = positive && one_seg && hdr.x && hdr.y == klo;
          wgmma_wait<0>();  // sᵀ and dPᵀ of this tile
          // pᵀ and dSᵀ: rows are this thread's keys, columns 8·jj + 2·t + e
          // the tile's queries, whose statistics lie at 16·t + 4·q2 + c
#pragma unroll
          for (int q2 = 0; q2 < 4; ++q2) {
            const int at = 16 * t + 4 * q2;
            const float4 rv = *reinterpret_cast<const float4*>(ts + BW_Q + at);
            const float4 dv4 = *reinterpret_cast<const float4*>(ts + 2 * BW_Q + at);
            const float ri[4] = {rv.x, rv.y, rv.z, rv.w}, di[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
            float ex[4][2];  // [c][x]: the exponent, in base 2, of logit idx below
            if (clean) {
              const float4 mv = *reinterpret_cast<const float4*>(ts + at);
              const float mb[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
              for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int x = 0; x < 2; ++x)
                  ex[c][x] = fmaf(st[4 * (2 * q2 + (c >> 1)) + 2 * x + (c & 1)], c2, -mb[c]);
            } else {
              const float4 mv = *reinterpret_cast<const float4*>(ts + 3 * BW_Q + at);
              const int4 sv = *reinterpret_cast<const int4*>(ts + 4 * BW_Q + at);
              const float mn[4] = {mv.x, mv.y, mv.z, mv.w};
              const int sg[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
              for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int x = 0; x < 2; ++x) {
                  const float z = __fadd_rn(
                      __fmul_rn(st[4 * (2 * q2 + (c >> 1)) + 2 * x + (c & 1)], scale),
                      seg_bias(sg[c], sk[x], mask_value));
                  ex[c][x] = __fmul_rn(__fsub_rn(z, mn[c]), LOG2E);
                }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                const int idx = 4 * (2 * q2 + (c >> 1)) + 2 * x + (c & 1);
                const float p = ex2_approx(ex[c][x]) * ri[c];
                dp[idx] = __fmul_rn(__fmul_rn(__fsub_rn(dp[idx], di[c]), p), scale);
                st[idx] = p;
              }
          }
          uint32_t pa[4][4], da[4][4];
          pack_frag_a(pa, st);
          pack_frag_a(da, dp);
          // dSᵀ to its 128-byte-swizzled tile: line = key, 64 queries a line
          const uint32_t gt = base + L::G + (wg * 2 + (np & 1)) * 8192;
          {
            const int kr = warp * 16 + (lane >> 2);
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int jj = 2 * c + hf;
#pragma unroll
                for (int x = 0; x < 2; ++x) {
                  const int line = kr + 8 * x;
                  const uint32_t addr = gt + line * 128 + (((jj ^ (line & 7)) << 4) | (t << 2));
                  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(da[c][2 * hf + x])
                               : "memory");
                }
              }
          }
          fence_proxy_async();
          wgmma_fence();
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wgmma_rs<HD, 1>(dva, pa[c], wgmma_desc_sw<T>(dt + 16 * T * c), 1);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wgmma_rs<HD, 1>(dka, da[c], wgmma_desc_sw<T>(qt + 16 * T * c), 1);
          wgmma_commit();
          named_barrier(BW_BAR_STAGED + wg, FW_WG);  // the warpgroup's dSᵀ is written
          float dqp[HD / 2];
          wgmma_fence();
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wgmma_ss<HD, 1, 1>(dqp, wgmma_desc_sw<128>(gt + 2048 * c),
                               wgmma_desc_sw<T>(kt + 16 * T * c), c > 0);
          wgmma_commit();
          if (++qs == BW_QSTAGES) qs = 0, qph ^= 1u;
          // the next tile's sᵀ and dPᵀ run while this tile's dQ is summed
          if (i + 1 < nqt) {
            mbar_wait(q_full + 8 * qs, qph);
            issue_sdp();
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          warp_arrive(q_empty + 8 * cs, lane);

          // dQ: each warpgroup sums its part over the key blocks in order
          const int qr = i * BW_Q + warp * 16 + (lane >> 2);
#pragma unroll
          for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              float2* pp = reinterpret_cast<float2*>(dq_sum + dq_at<HD>(qr + 8 * x, 4 * nb + t));
              float2 v = make_float2(dqp[4 * nb + 2 * x], dqp[4 * nb + 2 * x + 1]);
              if (j > 0) {
                const float2 a = *pp;
                v.x = a.x + v.x;
                v.y = a.y + v.y;
              }
              *pp = v;
            }
        }
        warp_arrive(kv_empty + 8 * ks, lane);
        if (++ks == BW_KVSTAGES) ks = 0, kph ^= 1u;
        store_frag_bf16<HD>(dk + head, lay.ss, dka, krow0, lane);
        store_frag_bf16<HD>(dv + head, lay.ss, dva, krow0, lane);
      }
      // dQ = warpgroup 0's sum + warpgroup 1's, as bf16
      named_barrier(BW_BAR_DQ, 2 * FW_WG);
      for (int e = tid; e < S * HD / 2; e += 2 * FW_WG) {
        const int row = e / (HD / 2), slot = e % (HD / 2), at = dq_at<HD>(row, slot);
        const float2 a = *reinterpret_cast<const float2*>(acc_head + at);
        const float2 c = *reinterpret_cast<const float2*>(acc_head + (size_t)S * HD + at);
        *reinterpret_cast<uint32_t*>(dq + head + (size_t)row * lay.ss + 2 * slot) =
            pack_bf16(a.x + c.x, a.y + c.y);
      }
      named_barrier(BW_BAR_DQ, 2 * FW_WG);  // the sums may be overwritten
    }
  }
}

// ---------------------------------------------------------------------------
// f32 (SIMT): a thread owns row t / 8 of the block and columns t % 8 + 8j;
// the eight threads of a row are neighbouring lanes, so row reductions are
// three xor shuffles and every lane of the row ends with the same bits.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float row8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// rows [r0, r0 + n) of one head into shared rows of ld floats
__device__ __forceinline__ void load_rows_fa(float* dst, const float* __restrict__ src,
                                             long long ss, int n, int hd, int ld) {
  for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    dst[r * ld + d] = src[(size_t)r * ss + d];
  }
}

inline size_t flash_fwd_f32_smem_bytes(int hd) {
  return (size_t)((FS_Q + 2 * FA_KB) * (hd + 1) + FS_Q * (FA_KB + 1) + FA_KB) * sizeof(float);
}

__global__ void __launch_bounds__(FS_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, float* __restrict__ o,
                     float* __restrict__ stats, int S, int hd, FaLayout lay, float scale,
                     float mask_value) {
  extern __shared__ float fs[];
  const int ld = hd + 1, LP = FA_KB + 1;
  const int q0 = blockIdx.x * FS_Q, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7, nkb = S / FA_KB;
  float* Qs = fs;
  float* Ks = Qs + FS_Q * ld;
  float* Vs = Ks + FA_KB * ld;
  float* Ps = Vs + FA_KB * ld;
  int* segk = reinterpret_cast<int*>(Ps + FS_Q * LP);
  const size_t head = lay.head(b, h);
  load_rows_fa(Qs, q + head + (size_t)q0 * lay.ss, lay.ss, FS_Q, hd, ld);
  const int sqr = seg_q[(size_t)b * S + q0 + r];
  float m = -INFINITY, l = 0.0f, acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  for (int kb = 0; kb < nkb; ++kb) {
    __syncthreads();  // the last block's reads are done
    const size_t off = head + (size_t)kb * FA_KB * lay.ss;
    load_rows_fa(Ks, k + off, lay.ss, FA_KB, hd, ld);
    load_rows_fa(Vs, v + off, lay.ss, FA_KB, hd, ld);
    for (int j = tid; j < FA_KB; j += FS_THREADS) segk[j] = seg_kv[(size_t)b * S + kb * FA_KB + j];
    __syncthreads();
    float s[FA_KB / 8], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < FA_KB / 8; ++j) {
      const int c = sub + 8 * j;
      float z = 0.0f;
      for (int d = 0; d < hd; ++d) z = fmaf(Qs[r * ld + d], Ks[c * ld + d], z);
      z = z * scale;
      z = z + seg_bias(sqr, segk[c], mask_value);
      s[j] = z;
      mx = fmaxf(mx, z);
    }
    const float m_next = fmaxf(m, row8_max(mx));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < FA_KB / 8; ++j) s[j] = expf(s[j] - m_next), sum += s[j];
    const float l_corr = expf(m - m_next) * l;
    const float l_next = row8_sum(sum) + l_corr;
    const float inv = l_next == 0.0f ? 1.0f : 1.0f / l_next;
    m = m_next;
    l = l_next;
#pragma unroll
    for (int j = 0; j < FA_KB / 8; ++j)
      Ps[r * LP + sub + 8 * j] = nkb == 1 ? __fdiv_rn(s[j], l) : s[j];
    __syncwarp();  // a row's eight threads share a warp
    for (int i = 0; i < hd / 8; ++i) {
      const int col = sub + 8 * i;
      float oc = 0.0f;
      for (int c = 0; c < FA_KB; ++c) oc = fmaf(Ps[r * LP + c], Vs[c * ld + col], oc);
      acc[i] = nkb == 1 ? oc : acc[i] * (l_corr * inv) + oc * inv;
    }
  }
  for (int i = 0; i < hd / 8; ++i)
    o[head + (size_t)(q0 + r) * lay.ss + sub + 8 * i] = acc[i];
  if (sub == 0) {
    const size_t N = (size_t)gridDim.z * nh * S, i0 = ((size_t)b * nh + h) * S;
    stats[i0 + q0 + r] = m;
    stats[N + i0 + q0 + r] = l;
  }
}

inline size_t flash_bwd_f32_smem_bytes(int hd) {
  return (size_t)(4 * FS_Q * (hd + 1) + 2 * FS_Q * (FS_BWD + 1) + 4 * FS_BWD) * sizeof(float);
}

// dQ and di: a block per 32 query rows, the key blocks in order
__global__ void __launch_bounds__(FS_THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const int* __restrict__ seg_q,
                        const int* __restrict__ seg_kv, const float* __restrict__ stats,
                        float* __restrict__ di_out, float* __restrict__ dq, int S, int hd,
                        FaLayout lay, float scale, float mask_value) {
  extern __shared__ float fs[];
  const int ld = hd + 1, LP = FS_BWD + 1;
  const int q0 = blockIdx.x * FS_Q, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  float* Qs = fs;
  float* Ds = Qs + FS_Q * ld;
  float* Ks = Ds + FS_Q * ld;
  float* Vs = Ks + FS_Q * ld;
  float* Ps = Vs + FS_Q * ld;       // dS [32][33]
  int* segk = reinterpret_cast<int*>(Ps + 2 * FS_Q * LP);
  const size_t head = lay.head(b, h);
  const size_t N = (size_t)gridDim.z * nh * S, i0 = ((size_t)b * nh + h) * S;
  load_rows_fa(Qs, q + head + (size_t)q0 * lay.ss, lay.ss, FS_Q, hd, ld);
  load_rows_fa(Ds, dout + head + (size_t)q0 * lay.ss, lay.ss, FS_Q, hd, ld);
  float di = 0.0f;
  for (int d = sub; d < hd; d += 8)
    di = fmaf(o[head + (size_t)(q0 + r) * lay.ss + d], dout[head + (size_t)(q0 + r) * lay.ss + d], di);
  di = row8_sum(di);
  if (sub == 0) di_out[i0 + q0 + r] = di;
  const int sqr = seg_q[(size_t)b * S + q0 + r];
  const float mr = stats[i0 + q0 + r], rr = 1.0f / stats[N + i0 + q0 + r];
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  for (int kb = 0; kb < S / FS_BWD; ++kb) {
    __syncthreads();
    const size_t off = head + (size_t)kb * FS_BWD * lay.ss;
    load_rows_fa(Ks, k + off, lay.ss, FS_BWD, hd, ld);
    load_rows_fa(Vs, v + off, lay.ss, FS_BWD, hd, ld);
    if (tid < FS_BWD) segk[tid] = seg_kv[(size_t)b * S + kb * FS_BWD + tid];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FS_BWD / 8; ++j) {
      const int c = sub + 8 * j;
      float z = 0.0f, dp = 0.0f;
      for (int d = 0; d < hd; ++d) {
        z = fmaf(Qs[r * ld + d], Ks[c * ld + d], z);
        dp = fmaf(Ds[r * ld + d], Vs[c * ld + d], dp);
      }
      z = z * scale;
      z = z + seg_bias(sqr, segk[c], mask_value);
      const float p = expf(z - mr) * rr;
      Ps[r * LP + c] = ((dp - di) * p) * scale;
    }
    __syncwarp();
    for (int i = 0; i < hd / 8; ++i) {
      const int col = sub + 8 * i;
      float a = acc[i];
      for (int c = 0; c < FS_BWD; ++c) a = fmaf(Ps[r * LP + c], Ks[c * ld + col], a);
      acc[i] = a;
    }
  }
  for (int i = 0; i < hd / 8; ++i) dq[head + (size_t)(q0 + r) * lay.ss + sub + 8 * i] = acc[i];
}

// dK and dV: a block per 32 keys, the query blocks in order
__global__ void __launch_bounds__(FS_THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                         const float* __restrict__ stats, const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv, int S, int hd,
                         FaLayout lay, float scale, float mask_value) {
  extern __shared__ float fs[];
  const int ld = hd + 1, LP = FS_BWD + 1;
  const int k0 = blockIdx.x * FS_Q, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  float* Ks = fs;
  float* Vs = Ks + FS_Q * ld;
  float* Qs = Vs + FS_Q * ld;
  float* Ds = Qs + FS_BWD * ld;
  float* Ps = Ds + FS_BWD * ld;     // pᵀ [32][33]
  float* Gs = Ps + FS_Q * LP;       // dSᵀ [32][33]
  float* qrow = Gs + FS_Q * LP;     // [4][32]: m, 1/l, di, seg
  const size_t head = lay.head(b, h);
  const size_t N = (size_t)gridDim.z * nh * S, i0 = ((size_t)b * nh + h) * S;
  load_rows_fa(Ks, k + head + (size_t)k0 * lay.ss, lay.ss, FS_Q, hd, ld);
  load_rows_fa(Vs, v + head + (size_t)k0 * lay.ss, lay.ss, FS_Q, hd, ld);
  const int skr = seg_kv[(size_t)b * S + k0 + r];
  float ak[8], av[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ak[i] = av[i] = 0.0f;
  for (int qb = 0; qb < S / FS_BWD; ++qb) {
    __syncthreads();
    const size_t off = head + (size_t)qb * FS_BWD * lay.ss;
    load_rows_fa(Qs, q + off, lay.ss, FS_BWD, hd, ld);
    load_rows_fa(Ds, dout + off, lay.ss, FS_BWD, hd, ld);
    if (tid < FS_BWD) {
      const size_t rw = i0 + (size_t)qb * FS_BWD + tid;
      qrow[tid] = stats[rw];
      qrow[FS_BWD + tid] = 1.0f / stats[N + rw];
      qrow[2 * FS_BWD + tid] = di[rw];
      qrow[3 * FS_BWD + tid] = __int_as_float(seg_q[(size_t)b * S + qb * FS_BWD + tid]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FS_BWD / 8; ++j) {
      const int c = sub + 8 * j;
      float z = 0.0f, dp = 0.0f;
      for (int d = 0; d < hd; ++d) {
        z = fmaf(Ks[r * ld + d], Qs[c * ld + d], z);
        dp = fmaf(Vs[r * ld + d], Ds[c * ld + d], dp);
      }
      z = z * scale;
      z = z + seg_bias(__float_as_int(qrow[3 * FS_BWD + c]), skr, mask_value);
      const float p = expf(z - qrow[c]) * qrow[FS_BWD + c];
      Ps[r * LP + c] = p;
      Gs[r * LP + c] = ((dp - qrow[2 * FS_BWD + c]) * p) * scale;
    }
    __syncwarp();
    for (int i = 0; i < hd / 8; ++i) {
      const int col = sub + 8 * i;
      float a = av[i], g = ak[i];
      for (int c = 0; c < FS_BWD; ++c) {
        a = fmaf(Ps[r * LP + c], Ds[c * ld + col], a);
        g = fmaf(Gs[r * LP + c], Qs[c * ld + col], g);
      }
      av[i] = a;
      ak[i] = g;
    }
  }
  for (int i = 0; i < hd / 8; ++i) {
    dk[head + (size_t)(k0 + r) * lay.ss + sub + 8 * i] = ak[i];
    dv[head + (size_t)(k0 + r) * lay.ss + sub + 8 * i] = av[i];
  }
}


// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
inline int max_smem_optin() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      return 0;
    return v;
  }();
  return n > 0 ? n : 232448;
}

// The maps of `n` (B, nh, S, hd) bf16 tensors of one layout: dimensions hd,
// then the sequence, head and batch axes by stride; boxes of 64 rows.
inline bool make_fa_maps(CUtensorMap* maps, const void* const* bases, int n, int B, int nh, int S,
                         int hd, const FaLayout& lay, FaDims* pd) {
  struct Axis {
    long long stride;
    int size, which;  // 0 sequence, 1 head, 2 batch
  } ax[3] = {{lay.ss, S, 0}, {lay.sh, nh, 1}, {lay.sb, B, 2}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && ax[j].stride < ax[j - 1].stride; --j) std::swap(ax[j], ax[j - 1]);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)ax[0].size, (cuuint64_t)ax[1].size,
                              (cuuint64_t)ax[2].size};
  const cuuint64_t strides[3] = {(cuuint64_t)ax[0].stride * 2, (cuuint64_t)ax[1].stride * 2,
                                 (cuuint64_t)ax[2].stride * 2};
  cuuint32_t box[4] = {(cuuint32_t)hd, 1u, 1u, 1u};
  int* where[3] = {&pd->s, &pd->h, &pd->b};
  for (int i = 0; i < 3; ++i) {
    *where[ax[i].which] = i + 1;
    if (ax[i].which == 0) box[i + 1] = FW_BOX;
  }
  for (int i = 0; i < n; ++i)
    if (!make_tensor_map_4d(&maps[i], bases[i], dims, strides, box)) return false;
  return true;
}

template <int HD>
int launch_flash_fwd_wgmma(const bf16* q, const bf16* k, const bf16* v, const int* sq,
                           const int* skv, bf16* o, float* stats, int B, int nh, int S,
                           const FaLayout& lay, float scale, float mask_value, cudaStream_t st) {
  CUtensorMap maps[3];
  FaDims pd;
  const void* bases[3] = {q, k, v};
  if (!make_fa_maps(maps, bases, 3, B, nh, S, HD, lay, &pd)) return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> done{0};
  const size_t smem = FwdSmem<HD>::BYTES;
  cudaError_t e = allow_smem(flash_fwd_wgmma_kernel<HD>, smem, done);
  if (e != cudaSuccess) return (int)e;
  const int items = B * nh * (S / FW_Q);
  flash_fwd_wgmma_kernel<HD><<<std::min(items, sm_count()), FW_THREADS, smem, st>>>(
      maps[0], maps[1], maps[2], sq, skv, o, stats, B, nh, S, lay, pd, scale, mask_value);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

template <int HD>
bool bwd_acc_in_smem(int S) {
  return BwdSmem<HD>::bytes(S, true) <= (size_t)max_smem_optin();
}

inline bool bwd_acc_in_smem(int hd, int S) {
  return hd == 16 ? bwd_acc_in_smem<16>(S) : hd == 32 ? bwd_acc_in_smem<32>(S)
                                                      : bwd_acc_in_smem<64>(S);
}

template <int HD>
int launch_flash_bwd_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                           const bf16* dout, const int* sq, const int* skv, const float* stats,
                           void* scratch, bf16* dq, bf16* dk, bf16* dv, int B, int nh, int S,
                           const FaLayout& lay, float scale, float mask_value, cudaStream_t st) {
  CUtensorMap maps[4];
  FaDims pd;
  const void* bases[4] = {q, k, v, dout};
  if (!make_fa_maps(maps, bases, 4, B, nh, S, HD, lay, &pd)) return (int)cudaErrorInvalidValue;
  float* tst = reinterpret_cast<float*>(scratch);
  const bool in_smem = bwd_acc_in_smem<HD>(S);
  float* acc = in_smem ? nullptr : tst + (size_t)B * nh * (S / BW_Q) * BW_TSTAT;
  flash_bwd_prep_kernel<HD><<<dim3(S / BW_Q, nh, B), 256, 0, st>>>(o, dout, sq, stats, tst, S,
                                                                    lay);
  QST_RETURN_IF_LAUNCH_FAILED();
  static std::atomic<uint64_t> done{0};
  cudaError_t e = allow_smem(flash_bwd_wgmma_kernel<HD>, (size_t)max_smem_optin(), done);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_wgmma_kernel<HD><<<std::min(B * nh, sm_count()), FW_THREADS,
                               BwdSmem<HD>::bytes(S, in_smem), st>>>(
      maps[0], maps[1], maps[2], maps[3], skv, tst, acc, dq, dk, dv, B, nh, S, lay, pd, scale,
      mask_value);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace qst

using namespace qst;

// q, k, v, o: (B, nh, S, hd) at element strides (sb, sh, ss), d contiguous;
// seg_q, seg_kv (B, S) int32 (16-byte aligned); stats (2, B, nh, S) f32 ←
// [m, l]. S % 128 == 0, hd ∈ {16, 32, 64} (bf16: rows, strides and bases
// 16-byte multiples) or hd % 8 == 0, hd ≤ 64 (f32).
extern "C" int qst_flash_forward(int dtype, const void* q, const void* k, const void* v,
                                 const void* seg_q, const void* seg_kv, void* o, void* stats,
                                 int B, int nh, int S, int hd, long long sb, long long sh,
                                 long long ss, float scale, float mask_value, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || nh <= 0 || S <= 0) return 0;
  if (S % FA_KB != 0) return (int)cudaErrorInvalidValue;
  const FaLayout lay{sb, sh, ss};
  const int* sq = reinterpret_cast<const int*>(seg_q);
  const int* skv = reinterpret_cast<const int*>(seg_kv);
  float* stf = reinterpret_cast<float*>(stats);
  if (dtype == QST_BF16) {
#define QST_FA_FWD(HD)                                                                      \
  return launch_flash_fwd_wgmma<HD>(reinterpret_cast<const bf16*>(q),                     \
                                    reinterpret_cast<const bf16*>(k),                     \
                                    reinterpret_cast<const bf16*>(v), sq, skv,            \
                                    reinterpret_cast<bf16*>(o), stf, B, nh, S, lay, scale, \
                                    mask_value, st)
    if (hd == 16) QST_FA_FWD(16);
    if (hd == 32) QST_FA_FWD(32);
    if (hd == 64) QST_FA_FWD(64);
#undef QST_FA_FWD
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != QST_F32 || hd % 8 != 0 || hd > 64) return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> done{0};
  cudaError_t e = allow_smem(flash_fwd_f32_kernel, flash_fwd_f32_smem_bytes(64), done);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_f32_kernel<<<dim3(S / FS_Q, nh, B), FS_THREADS, flash_fwd_f32_smem_bytes(hd), st>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k),
      reinterpret_cast<const float*>(v), sq, skv, reinterpret_cast<float*>(o), stf, S, hd, lay,
      scale, mask_value);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// The bytes of qst_flash_backward's scratch: bf16, a query tile's statistics
// for each (sequence, head, 64 rows), and dQ's f32 sums where they do not fit
// in shared memory; f32, di (B, nh, S).
extern "C" long long qst_flash_backward_scratch_bytes(int dtype, int B, int nh, int S, int hd) {
  if (dtype != QST_BF16) return (long long)B * nh * S * 4;
  long long n = (long long)B * nh * (S / BW_Q) * BW_TSTAT * 4;
  if (!bwd_acc_in_smem(hd, S)) n += (long long)B * nh * 2 * S * hd * 4;
  return n;
}

// The backward: o, dout as q; scratch of qst_flash_backward_scratch_bytes
// (16-byte aligned); dq, dk, dv as q. Two kernels in order: bf16, the
// statistics pre-pass then the sweep over key blocks; f32, dQ (which writes
// di) then dK/dV (which reads it).
extern "C" int qst_flash_backward(int dtype, const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const void* seg_q,
                                  const void* seg_kv, const void* stats, void* scratch,
                                  void* dq, void* dk, void* dv, int B, int nh, int S, int hd,
                                  long long sb, long long sh, long long ss, float scale,
                                  float mask_value, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || nh <= 0 || S <= 0) return 0;
  if (S % FA_KB != 0) return (int)cudaErrorInvalidValue;
  const FaLayout lay{sb, sh, ss};
  const int* sq = reinterpret_cast<const int*>(seg_q);
  const int* skv = reinterpret_cast<const int*>(seg_kv);
  const float* stf = reinterpret_cast<const float*>(stats);
  if (dtype == QST_BF16) {
#define QST_FA_BWD(HD)                                                                       \
  return launch_flash_bwd_wgmma<HD>(                                                       \
      reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),                  \
      reinterpret_cast<const bf16*>(v), reinterpret_cast<const bf16*>(o),                  \
      reinterpret_cast<const bf16*>(dout), sq, skv, stf, scratch,                          \
      reinterpret_cast<bf16*>(dq), reinterpret_cast<bf16*>(dk), reinterpret_cast<bf16*>(dv), \
      B, nh, S, lay, scale, mask_value, st)
    if (hd == 16) QST_FA_BWD(16);
    if (hd == 32) QST_FA_BWD(32);
    if (hd == 64) QST_FA_BWD(64);
#undef QST_FA_BWD
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != QST_F32 || hd % 8 != 0 || hd > 64) return (int)cudaErrorInvalidValue;
  float* dif = reinterpret_cast<float*>(scratch);
  static std::atomic<uint64_t> dq_done{0}, dkv_done{0};
  const size_t smax = flash_bwd_f32_smem_bytes(64), smem = flash_bwd_f32_smem_bytes(hd);
  cudaError_t e = allow_smem(flash_bwd_dq_f32_kernel, smax, dq_done);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dkv_f32_kernel, smax, dkv_done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(S / FS_Q, nh, B);
  const float* qf = reinterpret_cast<const float*>(q);
  const float* kf = reinterpret_cast<const float*>(k);
  const float* vf = reinterpret_cast<const float*>(v);
  const float* df = reinterpret_cast<const float*>(dout);
  flash_bwd_dq_f32_kernel<<<grid, FS_THREADS, smem, st>>>(
      qf, kf, vf, reinterpret_cast<const float*>(o), df, sq, skv, stf, dif,
      reinterpret_cast<float*>(dq), S, hd, lay, scale, mask_value);
  QST_RETURN_IF_LAUNCH_FAILED();
  flash_bwd_dkv_f32_kernel<<<grid, FS_THREADS, smem, st>>>(
      qf, kf, vf, df, sq, skv, stf, dif, reinterpret_cast<float*>(dk),
      reinterpret_cast<float*>(dv), S, hd, lay, scale, mask_value);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
