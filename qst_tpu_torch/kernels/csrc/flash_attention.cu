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
// The function, the library's exactly (flash_attention.py:400-560):
//   s = (q·kᵀ in f32)·sm_scale + (seg_q[i] == seg_kv[j] ? 0 : mask_value),
//   mask_value = -0.7·FLT_MAX, keys in blocks of 128 (the library's block_k).
//   One block (S = 128): p = e^(s-m) / l, cast to v's dtype, o = p·v.
//   More: online softmax, p = e^(s - m_next) UNNORMALISED, cast to v's dtype;
//   acc = acc·(α·l_prev / l_next) + (p·v)·(1/l_next), the accumulator kept
//   normalised after every block (:453-473). The output is in q's dtype;
//   (m, l) of every row are saved for the backward.
// Backward (:820-905, :1177-1255): p = e^(s - m)·(1/l); dV = pᵀ(as dO's
// dtype)·dO; dP = dO·vᵀ; dS = ((dP - di)∘p)·sm_scale; dK = dSᵀ(as dO's
// dtype)·q; dQ = dS(as k's dtype)·k. A padded query row (segment 0) attends
// to the padded keys only, and its gradient flows there.
//
// What bounds it: two products of S x S x hd per (sequence, head) forward
// (4·B·nh·S²·hd operations) against 4·B·S·H·2 bytes of q, k, v, o — about
// S/2 operations a byte at bf16, so at S ≥ 256 the tensor cores. The
// backward does five products (10·B·nh·S²·hd) against about 8·B·S·H·2 bytes.
// Nothing (S, S) reaches device memory: the keys are walked in blocks, the
// segment ids are read a tile at a time (no S limit of the op's own), the
// probabilities stay in registers (two neighbouring mma accumulators are
// the next product's A operand as they lie).
//
// bf16 (mma.sync.m16n8k16, 4 warps of 16 rows, 128 threads):
// - K7: a block per 64 query rows of one (sequence, head); key blocks of 128
//   through a two-stage cp.async ring; ONE sweep over the keys.
// - K8, FlashAttention-2's form without atomics, two kernels: the dQ kernel
//   (a block per 64 query rows) first computes di = Σ o·dO of its rows and
//   leaves it in device memory, then walks the key blocks and sums dQ in
//   registers; the dK/dV kernel (a block per 64 keys, a warp per 16) walks
//   the query blocks in order and sums dK, dV in registers. Every sum has a
//   fixed order: two calls give the same bits.
// f32 (SIMT, the comparison path that holds 1e-4): the same sweeps over
// tiles in shared memory, 256 threads.
// Launch configuration: strides (sb, sh, ss) in elements of the (b, h, s)
// axes, shared by q, k, v, o, dO, dQ, dK, dV; d contiguous. The seg ids are
// (B, S) int32, the statistics (2, B, nh, S) f32 [m, l], di (B, nh, S) f32.
#include "attention_kb.cuh"

namespace qst {

constexpr int FA_Q = 64;        // bf16: query rows of a K7 / dQ block, keys of a dK/dV block
constexpr int FA_KB = 128;      // K7's key block: the library's block_k (the bf16 rounding of
                                // the unnormalised p depends on it)
constexpr int FA_BWD_KB = 64;   // bf16 K8: keys (dQ) or queries (dK/dV) a step of the walk
constexpr int FA_THREADS = 128;
constexpr int FS_Q = 32;        // f32: query (or key) rows of a block
constexpr int FS_BWD = 32;      // f32 K8: the walk's step
constexpr int FS_THREADS = 256;

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
// K7, bf16
// ---------------------------------------------------------------------------
template <int HD>
inline size_t flash_fwd_mma_smem_bytes() {
  return (size_t)(FA_Q + 4 * FA_KB) * (HD + ATT_PAD) * sizeof(bf16) + 2 * FA_KB * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, bf16* __restrict__ o,
                     float* __restrict__ stats, int S, FaLayout lay, float scale,
                     float mask_value) {
  extern __shared__ __align__(16) unsigned char fa_smem[];
  constexpr int LD = HD + ATT_PAD, KT = FA_KB * LD;
  const int q0 = blockIdx.x * FA_Q, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t2 = (lane & 3) * 2;
  const int nkb = S / FA_KB;
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* Ks = Qs + FA_Q * LD;   // [2][KT]
  bf16* Vs = Ks + 2 * KT;      // [2][KT]
  int* segk = reinterpret_cast<int*>(Vs + 2 * KT);  // [2][FA_KB]
  const size_t head = lay.head(b, h);
  const int* sq = seg_q + (size_t)b * S;
  const int* skv = seg_kv + (size_t)b * S;
  load_head_async<HD>(Qs, q + head + (size_t)q0 * lay.ss, lay.ss, FA_Q, FA_Q);
  auto fetch = [&](int kb) {
    const int stage = kb & 1;
    const size_t off = head + (size_t)kb * FA_KB * lay.ss;
    load_head_async<HD>(Ks + stage * KT, k + off, lay.ss, FA_KB, FA_KB);
    load_head_async<HD>(Vs + stage * KT, v + off, lay.ss, FA_KB, FA_KB);
    cp_async_commit();
    // plain loads: complete for this thread before the next barrier
    for (int j = tid; j < FA_KB; j += FA_THREADS) segk[stage * FA_KB + j] = skv[kb * FA_KB + j];
  };
  fetch(0);
  const int ra = q0 + warp * 16 + (lane >> 2);  // this lane's rows: ra and ra + 8
  const int sqr[2] = {sq[ra], sq[ra + 8]};
  uint32_t qa[HD / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.0f;
  for (int kb = 0; kb < nkb; ++kb) {
    if (kb + 1 < nkb) {
      fetch(kb + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kb == 0) load_a16<HD>(qa, Qs + warp * 16 * LD, LD, lane);
    const bf16* Kst = Ks + (kb & 1) * KT;
    const bf16* Vst = Vs + (kb & 1) * KT;
    const int* sk = segk + (kb & 1) * FA_KB;
    float s[FA_KB / 16][2][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < FA_KB / 16; ++c) {
      mma_rows16<HD>(s[c], qa, Kst + 16 * c * LD, LD, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = sk[16 * c + 8 * j + t2 + e];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float& z = s[c][j][2 * x + e];
            z = z * scale;
            z = z + seg_bias(sqr[x], kc, mask_value);
            mx[x] = fmaxf(mx[x], z);
          }
        }
    }
    float m_next[2], l_corr[2], inv[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 2; ++x) m_next[x] = fmaxf(m[x], quad_max(mx[x]));
#pragma unroll
    for (int c = 0; c < FA_KB / 16; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[c][j][i] = expf(s[c][j][i] - m_next[i >> 1]);
          sum[i >> 1] += s[c][j][i];
        }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l_corr[x] = expf(m[x] - m_next[x]) * l[x];
      const float l_next = quad_sum(sum[x]) + l_corr[x];
      inv[x] = l_next == 0.0f ? 1.0f : 1.0f / l_next;
      m[x] = m_next[x];
      l[x] = l_next;
    }
    if (nkb == 1) {
      // the library's single-step kernel: p /= l before the cast
#pragma unroll
      for (int c = 0; c < FA_KB / 16; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[c][j][i] = __fdiv_rn(s[c][j][i], l[i >> 1]);
#pragma unroll
      for (int c = 0; c < FA_KB / 16; ++c) {
        uint32_t a[4];
        pack_a16(a, s[c]);
        mma_rows_trans<HD>(acc, a, Vst + 16 * c * LD, LD, lane);
      }
    } else {
      float oc[HD / 8][4];
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) oc[nb][i] = 0.0f;
#pragma unroll
      for (int c = 0; c < FA_KB / 16; ++c) {
        uint32_t a[4];
        pack_a16(a, s[c]);
        mma_rows_trans<HD>(oc, a, Vst + 16 * c * LD, LD, lane);
      }
      const float keep[2] = {l_corr[0] * inv[0], l_corr[1] * inv[1]};
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[nb][i] = acc[nb][i] * keep[i >> 1] + oc[nb][i] * inv[i >> 1];
    }
    __syncthreads();  // the stage is free for the fetch two blocks on
  }
  store_rows_bf16<HD>(o + head + (size_t)q0 * lay.ss, lay.ss, acc, warp * 16, FA_Q, lane);
  if ((lane & 3) == 0) {
    const size_t N = (size_t)gridDim.z * nh * S, i0 = ((size_t)b * nh + h) * S;
#pragma unroll
    for (int x = 0; x < 2; ++x) stats[i0 + ra + 8 * x] = m[x], stats[N + i0 + ra + 8 * x] = l[x];
  }
}

// ---------------------------------------------------------------------------
// K8, bf16: the dQ kernel (and di), then the dK/dV kernel
// ---------------------------------------------------------------------------
template <int HD>
inline size_t flash_bwd_mma_smem_bytes() {
  return (size_t)(2 * FA_Q + 4 * FA_BWD_KB) * (HD + ATT_PAD) * sizeof(bf16) +
         (size_t)2 * 4 * FA_BWD_KB * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const int* __restrict__ seg_q,
                        const int* __restrict__ seg_kv, const float* __restrict__ stats,
                        float* __restrict__ di_out, bf16* __restrict__ dq, int S, FaLayout lay,
                        float scale, float mask_value) {
  extern __shared__ __align__(16) unsigned char fa_smem[];
  constexpr int LD = HD + ATT_PAD, KT = FA_BWD_KB * LD;
  const int q0 = blockIdx.x * FA_Q, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t2 = (lane & 3) * 2;
  const int nkb = S / FA_BWD_KB;
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* Ds = Qs + FA_Q * LD;   // dO
  bf16* Ks = Ds + FA_Q * LD;   // [2][KT]
  bf16* Vs = Ks + 2 * KT;      // [2][KT]
  int* segk = reinterpret_cast<int*>(Vs + 2 * KT);  // [2][FA_BWD_KB]
  float* di_s = reinterpret_cast<float*>(segk + 2 * FA_BWD_KB);  // [FA_Q]
  const size_t head = lay.head(b, h);
  const int* skv = seg_kv + (size_t)b * S;
  load_head_async<HD>(Qs, q + head + (size_t)q0 * lay.ss, lay.ss, FA_Q, FA_Q);
  load_head_async<HD>(Ds, dout + head + (size_t)q0 * lay.ss, lay.ss, FA_Q, FA_Q);
  auto fetch = [&](int kb) {
    const int stage = kb & 1;
    const size_t off = head + (size_t)kb * FA_BWD_KB * lay.ss;
    load_head_async<HD>(Ks + stage * KT, k + off, lay.ss, FA_BWD_KB, FA_BWD_KB);
    load_head_async<HD>(Vs + stage * KT, v + off, lay.ss, FA_BWD_KB, FA_BWD_KB);
    cp_async_commit();
    for (int j = tid; j < FA_BWD_KB; j += FA_THREADS)
      segk[stage * FA_BWD_KB + j] = skv[kb * FA_BWD_KB + j];
  };
  fetch(0);
  // di = Σ_d o·dO of the block's rows, two threads a row, in f32
  {
    const int r = tid >> 1, half = tid & 1;
    const bf16* orow = o + head + (size_t)(q0 + r) * lay.ss + half * (HD / 2);
    const bf16* drow = dout + head + (size_t)(q0 + r) * lay.ss + half * (HD / 2);
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < HD / 2; ++d) acc += __bfloat162float(orow[d]) * __bfloat162float(drow[d]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      di_s[r] = acc;
      di_out[((size_t)b * nh + h) * S + q0 + r] = acc;
    }
  }
  const int ra = q0 + warp * 16 + (lane >> 2);
  const size_t N = (size_t)gridDim.z * nh * S, i0 = ((size_t)b * nh + h) * S;
  const int sqr[2] = {seg_q[(size_t)b * S + ra], seg_q[(size_t)b * S + ra + 8]};
  const float mr[2] = {stats[i0 + ra], stats[i0 + ra + 8]};
  const float rr[2] = {1.0f / stats[N + i0 + ra], 1.0f / stats[N + i0 + ra + 8]};
  float dir[2] = {0.0f, 0.0f};
  uint32_t qa[HD / 16][4], da[HD / 16][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.0f;
  for (int kb = 0; kb < nkb; ++kb) {
    if (kb + 1 < nkb) {
      fetch(kb + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kb == 0) {
      load_a16<HD>(qa, Qs + warp * 16 * LD, LD, lane);
      load_a16<HD>(da, Ds + warp * 16 * LD, LD, lane);
      dir[0] = di_s[ra - q0], dir[1] = di_s[ra + 8 - q0];
    }
    const bf16* Kst = Ks + (kb & 1) * KT;
    const bf16* Vst = Vs + (kb & 1) * KT;
    const int* sk = segk + (kb & 1) * FA_BWD_KB;
#pragma unroll
    for (int c = 0; c < FA_BWD_KB / 16; ++c) {
      float s[2][4], dp[2][4];
      mma_rows16<HD>(s, qa, Kst + 16 * c * LD, LD, lane);
      mma_rows16<HD>(dp, da, Vst + 16 * c * LD, LD, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = sk[16 * c + 8 * j + t2 + e];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float z = s[j][2 * x + e] * scale;
            z = z + seg_bias(sqr[x], kc, mask_value);
            const float p = expf(z - mr[x]) * rr[x];
            s[j][2 * x + e] = ((dp[j][2 * x + e] - dir[x]) * p) * scale;  // dS
          }
        }
      uint32_t a[4];
      pack_a16(a, s);
      mma_rows_trans<HD>(acc, a, Kst + 16 * c * LD, LD, lane);
    }
    __syncthreads();
  }
  store_rows_bf16<HD>(dq + head + (size_t)q0 * lay.ss, lay.ss, acc, warp * 16, FA_Q, lane);
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                         const float* __restrict__ stats, const float* __restrict__ di,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S, FaLayout lay,
                         float scale, float mask_value) {
  extern __shared__ __align__(16) unsigned char fa_smem[];
  constexpr int LD = HD + ATT_PAD, QT = FA_BWD_KB * LD;
  const int k0 = blockIdx.x * FA_Q, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t2 = (lane & 3) * 2;
  const int nqb = S / FA_BWD_KB;
  bf16* Ks = reinterpret_cast<bf16*>(fa_smem);
  bf16* Vs = Ks + FA_Q * LD;
  bf16* Qs = Vs + FA_Q * LD;   // [2][QT]
  bf16* Ds = Qs + 2 * QT;      // [2][QT] dO
  float* rows = reinterpret_cast<float*>(Ds + 2 * QT);  // [2][4][FA_BWD_KB]: m, 1/l, di, seg
  const size_t head = lay.head(b, h);
  const size_t N = (size_t)gridDim.z * nh * S, i0 = ((size_t)b * nh + h) * S;
  load_head_async<HD>(Ks, k + head + (size_t)k0 * lay.ss, lay.ss, FA_Q, FA_Q);
  load_head_async<HD>(Vs, v + head + (size_t)k0 * lay.ss, lay.ss, FA_Q, FA_Q);
  auto fetch = [&](int qb) {
    const int stage = qb & 1;
    const size_t off = head + (size_t)qb * FA_BWD_KB * lay.ss;
    load_head_async<HD>(Qs + stage * QT, q + off, lay.ss, FA_BWD_KB, FA_BWD_KB);
    load_head_async<HD>(Ds + stage * QT, dout + off, lay.ss, FA_BWD_KB, FA_BWD_KB);
    cp_async_commit();
    float* st = rows + stage * 4 * FA_BWD_KB;
    for (int j = tid; j < FA_BWD_KB; j += FA_THREADS) {
      const size_t r = i0 + (size_t)qb * FA_BWD_KB + j;
      st[j] = stats[r];
      st[FA_BWD_KB + j] = 1.0f / stats[N + r];
      st[2 * FA_BWD_KB + j] = di[r];
      st[3 * FA_BWD_KB + j] = __int_as_float(seg_q[(size_t)b * S + qb * FA_BWD_KB + j]);
    }
  };
  fetch(0);
  const int ka = k0 + warp * 16 + (lane >> 2);  // this lane's keys: ka and ka + 8
  const int skr[2] = {seg_kv[(size_t)b * S + ka], seg_kv[(size_t)b * S + ka + 8]};
  uint32_t kfr[HD / 16][4], vfr[HD / 16][4];
  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nb][i] = dva[nb][i] = 0.0f;
  for (int qb = 0; qb < nqb; ++qb) {
    if (qb + 1 < nqb) {
      fetch(qb + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (qb == 0) {
      load_a16<HD>(kfr, Ks + warp * 16 * LD, LD, lane);
      load_a16<HD>(vfr, Vs + warp * 16 * LD, LD, lane);
    }
    const bf16* Qst = Qs + (qb & 1) * QT;
    const bf16* Dst = Ds + (qb & 1) * QT;
    const float* st = rows + (qb & 1) * 4 * FA_BWD_KB;
#pragma unroll
    for (int c = 0; c < FA_BWD_KB / 16; ++c) {
      float s[2][4], dp[2][4];  // rows: this warp's keys; columns: 16 queries
      mma_rows16<HD>(s, kfr, Qst + 16 * c * LD, LD, lane);
      mma_rows16<HD>(dp, vfr, Dst + 16 * c * LD, LD, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 16 * c + 8 * j + t2 + e;
          const float mq = st[col], rq = st[FA_BWD_KB + col], dq_i = st[2 * FA_BWD_KB + col];
          const int sqc = __float_as_int(st[3 * FA_BWD_KB + col]);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float z = s[j][2 * x + e] * scale;
            z = z + seg_bias(sqc, skr[x], mask_value);
            const float p = expf(z - mq) * rq;
            s[j][2 * x + e] = p;
            dp[j][2 * x + e] = ((dp[j][2 * x + e] - dq_i) * p) * scale;  // dSᵀ
          }
        }
      uint32_t a[4];
      pack_a16(a, s);
      mma_rows_trans<HD>(dva, a, Dst + 16 * c * LD, LD, lane);
      pack_a16(a, dp);
      mma_rows_trans<HD>(dka, a, Qst + 16 * c * LD, LD, lane);
    }
    __syncthreads();
  }
  store_rows_bf16<HD>(dk + head + (size_t)k0 * lay.ss, lay.ss, dka, warp * 16, FA_Q, lane);
  store_rows_bf16<HD>(dv + head + (size_t)k0 * lay.ss, lay.ss, dva, warp * 16, FA_Q, lane);
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
template <int HD>
int launch_flash_fwd_mma(const bf16* q, const bf16* k, const bf16* v, const int* sq,
                         const int* skv, bf16* o, float* stats, int B, int nh, int S,
                         const FaLayout& lay, float scale, float mask_value, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  const size_t smem = flash_fwd_mma_smem_bytes<HD>();
  cudaError_t e = allow_smem(flash_fwd_mma_kernel<HD>, smem, done);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_mma_kernel<HD><<<dim3(S / FA_Q, nh, B), FA_THREADS, smem, st>>>(
      q, k, v, sq, skv, o, stats, S, lay, scale, mask_value);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

template <int HD>
int launch_flash_bwd_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                         const bf16* dout, const int* sq, const int* skv, const float* stats,
                         float* di, bf16* dq, bf16* dk, bf16* dv, int B, int nh, int S,
                         const FaLayout& lay, float scale, float mask_value, cudaStream_t st) {
  static std::atomic<uint64_t> dq_done{0}, dkv_done{0};
  const size_t smem = flash_bwd_mma_smem_bytes<HD>();
  cudaError_t e = allow_smem(flash_bwd_dq_mma_kernel<HD>, smem, dq_done);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dkv_mma_kernel<HD>, smem, dkv_done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(S / FA_Q, nh, B);
  flash_bwd_dq_mma_kernel<HD><<<grid, FA_THREADS, smem, st>>>(
      q, k, v, o, dout, sq, skv, stats, di, dq, S, lay, scale, mask_value);
  QST_RETURN_IF_LAUNCH_FAILED();
  flash_bwd_dkv_mma_kernel<HD><<<grid, FA_THREADS, smem, st>>>(
      q, k, v, dout, sq, skv, stats, di, dk, dv, S, lay, scale, mask_value);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace qst

using namespace qst;

// q, k, v, o: (B, nh, S, hd) at element strides (sb, sh, ss), d contiguous;
// seg_q, seg_kv (B, S) int32; stats (2, B, nh, S) f32 ← [m, l]. S % 128 == 0,
// hd ∈ {16, 32, 64} (bf16) or hd % 8 == 0, hd ≤ 64 (f32).
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
#define QST_FA_FWD(HD)                                                                    \
  return launch_flash_fwd_mma<HD>(reinterpret_cast<const bf16*>(q),                     \
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

// The backward: o, dout as q; di (B, nh, S) f32 scratch; dq, dk, dv as q.
// Two kernels in order: dQ (which writes di), then dK/dV (which reads it).
extern "C" int qst_flash_backward(int dtype, const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const void* seg_q,
                                  const void* seg_kv, const void* stats, void* di, void* dq,
                                  void* dk, void* dv, int B, int nh, int S, int hd,
                                  long long sb, long long sh, long long ss, float scale,
                                  float mask_value, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B <= 0 || nh <= 0 || S <= 0) return 0;
  if (S % FA_KB != 0) return (int)cudaErrorInvalidValue;
  const FaLayout lay{sb, sh, ss};
  const int* sq = reinterpret_cast<const int*>(seg_q);
  const int* skv = reinterpret_cast<const int*>(seg_kv);
  const float* stf = reinterpret_cast<const float*>(stats);
  float* dif = reinterpret_cast<float*>(di);
  if (dtype == QST_BF16) {
#define QST_FA_BWD(HD)                                                                       \
  return launch_flash_bwd_mma<HD>(                                                         \
      reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),                  \
      reinterpret_cast<const bf16*>(v), reinterpret_cast<const bf16*>(o),                  \
      reinterpret_cast<const bf16*>(dout), sq, skv, stf, dif, reinterpret_cast<bf16*>(dq), \
      reinterpret_cast<bf16*>(dk), reinterpret_cast<bf16*>(dv), B, nh, S, lay, scale,     \
      mask_value, st)
    if (hd == 16) QST_FA_BWD(16);
    if (hd == 32) QST_FA_BWD(32);
    if (hd == 64) QST_FA_BWD(64);
#undef QST_FA_BWD
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != QST_F32 || hd % 8 != 0 || hd > 64) return (int)cudaErrorInvalidValue;
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
