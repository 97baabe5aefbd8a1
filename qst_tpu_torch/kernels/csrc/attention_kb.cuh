// Key-blocked attention, forward and backward: the path for 128 < S ≤ 512,
// and K2's attention with MPNet's relative bias at any S ≤ 512.
//
// Replaces, for those lengths: the attention of qst_tpu/ops/fused_layer_pallas.py
// `_layer_kernel` (:138-165, with `rel_ref` :154-155) and of
// `_layer_bwd_kernel` (:456-484, with `drel` :457-474, :506-507). The TPU
// kernel holds a whole (S, S) probability tile in VMEM; an SM's 227 KB do not
// hold one at S = 512 (the f32 tile alone is 1 MB), so here the keys are
// walked in blocks and nothing (S, S) is ever stored.
//
// What bounds it: 4·B·S²·H operations (two products of S x S x hd per head
// and sequence) against 4·B·S·H bytes of q, k, v and ctx — about S / 2
// operations a byte, so for S ≥ 256 the tensor cores are the limit; the
// recomputed sweeps below cost products, never device memory.
//
// bf16 (mma.sync.m16n8k16, four warps of 16 query rows, a block per 64
// query rows of one (sequence, head)):
// - forward: keys in blocks of 64 through a two-stage cp.async ring; the
//   first sweep keeps each row's running maximum and sum (online softmax) in
//   registers, the second recomputes the logits, forms p = e^(s-m)·(1/l) —
//   normalised before the bf16 cast, where the TPU kernel rounds it —,
//   applies the dropout bits (index row·S + col, tag 16 + (b % nb)·nh + h)
//   and accumulates P·V in registers. A row whose keys are all masked stays
//   uniform over its S real columns; columns past S are -inf.
// - backward, FlashAttention-2 style, three kernels: the query side sweeps
//   the keys three times (row max and sum; δ = Σ dP·P exactly as the TPU
//   kernel sums it; then dS = P∘(dP − δ) and dQ = dS·K) and leaves (m, 1/l,
//   δ) per row; the key side walks the query blocks in order and sums
//   dV = Dᵀ·dC and dK = dSᵀ·Q in registers; with the relative bias a third
//   kernel sums drel = Σ_b dS over the batch for one (64 x 64) tile of one
//   head inside a block, sequence by sequence, so only groups of sequences
//   reach device memory (when the tiles alone would not fill the card) and
//   a fixed-order sum adds the groups. Every sum has a fixed order: two
//   calls give the same bits.
// f32 (SIMT, the comparison path that holds 1e-4): the same sweeps over
// 32 x 32 tiles in shared memory.
#pragma once

#include "layer_common.cuh"

namespace qst {

constexpr int KB_TILE = 64;  // bf16: query rows of a block (4 warps x 16), keys of a key block
constexpr int KB_THREADS = 128;
constexpr int KB_STAGES = 2;  // the cp.async ring
constexpr int KS_TILE = 32;   // f32 (SIMT): query rows of a block, keys of a key block

template <typename T>
constexpr int kb_tile() { return std::is_same<T, bf16>::value ? KB_TILE : KS_TILE; }

template <typename T>
inline int kb_tiles(int S) { return (S + kb_tile<T>() - 1) / kb_tile<T>(); }

// ---------------------------------------------------------------------------
// bf16 building blocks: a warp's 16 rows against 16 columns at a time
// ---------------------------------------------------------------------------
// the A fragments of 16 rows at `rows` (row stride ld)
template <int HD>
__device__ __forceinline__ void load_a16(uint32_t (&a)[HD / 16][4], const bf16* rows, int ld,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(a[kk], rows + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
}

// s = A · Bᵀ for the 16 rows of A (fragments a) and 16 rows of `rows`
// (stride ld): s[j] holds columns 8j .. 8j + 7 (mma_m16n8k16's layout)
template <int HD>
__device__ __forceinline__ void mma_rows16(float (&s)[2][4], const uint32_t (&a)[HD / 16][4],
                                           const bf16* rows, int ld, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[0][i] = s[1][i] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, rows + (((lane >> 4) << 3) + (lane & 7)) * ld + kk * 16 + ((lane >> 3) & 1) * 8);
    mma_m16n8k16(s[0], a[kk], b[0], b[1]);
    mma_m16n8k16(s[1], a[kk], b[2], b[3]);
  }
}

// two neighbouring accumulators of each row as the next product's A operand
__device__ __forceinline__ void pack_a16(uint32_t (&a)[4], const float (&v)[2][4]) {
  a[0] = pack_bf16(v[0][0], v[0][1]);
  a[1] = pack_bf16(v[0][2], v[0][3]);
  a[2] = pack_bf16(v[1][0], v[1][1]);
  a[3] = pack_bf16(v[1][2], v[1][3]);
}

// The logits of a 16 x 16 chunk whose rows are queries (fragment rows a =
// lane/4 and b = a + 8) and whose columns are keys c0 + 8j + 2(lane%4) + e:
// scale, the key's mask bias (bias[c]), then with REL the relative bias
// (rows rel_a, rel_b), in the TPU kernel's order; columns ≥ S are -inf.
template <bool REL>
__device__ __forceinline__ void logits16(float (&s)[2][4], int c0, const float* bias,
                                         const float* rel_a, const float* rel_b, int S,
                                         float scale, int lane) {
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + t2 + e;
      if (c < S) {
        const float bc = bias[c];
        s[j][e] = s[j][e] * scale + bc;
        s[j][2 + e] = s[j][2 + e] * scale + bc;
        if (REL) s[j][e] += rel_a[c], s[j][2 + e] += rel_b[c];
      } else {
        s[j][e] = s[j][2 + e] = -INFINITY;
      }
    }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// one chunk into the running maximum m and sum l of rows a (x = 0) and b
// (x = 1); the chunk has at least one column below S in every row
__device__ __forceinline__ void online_update(const float (&s)[2][4], float (&m)[2],
                                              float (&l)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) mx[0] = fmaxf(mx[0], s[j][e]), mx[1] = fmaxf(mx[1], s[j][2 + e]);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float mn = fmaxf(m[x], quad_max(mx[x]));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) sum += __expf(s[j][2 * x + e] - mn);
    l[x] = l[x] * __expf(m[x] - mn) + quad_sum(sum);
    m[x] = mn;
  }
}

// logits → probabilities e^(s - m)·(1/l), the S ≤ 128 kernel's form
__device__ __forceinline__ void probs16(float (&s)[2][4], const float (&m)[2],
                                        const float (&r)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = __expf(s[j][e] - m[0]) * r[0];
      s[j][2 + e] = __expf(s[j][2 + e] - m[1]) * r[1];
    }
}

// the attention dropout of a query-major chunk: element row·S + col
__device__ __forceinline__ void drop16(float (&v)[2][4], const DropSite& ad, uint32_t seed,
                                       uint32_t tag, int row_a, int c0, int S, int lane) {
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t c = (uint32_t)(c0 + 8 * j + t2 + e);
      v[j][e] *= drop_keep(ad, seed, (uint32_t)row_a * S + c, tag);
      v[j][2 + e] *= drop_keep(ad, seed, (uint32_t)(row_a + 8) * S + c, tag);
    }
}

// the column sums of a warp's 16 x HD accumulators → out[0 .. HD-1]
template <int HD>
__device__ __forceinline__ void warp_colsum(const float (&acc)[HD / 8][4], float* out, int lane) {
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = acc[nb][e] + acc[nb][2 + e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) out[nb * 8 + lane * 2 + e] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward: grid (query tiles, heads, sequences), 128 threads
// ---------------------------------------------------------------------------
template <int HD>
inline size_t attention_kb_mma_smem_bytes(int S) {
  return (size_t)(1 + 2 * KB_STAGES) * KB_TILE * (HD + ATT_PAD) * sizeof(bf16) +
         (size_t)S * sizeof(float);
}

template <int HD, bool REL>
__global__ void __launch_bounds__(KB_THREADS)
attention_kb_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask_bias,
                        const float* __restrict__ rel, bf16* __restrict__ ctx, int S, int H,
                        float scale, DropSite ad) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  constexpr int LD = HD + ATT_PAD, TILE = KB_TILE * LD;
  const int q_begin = blockIdx.x * KB_TILE, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nkb = (S + KB_TILE - 1) / KB_TILE, n_it = 2 * nkb;
  bf16* Qs = reinterpret_cast<bf16*>(att_smem);
  bf16* Ks = Qs + TILE;              // [KB_STAGES][TILE]
  bf16* Vs = Ks + KB_STAGES * TILE;  // [KB_STAGES][TILE]
  float* bias_s = reinterpret_cast<float*>(Vs + KB_STAGES * TILE);  // [S]
  const bf16* base = qkv + (size_t)b * S * 3 * H + h * HD;
  load_head_async<HD>(Qs, base + (size_t)q_begin * 3 * H, 3 * H, S - q_begin, KB_TILE);
  for (int j = tid; j < S; j += KB_THREADS) bias_s[j] = mask_bias[(size_t)b * S + j];
  // iteration it < nkb: key block it, K only (the running max and sum);
  // it ≥ nkb: key block it - nkb, K and V (P·V)
  auto fetch = [&](int it) {
    const int k0 = (it % nkb) * KB_TILE, stage = it % KB_STAGES;
    load_head_async<HD>(Ks + stage * TILE, base + H + (size_t)k0 * 3 * H, 3 * H, S - k0, KB_TILE);
    if (it >= nkb)
      load_head_async<HD>(Vs + stage * TILE, base + 2 * H + (size_t)k0 * 3 * H, 3 * H, S - k0,
                          KB_TILE);
    cp_async_commit();
  };
  fetch(0);
  const int row_a = q_begin + warp * 16 + (lane >> 2);
  const float* rel_a = REL ? rel_row(rel, h, row_a, S) : nullptr;
  const float* rel_b = REL ? rel_row(rel, h, row_a + 8, S) : nullptr;
  const uint32_t seed = ad.on ? drop_step_seed(ad, b / ad.nb) : 0u;
  const uint32_t tag = 16u + (uint32_t)((b % ad.nb) * nh + h);
  uint32_t qa[HD / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, r[2] = {0.0f, 0.0f};
  float o[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nb][i] = 0.0f;
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      fetch(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) load_a16<HD>(qa, Qs + warp * 16 * LD, LD, lane);
    if (it == nkb) r[0] = 1.0f / l[0], r[1] = 1.0f / l[1];
    const int k0 = (it % nkb) * KB_TILE;
    const bf16* Kst = Ks + (it % KB_STAGES) * TILE;
    const bf16* Vst = Vs + (it % KB_STAGES) * TILE;
#pragma unroll
    for (int c = 0; c < KB_TILE / 16; ++c) {
      if (k0 + 16 * c >= S) break;
      float s[2][4];
      mma_rows16<HD>(s, qa, Kst + 16 * c * LD, LD, lane);
      logits16<REL>(s, k0 + 16 * c, bias_s, rel_a, rel_b, S, scale, lane);
      if (it < nkb) {
        online_update(s, m, l);
        continue;
      }
      probs16(s, m, r);
      if (ad.on) drop16(s, ad, seed, tag, row_a, k0 + 16 * c, S, lane);
      uint32_t a[4];
      pack_a16(a, s);
      mma_rows_trans<HD>(o, a, Vst + 16 * c * LD, LD, lane);
    }
    __syncthreads();  // the stage is free for the fetch two iterations on
  }
  store_rows_bf16<HD>(ctx + (size_t)b * S * H + h * HD, H, o, q_begin + warp * 16, S, lane);
}

// ---------------------------------------------------------------------------
// f32 (SIMT) building blocks: 256 threads, 32 x 32 tiles in shared memory
// ---------------------------------------------------------------------------
// rows 0 .. n_valid-1 of an (n, hd) slice (row stride ld_src) → f32 rows of
// ld floats, rows n_valid .. n-1 zero
template <typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* __restrict__ src,
                                              size_t ld_src, int n_valid, int n, int hd,
                                              int ld) {
  for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    dst[r * ld + d] = r < n_valid ? to_f32(src[(size_t)r * ld_src + d]) : 0.0f;
  }
}

__device__ __forceinline__ float dot_f32(const float* a, const float* b, int n) {
  float acc = 0.0f;
  for (int d = 0; d < n; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// the column sums of values v[j] at (row tid / 8, column tid % 8 + 8j) over
// the 32 rows → out[0 .. hd-1], in a fixed order (red: 256 floats)
__device__ __forceinline__ void colsum32(const float (&v)[8], int hd, float* red, float* out) {
  for (int j = 0; j < hd / 8; ++j) {
    red[threadIdx.x] = v[j];
    __syncthreads();
    if (threadIdx.x < 8) {
      float s = 0.0f;
      for (int r = 0; r < KS_TILE; ++r) s += red[r * 8 + threadIdx.x];
      out[threadIdx.x + 8 * j] = s;
    }
    __syncthreads();
  }
}

// the logit of (query q, key k) of head h: scale, mask bias of k, relative bias
template <bool REL>
__device__ __forceinline__ float logit_f32(float dot, float scale, float bias, const float* rel,
                                           int h, int q, int k, int S) {
  float v = dot * scale + bias;
  if (REL) v += rel[((size_t)h * S + q) * S + k];
  return v;
}

inline size_t attention_kb_smem_bytes(int S, int hd) {
  return (size_t)(3 * KS_TILE * (hd + 1) + KS_TILE * (KS_TILE + 1) + S + 2 * KS_TILE) *
         sizeof(float);
}

// f32 forward: grid (query tiles of 32, heads, sequences), 256 threads
template <typename T, bool REL>
__global__ void __launch_bounds__(256)
attention_kb_kernel(const T* __restrict__ qkv, const float* __restrict__ mask_bias,
                    const float* __restrict__ rel, T* __restrict__ ctx, int S, int H, int hd,
                    float scale, DropSite ad) {
  extern __shared__ float sm[];
  const int q_begin = blockIdx.x * KS_TILE, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = hd + 1, LP = KS_TILE + 1, nkb = (S + KS_TILE - 1) / KS_TILE;
  float* Qs = sm;
  float* Ks = Qs + KS_TILE * ld;
  float* Vs = Ks + KS_TILE * ld;
  float* Ps = Vs + KS_TILE * ld;  // [32][33]
  float* bias_s = Ps + KS_TILE * LP;
  float* m_s = bias_s + S;
  float* r_s = m_s + KS_TILE;     // the running sum, then its reciprocal
  const size_t row0 = (size_t)b * S;
  const T* base = qkv + row0 * 3 * H + h * hd;
  load_rows_f32(Qs, base + (size_t)q_begin * 3 * H, 3 * H, S - q_begin, KS_TILE, hd, ld);
  for (int j = tid; j < S; j += 256) bias_s[j] = mask_bias[row0 + j];
  if (tid < KS_TILE) m_s[tid] = -INFINITY, r_s[tid] = 0.0f;
  const uint32_t seed = ad.on ? drop_step_seed(ad, b / ad.nb) : 0u;
  const uint32_t tag = 16u + (uint32_t)((b % ad.nb) * nh + h);
  const int orow = tid >> 3, ocol = tid & 7;  // this thread's outputs: (orow, ocol + 8j)
  float o[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * KS_TILE;
      __syncthreads();  // the last block's reads are done
      if (sweep == 1 && kb == 0 && tid < KS_TILE) r_s[tid] = 1.0f / r_s[tid];
      load_rows_f32(Ks, base + H + (size_t)k0 * 3 * H, 3 * H, S - k0, KS_TILE, hd, ld);
      if (sweep) load_rows_f32(Vs, base + 2 * H + (size_t)k0 * 3 * H, 3 * H, S - k0, KS_TILE, hd, ld);
      __syncthreads();
      for (int i = tid; i < KS_TILE * KS_TILE; i += 256) {
        const int r = i / KS_TILE, c = i % KS_TILE, k = k0 + c;
        Ps[r * LP + c] = k < S ? logit_f32<REL>(dot_f32(Qs + r * ld, Ks + c * ld, hd), scale,
                                                bias_s[k], rel, h, min(q_begin + r, S - 1), k, S)
                               : -INFINITY;
      }
      __syncthreads();
      for (int r = warp; r < KS_TILE; r += 8) {  // a warp per row, a lane per key
        const float v = Ps[r * LP + lane];
        if (sweep == 0) {
          const float mo = m_s[r], lo = r_s[r];
          const float mn = fmaxf(mo, warp_max(v));
          const float e = warp_sum(expf(v - mn));
          __syncwarp();
          if (lane == 0) r_s[r] = lo * expf(mo - mn) + e, m_s[r] = mn;
        } else {
          float p = expf(v - m_s[r]) * r_s[r];
          if (ad.on) p *= drop_keep(ad, seed, (uint32_t)((q_begin + r) * S + k0 + lane), tag);
          Ps[r * LP + lane] = to_f32(from_f32<T>(p));
        }
      }
      __syncthreads();
      if (sweep)
        for (int j = 0; j < hd / 8; ++j) {
          float acc = o[j];
          for (int c = 0; c < KS_TILE; ++c)
            acc = fmaf(Ps[orow * LP + c], Vs[c * ld + ocol + 8 * j], acc);
          o[j] = acc;
        }
    }
  }
  if (q_begin + orow < S)
    for (int j = 0; j < hd / 8; ++j)
      ctx[(row0 + q_begin + orow) * H + h * hd + ocol + 8 * j] = from_f32<T>(o[j]);
}

template <typename T, bool REL>
int launch_attention_kb(const T* qkv, const float* mask_bias, const float* rel, T* ctx, int B,
                        int S, int H, int nh, const DropSite& ad, cudaStream_t st) {
  const int hd = H / nh;
  const dim3 grid(kb_tiles<T>(S), nh, B);
  if constexpr (std::is_same<T, bf16>::value) {
#define QST_KB_FWD(HD)                                                                       \
  do {                                                                                       \
    static std::atomic<uint64_t> done{0};                                                    \
    cudaError_t e = allow_smem(attention_kb_mma_kernel<HD, REL>,                             \
                               attention_kb_mma_smem_bytes<HD>(kMaxSeq), done);               \
    if (e != cudaSuccess) return (int)e;                                                     \
    attention_kb_mma_kernel<HD, REL><<<grid, KB_THREADS, attention_kb_mma_smem_bytes<HD>(S), \
                                       st>>>(qkv, mask_bias, rel, ctx, S, H,                 \
                                             1.0f / sqrtf((float)HD), ad);                   \
  } while (0)
    if (hd == 16) QST_KB_FWD(16);
    else if (hd == 32) QST_KB_FWD(32);
    else if (hd == 64) QST_KB_FWD(64);
    else return (int)cudaErrorInvalidValue;
#undef QST_KB_FWD
  } else {
    static std::atomic<uint64_t> done{0};
    cudaError_t e = allow_smem(attention_kb_kernel<T, REL>,
                               attention_kb_smem_bytes(kMaxSeq, kMaxHeadDim), done);
    if (e != cudaSuccess) return (int)e;
    attention_kb_kernel<T, REL><<<grid, 256, attention_kb_smem_bytes(S, hd), st>>>(
        qkv, mask_bias, rel, ctx, S, H, hd, 1.0f / sqrtf((float)hd), ad);
  }
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// ---------------------------------------------------------------------------
// Backward. Row statistics `stats` (3 x B·nh·S f32): the row maximum m, 1/l
// and δ = Σ dP·P of row (b, h, q) at [(b·nh + h)·S + q] of each third.
// Bias-gradient partials `part` ((B · tiles) x 3H): row b·tiles + tile holds
// the column sums of that tile's dQ (columns h·hd ..), dK (H + h·hd ..) and
// dV (2H + h·hd ..); launch_sum_rows adds them in order.
// ---------------------------------------------------------------------------
template <int HD>
inline size_t attention_bwd_q_smem_bytes(int S) {
  return (size_t)(2 + 2 * KB_STAGES) * KB_TILE * (HD + ATT_PAD) * sizeof(bf16) +
         (size_t)(S + 4 * HD) * sizeof(float);
}

// bf16 query side: grid (query tiles, heads, sequences), 128 threads. dQ,
// the row statistics, the dQ column sums.
template <int HD, bool REL>
__global__ void __launch_bounds__(KB_THREADS)
attention_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                       const float* __restrict__ mask_bias, const float* __restrict__ rel,
                       bf16* __restrict__ dqkv, float* __restrict__ stats,
                       float* __restrict__ part, int S, int H, float scale, DropSite ad) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  constexpr int LD = HD + ATT_PAD, TILE = KB_TILE * LD;
  const int qt = blockIdx.x, q_begin = qt * KB_TILE, h = blockIdx.y, b = blockIdx.z;
  const int nh = gridDim.y, nt = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nkb = nt, n_it = 3 * nkb;
  bf16* Qs = reinterpret_cast<bf16*>(att_smem);
  bf16* Cs = Qs + TILE;              // dC
  bf16* Ks = Cs + TILE;              // [KB_STAGES][TILE]
  bf16* Vs = Ks + KB_STAGES * TILE;  // [KB_STAGES][TILE]
  float* bias_s = reinterpret_cast<float*>(Vs + KB_STAGES * TILE);  // [S]
  float* red = bias_s + S;                                          // [4 warps][HD]
  const size_t row0 = (size_t)b * S;
  const bf16* base = qkv + row0 * 3 * H + h * HD;
  load_head_async<HD>(Qs, base + (size_t)q_begin * 3 * H, 3 * H, S - q_begin, KB_TILE);
  load_head_async<HD>(Cs, dctx + (row0 + q_begin) * H + h * HD, H, S - q_begin, KB_TILE);
  for (int j = tid; j < S; j += KB_THREADS) bias_s[j] = mask_bias[row0 + j];
  // sweep 0: K (row max and sum); sweep 1: K, V (δ); sweep 2: K, V (dS, dQ)
  auto fetch = [&](int it) {
    const int k0 = (it % nkb) * KB_TILE, stage = it % KB_STAGES;
    load_head_async<HD>(Ks + stage * TILE, base + H + (size_t)k0 * 3 * H, 3 * H, S - k0, KB_TILE);
    if (it >= nkb)
      load_head_async<HD>(Vs + stage * TILE, base + 2 * H + (size_t)k0 * 3 * H, 3 * H, S - k0,
                          KB_TILE);
    cp_async_commit();
  };
  fetch(0);
  const int row_a = q_begin + warp * 16 + (lane >> 2);
  const bool real_a = row_a < S, real_b = row_a + 8 < S;
  const float* rel_a = REL ? rel_row(rel, h, row_a, S) : nullptr;
  const float* rel_b = REL ? rel_row(rel, h, row_a + 8, S) : nullptr;
  const uint32_t seed = ad.on ? drop_step_seed(ad, b / ad.nb) : 0u;
  const uint32_t tag = 16u + (uint32_t)((b % ad.nb) * nh + h);
  uint32_t qa[HD / 16][4], ca[HD / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, r[2] = {0.0f, 0.0f};
  float delta[2] = {0.0f, 0.0f};
  float dq[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[nb][i] = 0.0f;
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      fetch(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      load_a16<HD>(qa, Qs + warp * 16 * LD, LD, lane);
      load_a16<HD>(ca, Cs + warp * 16 * LD, LD, lane);
    }
    if (it == nkb) r[0] = 1.0f / l[0], r[1] = 1.0f / l[1];
    if (it == 2 * nkb) delta[0] = quad_sum(delta[0]), delta[1] = quad_sum(delta[1]);
    const int sweep = it / nkb, k0 = (it % nkb) * KB_TILE;
    const bf16* Kst = Ks + (it % KB_STAGES) * TILE;
    const bf16* Vst = Vs + (it % KB_STAGES) * TILE;
#pragma unroll
    for (int c = 0; c < KB_TILE / 16; ++c) {
      if (k0 + 16 * c >= S) break;
      float s[2][4];
      mma_rows16<HD>(s, qa, Kst + 16 * c * LD, LD, lane);
      logits16<REL>(s, k0 + 16 * c, bias_s, rel_a, rel_b, S, scale, lane);
      if (sweep == 0) {
        online_update(s, m, l);
        continue;
      }
      probs16(s, m, r);
      float dp[2][4];  // dC · Vᵀ through the dropout mask
      mma_rows16<HD>(dp, ca, Vst + 16 * c * LD, LD, lane);
      if (ad.on) drop16(dp, ad, seed, tag, row_a, k0 + 16 * c, S, lane);
      if (sweep == 1) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            delta[0] += dp[j][e] * s[j][e], delta[1] += dp[j][2 + e] * s[j][2 + e];
        continue;
      }
      float g[2][4];  // dS·scale (zero in the rows past S)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          g[j][e] = real_a ? s[j][e] * (dp[j][e] - delta[0]) * scale : 0.0f;
          g[j][2 + e] = real_b ? s[j][2 + e] * (dp[j][2 + e] - delta[1]) * scale : 0.0f;
        }
      uint32_t a[4];
      pack_a16(a, g);
      mma_rows_trans<HD>(dq, a, Kst + 16 * c * LD, LD, lane);
    }
    __syncthreads();
  }
  store_rows_bf16<HD>(dqkv + row0 * 3 * H + h * HD, 3 * H, dq, q_begin + warp * 16, S, lane);
  if ((lane & 3) == 0) {
    const size_t N = (size_t)gridDim.z * nh * S, i0 = ((size_t)b * nh + h) * S;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = row_a + 8 * x;
      if (row < S) stats[i0 + row] = m[x], stats[N + i0 + row] = r[x], stats[2 * N + i0 + row] = delta[x];
    }
  }
  warp_colsum<HD>(dq, red + warp * HD, lane);
  __syncthreads();
  if (tid < HD)
    part[((size_t)b * nt + qt) * 3 * H + h * HD + tid] =
        red[tid] + red[HD + tid] + red[2 * HD + tid] + red[3 * HD + tid];
}

template <int HD>
inline size_t attention_bwd_kv_smem_bytes(int S) {
  return (size_t)(2 + 2 * KB_STAGES) * KB_TILE * (HD + ATT_PAD) * sizeof(bf16) +
         (size_t)(3 * S + 8 * HD) * sizeof(float);
}

// bf16 key side: grid (key tiles, heads, sequences), 128 threads, a warp per
// 16 key rows. The query blocks in order through the ring: Sᵀ = K·Qᵀ, P
// from the row statistics, D = the dropped P as rounded, dV += Dᵀ·dC,
// dPᵀ = V·dCᵀ, dSᵀ·scale as rounded, dK += dSᵀ·Q.
template <int HD, bool REL>
__global__ void __launch_bounds__(KB_THREADS)
attention_bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                        const float* __restrict__ mask_bias, const float* __restrict__ rel,
                        bf16* __restrict__ dqkv, const float* __restrict__ stats,
                        float* __restrict__ part, int S, int H, float scale, DropSite ad) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  constexpr int LD = HD + ATT_PAD, TILE = KB_TILE * LD;
  const int kt = blockIdx.x, k_begin = kt * KB_TILE, h = blockIdx.y, b = blockIdx.z;
  const int nh = gridDim.y, nt = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nqb = nt;
  bf16* Ks = reinterpret_cast<bf16*>(att_smem);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;              // [KB_STAGES][TILE]
  bf16* Cs = Qs + KB_STAGES * TILE;  // [KB_STAGES][TILE]
  float* m_s = reinterpret_cast<float*>(Cs + KB_STAGES * TILE);  // [S]
  float* r_s = m_s + S;
  float* d_s = r_s + S;
  float* red = d_s + S;  // [4 warps][dK | dV][HD]
  const size_t row0 = (size_t)b * S;
  const bf16* base = qkv + row0 * 3 * H + h * HD;
  load_head_async<HD>(Ks, base + H + (size_t)k_begin * 3 * H, 3 * H, S - k_begin, KB_TILE);
  load_head_async<HD>(Vs, base + 2 * H + (size_t)k_begin * 3 * H, 3 * H, S - k_begin, KB_TILE);
  {
    const size_t N = (size_t)gridDim.z * nh * S, i0 = ((size_t)b * nh + h) * S;
    for (int j = tid; j < S; j += KB_THREADS)
      m_s[j] = stats[i0 + j], r_s[j] = stats[N + i0 + j], d_s[j] = stats[2 * N + i0 + j];
  }
  auto fetch = [&](int it) {
    const int q0 = it * KB_TILE, stage = it % KB_STAGES;
    load_head_async<HD>(Qs + stage * TILE, base + (size_t)q0 * 3 * H, 3 * H, S - q0, KB_TILE);
    load_head_async<HD>(Cs + stage * TILE, dctx + (row0 + q0) * H + h * HD, H, S - q0, KB_TILE);
    cp_async_commit();
  };
  fetch(0);
  const int t2 = (lane & 3) * 2;
  const int key_a = k_begin + warp * 16 + (lane >> 2);
  const float bias_k[2] = {key_a < S ? mask_bias[row0 + key_a] : 0.0f,
                           key_a + 8 < S ? mask_bias[row0 + key_a + 8] : 0.0f};
  const uint32_t seed = ad.on ? drop_step_seed(ad, b / ad.nb) : 0u;
  const uint32_t tag = 16u + (uint32_t)((b % ad.nb) * nh + h);
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nb][i] = dv[nb][i] = 0.0f;
  for (int it = 0; it < nqb; ++it) {
    if (it + 1 < nqb) {
      fetch(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      load_a16<HD>(ka, Ks + warp * 16 * LD, LD, lane);
      load_a16<HD>(va, Vs + warp * 16 * LD, LD, lane);
    }
    const int q0 = it * KB_TILE;
    const bf16* Qst = Qs + (it % KB_STAGES) * TILE;
    const bf16* Cst = Cs + (it % KB_STAGES) * TILE;
#pragma unroll
    for (int c = 0; c < KB_TILE / 16; ++c) {
      if (q0 + 16 * c >= S) break;
      float s[2][4], dp[2][4], d[2][4], g[2][4];
      mma_rows16<HD>(s, ka, Qst + 16 * c * LD, LD, lane);   // [key][query]
      mma_rows16<HD>(dp, va, Cst + 16 * c * LD, LD, lane);  // [key][query]
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 16 * c + 8 * j + t2 + (e & 1), key = key_a + 8 * (e >> 1);
          d[j][e] = g[j][e] = 0.0f;
          if (q < S && key < S) {
            float v = s[j][e] * scale + bias_k[e >> 1];
            if (REL) v += rel[((size_t)h * S + q) * S + key];
            const float p = __expf(v - m_s[q]) * r_s[q];
            const float keep =
                ad.on ? drop_keep(ad, seed, (uint32_t)q * S + (uint32_t)key, tag) : 1.0f;
            d[j][e] = p * keep;
            g[j][e] = p * (dp[j][e] * keep - d_s[q]) * scale;
          }
        }
      uint32_t a[4];
      pack_a16(a, d);
      mma_rows_trans<HD>(dv, a, Cst + 16 * c * LD, LD, lane);
      pack_a16(a, g);
      mma_rows_trans<HD>(dk, a, Qst + 16 * c * LD, LD, lane);
    }
    __syncthreads();
  }
  bf16* dbase = dqkv + row0 * 3 * H + h * HD;
  store_rows_bf16<HD>(dbase + H, 3 * H, dk, k_begin + warp * 16, S, lane);
  store_rows_bf16<HD>(dbase + 2 * H, 3 * H, dv, k_begin + warp * 16, S, lane);
  warp_colsum<HD>(dk, red + warp * 2 * HD, lane);
  warp_colsum<HD>(dv, red + warp * 2 * HD + HD, lane);
  __syncthreads();
  if (tid < 2 * HD) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) t += red[w * 2 * HD + tid];
    part[((size_t)b * nt + kt) * 3 * H + H + (tid / HD) * H + h * HD + tid % HD] = t;
  }
}

// sequences a drel block sums, so that tiles x groups fill the card about
// twice over (one group when the tiles alone do)
inline int drel_group_size(int B, int blocks) {
  int groups = (2 * 132 + blocks - 1) / blocks;
  groups = groups < 1 ? 1 : (groups > B ? B : groups);
  return (B + groups - 1) / groups;
}

template <int HD>
inline size_t attention_drel_smem_bytes() {
  return (size_t)KB_STAGES * 4 * KB_TILE * (HD + ATT_PAD) * sizeof(bf16) +
         (size_t)KB_STAGES * 4 * KB_TILE * sizeof(float);
}

// bf16 drel: grid (key tiles, query tiles, heads x groups), 128 threads.
// out (+ group·nh·S·S) [(h·S + q)·S + k] = Σ over the group's sequences of
// dS = P∘(dP − δ), f32 and before the scale, as the query side forms it.
template <int HD>
__global__ void __launch_bounds__(KB_THREADS)
attention_drel_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                      const float* __restrict__ mask_bias, const float* __restrict__ rel,
                      const float* __restrict__ stats, float* __restrict__ out, int B, int S,
                      int H, int nh, int group_size, float scale, DropSite ad) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  constexpr int LD = HD + ATT_PAD, TILE = KB_TILE * LD;
  const int k_begin = blockIdx.x * KB_TILE, q_begin = blockIdx.y * KB_TILE;
  const int h = blockIdx.z % nh, grp = blockIdx.z / nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = grp * group_size, nb_seq = min(B, b0 + group_size) - b0;
  bf16* tiles = reinterpret_cast<bf16*>(att_smem);  // [stage][Q | dC | K | V][TILE]
  float* vecs = reinterpret_cast<float*>(tiles + KB_STAGES * 4 * TILE);  // [stage][bias | m | r | δ][64]
  const size_t N = (size_t)B * nh * S;
  auto fetch = [&](int i) {
    const int b = b0 + i, stage = i % KB_STAGES;
    bf16* t = tiles + stage * 4 * TILE;
    const bf16* base = qkv + (size_t)b * S * 3 * H + h * HD;
    load_head_async<HD>(t, base + (size_t)q_begin * 3 * H, 3 * H, S - q_begin, KB_TILE);
    load_head_async<HD>(t + TILE, dctx + ((size_t)b * S + q_begin) * H + h * HD, H, S - q_begin,
                        KB_TILE);
    load_head_async<HD>(t + 2 * TILE, base + H + (size_t)k_begin * 3 * H, 3 * H, S - k_begin,
                        KB_TILE);
    load_head_async<HD>(t + 3 * TILE, base + 2 * H + (size_t)k_begin * 3 * H, 3 * H,
                        S - k_begin, KB_TILE);
    float* v = vecs + stage * 4 * KB_TILE;
    const size_t i0 = ((size_t)b * nh + h) * S;
    for (int j = tid; j < KB_TILE; j += KB_THREADS) {
      const int k = k_begin + j, q = q_begin + j;
      v[j] = k < S ? mask_bias[(size_t)b * S + k] : 0.0f;
      v[KB_TILE + j] = q < S ? stats[i0 + q] : 0.0f;
      v[2 * KB_TILE + j] = q < S ? stats[N + i0 + q] : 0.0f;
      v[3 * KB_TILE + j] = q < S ? stats[2 * N + i0 + q] : 0.0f;
    }
    cp_async_commit();
  };
  fetch(0);
  const int ra = warp * 16 + (lane >> 2);  // rows ra and ra + 8 of the query tile
  const bool real_a = q_begin + ra < S, real_b = q_begin + ra + 8 < S;
  const float* rel_a = rel_row(rel, h, q_begin + ra, S);
  const float* rel_b = rel_row(rel, h, q_begin + ra + 8, S);
  float acc[KB_TILE / 16][2][4];
#pragma unroll
  for (int c = 0; c < KB_TILE / 16; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][0][i] = acc[c][1][i] = 0.0f;
  for (int i = 0; i < nb_seq; ++i) {
    if (i + 1 < nb_seq) {
      fetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int b = b0 + i;
    const bf16* t = tiles + (i % KB_STAGES) * 4 * TILE;
    const float* v = vecs + (i % KB_STAGES) * 4 * KB_TILE;
    const uint32_t seed = ad.on ? drop_step_seed(ad, b / ad.nb) : 0u;
    const uint32_t tag = 16u + (uint32_t)((b % ad.nb) * nh + h);
    uint32_t qa[HD / 16][4], ca[HD / 16][4];
    load_a16<HD>(qa, t + warp * 16 * LD, LD, lane);
    load_a16<HD>(ca, t + TILE + warp * 16 * LD, LD, lane);
    const float m[2] = {v[KB_TILE + ra], v[KB_TILE + ra + 8]};
    const float r[2] = {v[2 * KB_TILE + ra], v[2 * KB_TILE + ra + 8]};
    const float delta[2] = {v[3 * KB_TILE + ra], v[3 * KB_TILE + ra + 8]};
#pragma unroll
    for (int c = 0; c < KB_TILE / 16; ++c) {
      if (k_begin + 16 * c >= S) break;
      float s[2][4], dp[2][4];
      mma_rows16<HD>(s, qa, t + 2 * TILE + 16 * c * LD, LD, lane);
      logits16<true>(s, k_begin + 16 * c, v - k_begin, rel_a, rel_b, S, scale, lane);
      probs16(s, m, r);
      mma_rows16<HD>(dp, ca, t + 3 * TILE + 16 * c * LD, LD, lane);
      if (ad.on) drop16(dp, ad, seed, tag, q_begin + ra, k_begin + 16 * c, S, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (real_a) acc[c][j][e] += s[j][e] * (dp[j][e] - delta[0]);
          if (real_b) acc[c][j][2 + e] += s[j][2 + e] * (dp[j][2 + e] - delta[1]);
        }
    }
    __syncthreads();
  }
  float* o = out + (size_t)grp * nh * S * S + (size_t)h * S * S;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int c = 0; c < KB_TILE / 16; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q_begin + ra + 8 * (e >> 1), k = k_begin + 16 * c + 8 * j + t2 + (e & 1);
        if (q < S && k < S) o[(size_t)q * S + k] = acc[c][j][e];
      }
}

// ---------------------------------------------------------------------------
// f32 (SIMT) backward: the same three kernels over 32 x 32 tiles
// ---------------------------------------------------------------------------
inline size_t attention_bwd_q_f32_smem_bytes(int S, int hd) {
  return (size_t)(4 * KS_TILE * (hd + 1) + 2 * KS_TILE * (KS_TILE + 1) + S + 3 * KS_TILE + 256) *
         sizeof(float);
}

template <typename T, bool REL>
__global__ void __launch_bounds__(256)
attention_bwd_q_f32_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                           const float* __restrict__ mask_bias, const float* __restrict__ rel,
                           T* __restrict__ dqkv, float* __restrict__ stats,
                           float* __restrict__ part, int S, int H, int hd, float scale,
                           DropSite ad) {
  extern __shared__ float sm[];
  const int qt = blockIdx.x, q_begin = qt * KS_TILE, h = blockIdx.y, b = blockIdx.z;
  const int nh = gridDim.y, nt = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = hd + 1, LP = KS_TILE + 1, nkb = nt;
  float* Qs = sm;
  float* Cs = Qs + KS_TILE * ld;
  float* Ks = Cs + KS_TILE * ld;
  float* Vs = Ks + KS_TILE * ld;
  float* Ps = Vs + KS_TILE * ld;  // P
  float* Us = Ps + KS_TILE * LP;  // dP, then dS·scale as rounded
  float* bias_s = Us + KS_TILE * LP;
  float* m_s = bias_s + S;
  float* r_s = m_s + KS_TILE;
  float* d_s = r_s + KS_TILE;
  float* red = d_s + KS_TILE;
  const size_t row0 = (size_t)b * S;
  const T* base = qkv + row0 * 3 * H + h * hd;
  load_rows_f32(Qs, base + (size_t)q_begin * 3 * H, 3 * H, S - q_begin, KS_TILE, hd, ld);
  load_rows_f32(Cs, dctx + (row0 + q_begin) * H + h * hd, H, S - q_begin, KS_TILE, hd, ld);
  for (int j = tid; j < S; j += 256) bias_s[j] = mask_bias[row0 + j];
  if (tid < KS_TILE) m_s[tid] = -INFINITY, r_s[tid] = 0.0f, d_s[tid] = 0.0f;
  const uint32_t seed = ad.on ? drop_step_seed(ad, b / ad.nb) : 0u;
  const uint32_t tag = 16u + (uint32_t)((b % ad.nb) * nh + h);
  const int orow = tid >> 3, ocol = tid & 7;
  float dq[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int sweep = 0; sweep < 3; ++sweep) {
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * KS_TILE;
      __syncthreads();
      if (sweep == 1 && kb == 0 && tid < KS_TILE) r_s[tid] = 1.0f / r_s[tid];
      load_rows_f32(Ks, base + H + (size_t)k0 * 3 * H, 3 * H, S - k0, KS_TILE, hd, ld);
      if (sweep) load_rows_f32(Vs, base + 2 * H + (size_t)k0 * 3 * H, 3 * H, S - k0, KS_TILE, hd, ld);
      __syncthreads();
      for (int i = tid; i < KS_TILE * KS_TILE; i += 256) {
        const int r = i / KS_TILE, c = i % KS_TILE, q = q_begin + r, k = k0 + c;
        float v = -INFINITY, dp = 0.0f;
        if (k < S) {
          v = logit_f32<REL>(dot_f32(Qs + r * ld, Ks + c * ld, hd), scale, bias_s[k], rel, h,
                             min(q, S - 1), k, S);
          if (sweep) {
            dp = dot_f32(Cs + r * ld, Vs + c * ld, hd);
            if (ad.on) dp *= drop_keep(ad, seed, (uint32_t)(q * S + k), tag);
          }
        }
        if (sweep) v = expf(v - m_s[r]) * r_s[r];
        Ps[r * LP + c] = v;
        if (sweep == 1) Us[r * LP + c] = dp;
        if (sweep == 2)
          Us[r * LP + c] = q < S ? to_f32(from_f32<T>(v * (dp - d_s[r]) * scale)) : 0.0f;
      }
      __syncthreads();
      if (sweep < 2) {
        for (int r = warp; r < KS_TILE; r += 8) {
          const float v = Ps[r * LP + lane];
          if (sweep == 0) {
            const float mo = m_s[r], lo = r_s[r];
            const float mn = fmaxf(mo, warp_max(v));
            const float e = warp_sum(expf(v - mn));
            __syncwarp();
            if (lane == 0) r_s[r] = lo * expf(mo - mn) + e, m_s[r] = mn;
          } else {
            const float t = warp_sum(Us[r * LP + lane] * v);
            if (lane == 0) d_s[r] += t;
          }
        }
      } else {
        for (int j = 0; j < hd / 8; ++j) {
          float acc = dq[j];
          for (int c = 0; c < KS_TILE; ++c)
            acc = fmaf(Us[orow * LP + c], Ks[c * ld + ocol + 8 * j], acc);
          dq[j] = acc;
        }
      }
    }
  }
  __syncthreads();
  if (q_begin + orow < S)
    for (int j = 0; j < hd / 8; ++j)
      dqkv[(row0 + q_begin + orow) * 3 * H + h * hd + ocol + 8 * j] = from_f32<T>(dq[j]);
  if (tid < KS_TILE && q_begin + tid < S) {
    const size_t N = (size_t)gridDim.z * nh * S, i0 = ((size_t)b * nh + h) * S + q_begin + tid;
    stats[i0] = m_s[tid], stats[N + i0] = r_s[tid], stats[2 * N + i0] = d_s[tid];
  }
  colsum32(dq, hd, red, part + ((size_t)b * nt + qt) * 3 * H + h * hd);
}

inline size_t attention_bwd_kv_f32_smem_bytes(int S, int hd) {
  return (size_t)(4 * KS_TILE * (hd + 1) + 2 * KS_TILE * (KS_TILE + 1) + 3 * S + KS_TILE + 256) *
         sizeof(float);
}

template <typename T, bool REL>
__global__ void __launch_bounds__(256)
attention_bwd_kv_f32_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                            const float* __restrict__ mask_bias, const float* __restrict__ rel,
                            T* __restrict__ dqkv, const float* __restrict__ stats,
                            float* __restrict__ part, int S, int H, int hd, float scale,
                            DropSite ad) {
  extern __shared__ float sm[];
  const int kt = blockIdx.x, k_begin = kt * KS_TILE, h = blockIdx.y, b = blockIdx.z;
  const int nh = gridDim.y, nt = gridDim.x;
  const int tid = threadIdx.x;
  const int ld = hd + 1, LP = KS_TILE + 1;
  float* Ks = sm;
  float* Vs = Ks + KS_TILE * ld;
  float* Qs = Vs + KS_TILE * ld;
  float* Cs = Qs + KS_TILE * ld;
  float* Ds = Cs + KS_TILE * ld;  // [query][key]: the dropped P as rounded
  float* Gs = Ds + KS_TILE * LP;  // [query][key]: dS·scale as rounded
  float* m_s = Gs + KS_TILE * LP;
  float* r_s = m_s + S;
  float* d_s = r_s + S;
  float* bias_k = d_s + S;
  float* red = bias_k + KS_TILE;
  const size_t row0 = (size_t)b * S;
  const T* base = qkv + row0 * 3 * H + h * hd;
  load_rows_f32(Ks, base + H + (size_t)k_begin * 3 * H, 3 * H, S - k_begin, KS_TILE, hd, ld);
  load_rows_f32(Vs, base + 2 * H + (size_t)k_begin * 3 * H, 3 * H, S - k_begin, KS_TILE, hd, ld);
  {
    const size_t N = (size_t)gridDim.z * nh * S, i0 = ((size_t)b * nh + h) * S;
    for (int j = tid; j < S; j += 256)
      m_s[j] = stats[i0 + j], r_s[j] = stats[N + i0 + j], d_s[j] = stats[2 * N + i0 + j];
  }
  if (tid < KS_TILE) bias_k[tid] = k_begin + tid < S ? mask_bias[row0 + k_begin + tid] : 0.0f;
  const uint32_t seed = ad.on ? drop_step_seed(ad, b / ad.nb) : 0u;
  const uint32_t tag = 16u + (uint32_t)((b % ad.nb) * nh + h);
  const int okey = tid >> 3, ocol = tid & 7;
  float dk[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float dv[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int q0 = 0; q0 < S; q0 += KS_TILE) {
    __syncthreads();
    load_rows_f32(Qs, base + (size_t)q0 * 3 * H, 3 * H, S - q0, KS_TILE, hd, ld);
    load_rows_f32(Cs, dctx + (row0 + q0) * H + h * hd, H, S - q0, KS_TILE, hd, ld);
    __syncthreads();
    for (int i = tid; i < KS_TILE * KS_TILE; i += 256) {
      const int qi = i / KS_TILE, kc = i % KS_TILE, q = q0 + qi, k = k_begin + kc;
      float d = 0.0f, g = 0.0f;
      if (q < S && k < S) {
        const float v = logit_f32<REL>(dot_f32(Qs + qi * ld, Ks + kc * ld, hd), scale,
                                       bias_k[kc], rel, h, q, k, S);
        const float p = expf(v - m_s[q]) * r_s[q];
        const float keep = ad.on ? drop_keep(ad, seed, (uint32_t)(q * S + k), tag) : 1.0f;
        const float dp = dot_f32(Cs + qi * ld, Vs + kc * ld, hd) * keep;
        d = to_f32(from_f32<T>(p * keep));
        g = to_f32(from_f32<T>(p * (dp - d_s[q]) * scale));
      }
      Ds[qi * LP + kc] = d;
      Gs[qi * LP + kc] = g;
    }
    __syncthreads();
    for (int j = 0; j < hd / 8; ++j) {
      float av = dv[j], ak = dk[j];
      for (int qi = 0; qi < KS_TILE; ++qi) {
        av = fmaf(Ds[qi * LP + okey], Cs[qi * ld + ocol + 8 * j], av);
        ak = fmaf(Gs[qi * LP + okey], Qs[qi * ld + ocol + 8 * j], ak);
      }
      dv[j] = av, dk[j] = ak;
    }
  }
  __syncthreads();
  if (k_begin + okey < S)
    for (int j = 0; j < hd / 8; ++j) {
      T* o = dqkv + (row0 + k_begin + okey) * 3 * H + h * hd + ocol + 8 * j;
      o[H] = from_f32<T>(dk[j]);
      o[2 * H] = from_f32<T>(dv[j]);
    }
  float* prow = part + ((size_t)b * nt + kt) * 3 * H + h * hd;
  colsum32(dk, hd, red, prow + H);
  colsum32(dv, hd, red, prow + 2 * H);
}

inline size_t attention_drel_f32_smem_bytes(int hd) {
  return (size_t)(4 * KS_TILE * (hd + 1) + 4 * KS_TILE) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(256)
attention_drel_f32_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                          const float* __restrict__ mask_bias, const float* __restrict__ rel,
                          const float* __restrict__ stats, float* __restrict__ out, int B, int S,
                          int H, int nh, int group_size, float scale, DropSite ad) {
  extern __shared__ float sm[];
  const int hd = H / nh, ld = hd + 1;
  const int k_begin = blockIdx.x * KS_TILE, q_begin = blockIdx.y * KS_TILE;
  const int h = blockIdx.z % nh, grp = blockIdx.z / nh;
  const int tid = threadIdx.x;
  const int b0 = grp * group_size, b1 = min(B, b0 + group_size);
  float* Qs = sm;
  float* Cs = Qs + KS_TILE * ld;
  float* Ks = Cs + KS_TILE * ld;
  float* Vs = Ks + KS_TILE * ld;
  float* bias_k = Vs + KS_TILE * ld;
  float* m_s = bias_k + KS_TILE;
  float* r_s = m_s + KS_TILE;
  float* d_s = r_s + KS_TILE;
  const size_t N = (size_t)B * nh * S;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // entries tid + 256u of the 32 x 32 tile
  for (int b = b0; b < b1; ++b) {
    __syncthreads();
    const size_t row0 = (size_t)b * S, i0 = ((size_t)b * nh + h) * S;
    const T* base = qkv + row0 * 3 * H + h * hd;
    load_rows_f32(Qs, base + (size_t)q_begin * 3 * H, 3 * H, S - q_begin, KS_TILE, hd, ld);
    load_rows_f32(Cs, dctx + (row0 + q_begin) * H + h * hd, H, S - q_begin, KS_TILE, hd, ld);
    load_rows_f32(Ks, base + H + (size_t)k_begin * 3 * H, 3 * H, S - k_begin, KS_TILE, hd, ld);
    load_rows_f32(Vs, base + 2 * H + (size_t)k_begin * 3 * H, 3 * H, S - k_begin, KS_TILE, hd, ld);
    if (tid < KS_TILE) {
      const int k = k_begin + tid, q = q_begin + tid;
      bias_k[tid] = k < S ? mask_bias[row0 + k] : 0.0f;
      m_s[tid] = q < S ? stats[i0 + q] : 0.0f;
      r_s[tid] = q < S ? stats[N + i0 + q] : 0.0f;
      d_s[tid] = q < S ? stats[2 * N + i0 + q] : 0.0f;
    }
    __syncthreads();
    const uint32_t seed = ad.on ? drop_step_seed(ad, b / ad.nb) : 0u;
    const uint32_t tag = 16u + (uint32_t)((b % ad.nb) * nh + h);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + 256 * u, qi = i / KS_TILE, kc = i % KS_TILE;
      const int q = q_begin + qi, k = k_begin + kc;
      if (q < S && k < S) {
        const float v = logit_f32<true>(dot_f32(Qs + qi * ld, Ks + kc * ld, hd), scale,
                                        bias_k[kc], rel, h, q, k, S);
        const float p = expf(v - m_s[qi]) * r_s[qi];
        float dp = dot_f32(Cs + qi * ld, Vs + kc * ld, hd);
        if (ad.on) dp *= drop_keep(ad, seed, (uint32_t)(q * S + k), tag);
        acc[u] += p * (dp - d_s[qi]);
      }
    }
  }
  float* o = out + (size_t)grp * nh * S * S + (size_t)h * S * S;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tid + 256 * u, q = q_begin + i / KS_TILE, k = k_begin + i % KS_TILE;
    if (q < S && k < S) o[(size_t)q * S + k] = acc[u];
  }
}

// Groups of sequences the drel kernel sums in one block for (B, S, nh): the
// workspace holds groups x nh·S·S f32 partials when there are two or more.
template <typename T>
inline int drel_groups(int B, int S, int nh, int* group_size) {
  const int t = kb_tiles<T>(S);
  const int gs = drel_group_size(B, t * t * nh);
  if (group_size) *group_size = gs;
  return (B + gs - 1) / gs;
}

// The key-blocked backward: dQ, dK, dV into dqkv, their column sums into
// part ((B·tiles) x 3H), and with rel the (nh·S, S) logit gradient into drel
// (through drel_part when the sequences are cut into groups).
template <typename T, bool REL>
int launch_attention_bwd_kb(const T* qkv, const T* dctx, const float* mask_bias, const float* rel,
                            T* dqkv, float* stats, float* part, float* drel, float* drel_part,
                            int B, int S, int H, int nh, const DropSite& ad, cudaStream_t st) {
  const int hd = H / nh, nt = kb_tiles<T>(S);
  const dim3 grid(nt, nh, B);
  const float scale = 1.0f / sqrtf((float)hd);
  int gs;
  const int groups = drel_groups<T>(B, S, nh, &gs);
  float* drel_out = groups > 1 ? drel_part : drel;
  const dim3 rgrid(nt, nt, nh * groups);
  if constexpr (std::is_same<T, bf16>::value) {
#define QST_KB_BWD(HD)                                                                          \
  do {                                                                                          \
    static std::atomic<uint64_t> dq_done{0}, dkv_done{0}, drel_done{0};                         \
    cudaError_t e = allow_smem(attention_bwd_q_kernel<HD, REL>,                                 \
                               attention_bwd_q_smem_bytes<HD>(kMaxSeq), dq_done);               \
    if (e == cudaSuccess)                                                                       \
      e = allow_smem(attention_bwd_kv_kernel<HD, REL>, attention_bwd_kv_smem_bytes<HD>(kMaxSeq), \
                     dkv_done);                                                                 \
    if (e == cudaSuccess)                                                                       \
      e = allow_smem(attention_drel_kernel<HD>, attention_drel_smem_bytes<HD>(), drel_done);    \
    if (e != cudaSuccess) return (int)e;                                                        \
    attention_bwd_q_kernel<HD, REL><<<grid, KB_THREADS, attention_bwd_q_smem_bytes<HD>(S), st>>>( \
        qkv, dctx, mask_bias, rel, dqkv, stats, part, S, H, scale, ad);                         \
    QST_RETURN_IF_LAUNCH_FAILED();                                                              \
    attention_bwd_kv_kernel<HD, REL>                                                            \
        <<<grid, KB_THREADS, attention_bwd_kv_smem_bytes<HD>(S), st>>>(                         \
            qkv, dctx, mask_bias, rel, dqkv, stats, part, S, H, scale, ad);                     \
    QST_RETURN_IF_LAUNCH_FAILED();                                                              \
    if (REL)                                                                                    \
      attention_drel_kernel<HD><<<rgrid, KB_THREADS, attention_drel_smem_bytes<HD>(), st>>>(    \
          qkv, dctx, mask_bias, rel, stats, drel_out, B, S, H, nh, gs, scale, ad);              \
  } while (0)
    if (hd == 16) QST_KB_BWD(16);
    else if (hd == 32) QST_KB_BWD(32);
    else if (hd == 64) QST_KB_BWD(64);
    else return (int)cudaErrorInvalidValue;
#undef QST_KB_BWD
  } else {
    static std::atomic<uint64_t> dq_done{0}, dkv_done{0};
    cudaError_t e = allow_smem(attention_bwd_q_f32_kernel<T, REL>,
                               attention_bwd_q_f32_smem_bytes(kMaxSeq, kMaxHeadDim), dq_done);
    if (e == cudaSuccess)
      e = allow_smem(attention_bwd_kv_f32_kernel<T, REL>,
                     attention_bwd_kv_f32_smem_bytes(kMaxSeq, kMaxHeadDim), dkv_done);
    if (e != cudaSuccess) return (int)e;
    attention_bwd_q_f32_kernel<T, REL><<<grid, 256, attention_bwd_q_f32_smem_bytes(S, hd), st>>>(
        qkv, dctx, mask_bias, rel, dqkv, stats, part, S, H, hd, scale, ad);
    QST_RETURN_IF_LAUNCH_FAILED();
    attention_bwd_kv_f32_kernel<T, REL>
        <<<grid, 256, attention_bwd_kv_f32_smem_bytes(S, hd), st>>>(
            qkv, dctx, mask_bias, rel, dqkv, stats, part, S, H, hd, scale, ad);
    QST_RETURN_IF_LAUNCH_FAILED();
    if (REL)
      attention_drel_f32_kernel<T><<<rgrid, 256, attention_drel_f32_smem_bytes(hd), st>>>(
          qkv, dctx, mask_bias, rel, stats, drel_out, B, S, H, nh, gs, scale, ad);
  }
  QST_RETURN_IF_LAUNCH_FAILED();
  if (REL && groups > 1) return launch_sum_rows(drel_part, groups, nh * S * S, drel, st);
  return 0;
}

}  // namespace qst
