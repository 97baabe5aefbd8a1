// Device code shared by K1 (fused_layer.cu) and K2 (fused_layer_bwd.cu):
// the GEMMs and their epilogues, the attention forward, LayerNorm and a
// deterministic sum over the rows of a partial-sum matrix. Header-only
// templates: each translation unit instantiates what it launches.
//
// GEMM operands: C(M, N) = op(A)(M, K) · op(B)(K, N). A is stored (M, K)
// row-major, or with TA (K, M) — the "xᵀ·dy" of a weight gradient, where K
// is the token count; B is stored (K, N), or with TB (N, K) — the "dy·Wᵀ" of
// an input gradient. Split-K takes one k_chunk of K per split: the
// EPI_PARTIAL epilogue writes one f32 partial per split, summed afterwards
// in a fixed order by sum_rows_kernel, so a weight gradient is the same on
// every run (no atomics).
//
// The bf16 path is written for Hopper: one persistent, warp-specialised
// GEMM (a 4-stage ring of 128x64 and 64x128 tiles filled by TMA, consumed by
// two warpgroups with wgmma, a whole output tile each in turns, epilogues
// applied warp by warp on the way from the accumulators to device memory
// while the other warpgroup multiplies) serves all of K1's and K2's products,
// and the attention runs on mma.sync with the probabilities kept in
// registers (S ≤ 128; longer sequences take the key-blocked kernels of
// attention_kb.cuh). MPNet's relative bias is a template flag of every
// attention forward. The f32 path (a SIMT GEMM and a SIMT attention) is the
// comparison path that holds 1e-4.
#pragma once

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace qst {

enum Epilogue {
  EPI_BIAS = 0,            // C (T)   = acc + bias
  EPI_BIAS_GELU = 1,       // C (T)   = gelu(acc + bias)
  EPI_BIAS_RESID_F32 = 2,  // C (f32) = drop(acc + bias) + resid (T)
  EPI_BIAS_GELU_SAVE = 3,  // as EPI_BIAS_GELU, and aux (f32) = acc + bias
  EPI_GELU_GRAD = 4,       // v = acc * gelu'(aux); C (T) = v; colpart: column sums of v
  EPI_ADD_F32 = 5,         // C (f32) = acc + resid (f32)
  EPI_ADD_F32_TO_T = 6,    // C (T)   = acc + resid (f32)
  EPI_STORE = 7,           // C (T)   = acc
  EPI_PARTIAL = 8,         // C (f32) + blockIdx.z * M * N = acc
};

struct EpiArgs {
  const float* bias = nullptr;  // (N,)
  const void* resid = nullptr;  // (M, N)
  float* aux = nullptr;         // (M, N) f32 pre-activation: written by _SAVE, read by _GRAD
  float* colpart = nullptr;     // (gridDim.y, N) f32 column sums of one row tile each
  DropSite drop{};              // EPI_BIAS_RESID_F32: dropout of acc + bias
  uint32_t drop_tag = 0;
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// d/dx gelu(x) = Phi(x) + x phi(x)
__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.0f + erff(x * 0.7071067811865476f)) +
         x * expf(-0.5f * x * x) * 0.3989422804014327f;
}

// The bf16 epilogues' erf is the TPU kernel's own (`_gelu_erf`,
// fused_layer_pallas.py:64): Abramowitz–Stegun 7.1.26, |err| ≤ 1.5e-7 — far
// below bf16 resolution — and free of branches, where erff's two ranges
// cost a tile's epilogue more than its products. Returns erf(x / √2) and, in
// e, exp(-x² / 2), which the derivative needs as well.
__device__ __forceinline__ float erf_rational(float x, float& e) {
  const float z = x * 0.7071067811865476f, a = fabsf(z);
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  e = __expf(-a * a);
  return copysignf(1.0f - poly * e, z);
}

__device__ __forceinline__ float gelu_erf_bf16(float x) {
  float e;
  return 0.5f * x * (1.0f + erf_rational(x, e));
}

__device__ __forceinline__ float gelu_grad_bf16(float x) {
  float e;
  const float phi = 0.5f * (1.0f + erf_rational(x, e));
  return phi + x * e * 0.3989422804014327f;
}

// One output element; returns its contribution to the column sum
// (EPI_GELU_GRAD), else 0.
template <typename T, int EPI>
__device__ __forceinline__ float epilogue(void* C, const EpiArgs& ep, int M, int N, int gm,
                                          int gn, float acc) {
  const size_t o = (size_t)gm * N + gn;
  if (EPI == EPI_BIAS) {
    reinterpret_cast<T*>(C)[o] = from_f32<T>(acc + ep.bias[gn]);
  } else if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_SAVE) {
    const float v = acc + ep.bias[gn];
    if (EPI == EPI_BIAS_GELU_SAVE) ep.aux[o] = v;
    reinterpret_cast<T*>(C)[o] = from_f32<T>(gelu_erf(v));
  } else if (EPI == EPI_BIAS_RESID_F32) {
    float v = acc + ep.bias[gn];
    if (ep.drop.on) v *= drop_hidden(ep.drop, gm, gn, N, ep.drop_tag);
    reinterpret_cast<float*>(C)[o] = v + to_f32(reinterpret_cast<const T*>(ep.resid)[o]);
  } else if (EPI == EPI_GELU_GRAD) {
    const float v = acc * gelu_grad(ep.aux[o]);
    reinterpret_cast<T*>(C)[o] = from_f32<T>(v);
    return v;
  } else if (EPI == EPI_ADD_F32) {
    reinterpret_cast<float*>(C)[o] = acc + reinterpret_cast<const float*>(ep.resid)[o];
  } else if (EPI == EPI_ADD_F32_TO_T) {
    reinterpret_cast<T*>(C)[o] =
        from_f32<T>(acc + reinterpret_cast<const float*>(ep.resid)[o]);
  } else if (EPI == EPI_STORE) {
    reinterpret_cast<T*>(C)[o] = from_f32<T>(acc);
  } else {  // EPI_PARTIAL
    reinterpret_cast<float*>(C)[(size_t)blockIdx.z * M * N + o] = acc;
  }
  return 0.0f;
}

// Four neighbouring outputs of one row, (gm, gn .. gn + 3), with their bias
// b (where the epilogue has one): 8- and 16-byte loads and stores. On return
// v holds what EPI_GELU_GRAD sums over the rows (0 outside the matrix).
struct DropRow {  // the hidden-state dropout of one token row, hoisted
  uint32_t seed = 0, idx = 0;
};

__device__ __forceinline__ DropRow drop_row(const DropSite& d, int row, int H) {
  DropRow r;
  const int blk = row / d.S / d.nb;
  r.seed = drop_step_seed(d, blk);
  r.idx = (uint32_t)(row - blk * d.nb * d.S) * (uint32_t)H;
  return r;
}

template <int EPI>
__host__ __device__ constexpr bool epi_has_bias() {
  return EPI == EPI_BIAS || EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_SAVE ||
         EPI == EPI_BIAS_RESID_F32;
}

// The four values an epilogue reads beside its accumulators at (gm, gn .. +3):
// the residual (EPI_BIAS_RESID_F32, EPI_ADD_F32, EPI_ADD_F32_TO_T) or the
// saved pre-activation (EPI_GELU_GRAD); 0 elsewhere and outside the matrix.
// Apart from epilogue4 so that a thread can have the loads of several rows
// in flight before the first store (which the compiler must assume aliases).
template <int EPI>
__device__ __forceinline__ void epilogue_operand(const EpiArgs& ep, int M, int N, int gm, int gn,
                                                 float (&in)[4]) {
  in[0] = in[1] = in[2] = in[3] = 0.0f;
  if (gm >= M || gn >= N) return;
  const size_t o = (size_t)gm * N + gn;
  if (EPI == EPI_BIAS_RESID_F32) {
    load_bf16x4(reinterpret_cast<const bf16*>(ep.resid) + o, in);
  } else if (EPI == EPI_GELU_GRAD || EPI == EPI_ADD_F32 || EPI == EPI_ADD_F32_TO_T) {
    const float* src = EPI == EPI_GELU_GRAD ? ep.aux : reinterpret_cast<const float*>(ep.resid);
    const float4 r = *reinterpret_cast<const float4*>(src + o);
    in[0] = r.x, in[1] = r.y, in[2] = r.z, in[3] = r.w;
  }
}

template <int EPI>
__device__ __forceinline__ void epilogue4(void* C, const EpiArgs& ep, int M, int N, int gm,
                                          int gn, int split, const DropRow& dr,
                                          const float4& b, const float (&in)[4],
                                          float (&v)[4]) {
  if (gm >= M || gn >= N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = 0.0f;
    return;
  }
  const size_t o = (size_t)gm * N + gn;
  if (epi_has_bias<EPI>()) v[0] += b.x, v[1] += b.y, v[2] += b.z, v[3] += b.w;
  if (EPI == EPI_BIAS) {
    store_bf16x4(reinterpret_cast<bf16*>(C) + o, v);
  } else if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_SAVE) {
    if (EPI == EPI_BIAS_GELU_SAVE)
      *reinterpret_cast<float4*>(ep.aux + o) = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = gelu_erf_bf16(v[i]);
    store_bf16x4(reinterpret_cast<bf16*>(C) + o, v);
  } else if (EPI == EPI_BIAS_RESID_F32) {
    if (ep.drop.on) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] *= drop_keep(ep.drop, dr.seed, dr.idx + (uint32_t)(gn + i), ep.drop_tag);
    }
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(C) + o) =
        make_float4(v[0] + in[0], v[1] + in[1], v[2] + in[2], v[3] + in[3]);
  } else if (EPI == EPI_GELU_GRAD) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] *= gelu_grad_bf16(in[i]);
    store_bf16x4(reinterpret_cast<bf16*>(C) + o, v);
  } else if (EPI == EPI_ADD_F32 || EPI == EPI_ADD_F32_TO_T) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] += in[i];
    if (EPI == EPI_ADD_F32)
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(C) + o) =
          make_float4(v[0], v[1], v[2], v[3]);
    else
      store_bf16x4(reinterpret_cast<bf16*>(C) + o, v);
  } else if (EPI == EPI_STORE) {
    store_bf16x4(reinterpret_cast<bf16*>(C) + o, v);
  } else {  // EPI_PARTIAL
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(C) + (size_t)split * M * N + o) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// bf16 GEMM for Hopper: persistent, warp-specialised, two consumer
// warpgroups in turns ("ping-pong"). Each block (one per SM) walks over
// 128 x 128 output tiles, n fastest so neighbouring blocks share their rows
// of A in L2. Three warpgroups:
//  - the producer (one thread of the third, its registers handed to the
//    consumers with setmaxnreg) keeps a ring of GB_STAGES k-steps of 64 in
//    flight with TMA: per stage 16 KB of A and 16 KB of B in the 128-byte
//    swizzle, their arrival counted by the stage's `full` mbarrier. The
//    ring runs on across tiles. Boxes that reach past M, N or K arrive as
//    zeros: no edge needs a branch.
//  - two consumer warpgroups take the block's tiles alternately, a whole
//    tile each: eight wgmma.m64n128k16 per stage (two 64-row halves, 128
//    f32 accumulators a thread) on the swizzled tiles where they lie — a
//    transposed operand (TA: stored (K, M); not TB: stored (K, N)) is read
//    MN-major through wgmma's transpose bit — one group of wgmma
//    kept in flight, a stage handed back through its `empty` mbarrier (one
//    arrival per warp) when the group that read it is done. While one
//    warpgroup runs its tile's epilogue the other runs the next tile's
//    products: at K = 384 an epilogue takes as long as the products, with
//    erf longer. A pair of named barriers passes the turn, so a warpgroup
//    begins to wait for its tile's first stage only after the other has
//    seen every earlier stage arrive (an mbarrier wait names a phase by its
//    parity alone, so a waiter must not run a whole ring ahead).
// The epilogue: a consumer warp writes 16 x 128 accumulators from registers
// to a slab of its own in shared memory (no block barrier) and walks it row
// by row, a lane on four neighbouring columns, so that every load
// (residual, saved pre-activation) and store is a whole row segment of 8 or
// 16 bytes a lane — written from the fragments, 16 rows a store, the stores
// took longer than the products. The operands of eight rows are loaded
// before the first store. Bias, GELU, dropout, residual or the GELU
// derivative are applied on the way. EPI_GELU_GRAD's column sums go rows (in
// a lane) → warps → one row of `colpart` per row tile, in a fixed order.
// Needs N % 4 == 0 and every row stride a multiple of 16 bytes (the
// wrappers ask H, F % 64 == 0); any M, any K.
// ---------------------------------------------------------------------------
constexpr int GB_M = 128, GB_N = 128, GB_K = 64, GB_STAGES = 4;
constexpr int GB_WG = 128;               // threads of a warpgroup
constexpr int GB_THREADS = 3 * GB_WG;    // two consumer warpgroups, then the producer's
constexpr int GB_TILE_BYTES = GB_M * GB_K * 2;       // one operand of one stage
constexpr int GB_STAGE_BYTES = 2 * GB_TILE_BYTES;
// 64 rows K-major, or one 64-wide MN-major chunk
constexpr int GB_HALF_BYTES = GB_TILE_BYTES / 2;
// a consumer warp's 16 x 128 f32 slab: rows of 136 so that the fragments'
// 8-byte writes and the rows' 16-byte reads both spread over all banks
constexpr int GB_LDS = GB_N + 8;
// ring + 1024 to align it + slabs + column-sum scratch (8 warps x 128) + barriers
constexpr int GB_SMEM = GB_STAGES * GB_STAGE_BYTES + 1024 + 8 * 16 * GB_LDS * 4 +
                        8 * GB_N * 4 + 2 * GB_STAGES * 8;
// named barriers: the turn of consumer warpgroup c, and its column sums
constexpr int GB_BAR_TURN = 1, GB_BAR_COLSUM = 3;

template <int EPI, bool TA, bool TB>
__global__ void __launch_bounds__(GB_THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, void* __restrict__ C, int M, int N,
                 int K, int k_chunk, int splits, EpiArgs ep) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  unsigned char* after = gemm_smem + (ring - smem_u32(gemm_smem)) + GB_STAGES * GB_STAGE_BYTES;
  float* slabs = reinterpret_cast<float*>(after);                   // [8][16][GB_LDS]
  float* colred = slabs + 8 * 16 * GB_LDS;                          // [8][GB_N]
  const uint32_t full = smem_u32(colred + 8 * GB_N);                // [GB_STAGES]
  const uint32_t empty = full + GB_STAGES * 8;                      // [GB_STAGES]

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < GB_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, GB_WG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int tiles_n = (N + GB_N - 1) / GB_N, tiles_m = (M + GB_M - 1) / GB_M;
  const int per_split = tiles_m * tiles_n, ntiles = per_split * splits;

  if (tid >= 2 * GB_WG) {
    // ---- producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 2 * GB_WG) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int split = tile / per_split, mn = tile - split * per_split;
        const int m0 = (mn / tiles_n) * GB_M, n0 = (mn % tiles_n) * GB_N;
        const int kbeg = split * k_chunk, kend = min(K, kbeg + k_chunk);
        for (int k0 = kbeg; k0 < kend; k0 += GB_K) {
          mbar_wait(empty + 8 * stage, phase ^ 1u);
          const uint32_t bar = full + 8 * stage;
          const uint32_t a_dst = ring + stage * GB_STAGE_BYTES, b_dst = a_dst + GB_TILE_BYTES;
          mbar_expect_tx(bar, GB_STAGE_BYTES);
          if (TA) {  // stored (K, M): two boxes of 64 k-lines x 64 m
            tma_load(a_dst, &map_a, bar, m0, k0);
            tma_load(a_dst + GB_HALF_BYTES, &map_a, bar, m0 + 64, k0);
          } else {   // stored (M, K): one box of 128 m-lines x 64 k
            tma_load(a_dst, &map_a, bar, k0, m0);
          }
          if (TB) {  // stored (N, K): one box of 128 n-lines x 64 k
            tma_load(b_dst, &map_b, bar, k0, n0);
          } else {   // stored (K, N): two boxes of 64 k-lines x 64 n
            tma_load(b_dst, &map_b, bar, n0, k0);
            tma_load(b_dst + GB_HALF_BYTES, &map_b, bar, n0 + 64, k0);
          }
          if (++stage == GB_STAGES) stage = 0, phase ^= 1u;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw takes the block's tiles cw, cw + 2, ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = tid >> 7, lane = tid & 31, warp = tid >> 5, ww = warp & 3;
    const int frag_row = lane >> 2, frag_col = (lane & 3) << 1;  // of an accumulator fragment
    float* slab = slabs + warp * 16 * GB_LDS;
    float d[2][64];  // rows 0 .. 63 and 64 .. 127 of the tile
    if (cw == 1) named_barrier_arrive(GB_BAR_TURN, 2 * GB_WG);  // warpgroup 0 goes first
    int it = 0;      // k-steps the block has consumed: the ring position
    int nth = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++nth) {
      const int split = tile / per_split, mn = tile - split * per_split;
      const int mt = mn / tiles_n;
      const int m0 = mt * GB_M, n0 = (mn % tiles_n) * GB_N;
      const int kbeg = split * k_chunk, kend = min(K, kbeg + k_chunk);
      const int nk = kend > kbeg ? (kend - kbeg + GB_K - 1) / GB_K : 0;
      if ((nth & 1) != cw) {  // the other warpgroup's tile
        it += nk;
        continue;
      }
      if (nk == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) d[0][i] = d[1][i] = 0.0f;
      }
      named_barrier(GB_BAR_TURN + cw, 2 * GB_WG);  // my turn at the tensor cores
      int prev = -1;
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int stage = it % GB_STAGES;
        mbar_wait(full + 8 * stage, (it / GB_STAGES) & 1);
        const uint32_t a_src = ring + stage * GB_STAGE_BYTES;
        const uint32_t b_src = a_src + GB_TILE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GB_K / 16; ++kk) {
          const uint32_t a_k = a_src + kk * (TA ? 2048 : 32);
          const uint64_t db = wgmma_desc(b_src + kk * (TB ? 32 : 2048), GB_HALF_BYTES, 1024);
          const int acc = (ks > 0 || kk > 0) ? 1 : 0;
          wgmma_m64n128k16<TA ? 1 : 0, TB ? 0 : 1>(
              d[0], wgmma_desc(a_k, GB_HALF_BYTES, 1024), db, acc);
          wgmma_m64n128k16<TA ? 1 : 0, TB ? 0 : 1>(
              d[1], wgmma_desc(a_k + GB_HALF_BYTES, GB_HALF_BYTES, 1024), db, acc);
        }
        wgmma_commit();
        if (prev >= 0) {  // the group before this one is done with its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
      }
      named_barrier_arrive(GB_BAR_TURN + (cw ^ 1), 2 * GB_WG);  // the other's turn
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);

      const int gn = n0 + 4 * lane;
      float4 bias4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (epi_has_bias<EPI>() && gn < N) bias4 = *reinterpret_cast<const float4*>(ep.bias + gn);
      float colsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // 16 x 128 accumulators → the warp's slab, then row by row: a lane
        // takes columns 4·lane .. + 3 of every row
        const int row0 = m0 + 64 * h + 16 * ww;
#pragma unroll
        for (int j = 0; j < GB_N / 8; ++j) {
          *reinterpret_cast<float2*>(slab + frag_row * GB_LDS + 8 * j + frag_col) =
              make_float2(d[h][4 * j], d[h][4 * j + 1]);
          *reinterpret_cast<float2*>(slab + (frag_row + 8) * GB_LDS + 8 * j + frag_col) =
              make_float2(d[h][4 * j + 2], d[h][4 * j + 3]);
        }
        __syncwarp();
#pragma unroll
        for (int i0 = 0; i0 < 16; i0 += 8) {  // eight rows' loads in flight
          float in[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            epilogue_operand<EPI>(ep, M, N, row0 + i0 + i, gn, in[i]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int gm = row0 + i0 + i;
            const float4 acc =
                *reinterpret_cast<const float4*>(slab + (i0 + i) * GB_LDS + 4 * lane);
            float e[4] = {acc.x, acc.y, acc.z, acc.w};
            DropRow dr;
            if (EPI == EPI_BIAS_RESID_F32 && ep.drop.on && gm < M) dr = drop_row(ep.drop, gm, N);
            epilogue4<EPI>(C, ep, M, N, gm, gn, split, dr, bias4, in[i], e);
            if (EPI == EPI_GELU_GRAD) {
#pragma unroll
              for (int k = 0; k < 4; ++k) colsum[k] += e[k];
            }
          }
        }
        __syncwarp();  // the slab is free again
      }
      if (EPI == EPI_GELU_GRAD) {
        float* mine = colred + cw * 4 * GB_N;  // [4 warps][GB_N]
        *reinterpret_cast<float4*>(mine + ww * GB_N + 4 * lane) =
            make_float4(colsum[0], colsum[1], colsum[2], colsum[3]);
        named_barrier(GB_BAR_COLSUM + cw, GB_WG);
        const int c = tid & (GB_WG - 1);
        if (n0 + c < N)
          ep.colpart[(size_t)mt * N + n0 + c] =
              mine[c] + mine[GB_N + c] + mine[2 * GB_N + c] + mine[3 * GB_N + c];
        named_barrier(GB_BAR_COLSUM + cw, GB_WG);  // colred is free for the next tile
      }
    }
  }
}

// the wrappers' limits: S ≤ kSmallSeq runs the one-block-per-(sequence,
// head) attention kernels, up to kMaxSeq the key-blocked ones
constexpr int kSmallSeq = 128, kMaxSeq = 512, kMaxHeadDim = 64;

// ---------------------------------------------------------------------------
// f32 GEMM on the FMA units (the comparison path: tensor-core TF32 would not
// hold an f32 tolerance). Block tile 64x64, k-step 16, 256 threads each
// computing 4x4 outputs. Needs N % 64 == 0.
// ---------------------------------------------------------------------------
template <int EPI, bool TA, bool TB>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W, void* __restrict__ C,
                int M, int N, int K, int k_chunk, EpiArgs ep) {
  __shared__ float As[16][64 + 4];  // k-major
  __shared__ float Bs[16][64];
  __shared__ float red[16][64];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int kbeg = blockIdx.z * k_chunk, kend = min(K, kbeg + k_chunk);
  float acc[4][4] = {};
  for (int k0 = kbeg; k0 < kend; k0 += 16) {
    for (int i = tid; i < 64 * 16; i += 256) {
      int r, c;
      if (TA) { c = i >> 6; r = i & 63; } else { r = i >> 4; c = i & 15; }
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.0f;
      if (gm < M && gk < kend) v = TA ? A[(size_t)gk * M + gm] : A[(size_t)gm * K + gk];
      As[c][r] = v;
    }
    for (int i = tid; i < 16 * 64; i += 256) {
      int r, c;
      if (TB) { c = i >> 4; r = i & 15; } else { r = i >> 6; c = i & 63; }
      const int gk = k0 + r;
      float v = 0.0f;
      if (gk < kend) v = TB ? W[(size_t)(n0 + c) * K + gk] : W[(size_t)gk * N + n0 + c];
      Bs[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float colsum[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      colsum[j] += epilogue<float, EPI>(C, ep, M, N, gm, n0 + tx + 16 * j, acc[i][j]);
  }
  if (EPI == EPI_GELU_GRAD) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][tx + 16 * j] = colsum[j];
    __syncthreads();
    if (tid < 64) {
      float s = 0.0f;
      for (int y = 0; y < 16; ++y) s += red[y][tid];
      ep.colpart[(size_t)blockIdx.y * N + n0 + tid] = s;
    }
  }
}

template <typename T>
constexpr int gemm_tile_m() { return std::is_same<T, bf16>::value ? GB_M : 64; }

// Row tiles of an (M, N) GEMM output: the row count of a colpart buffer.
template <typename T>
int gemm_row_tiles(int M) { return (M + gemm_tile_m<T>() - 1) / gemm_tile_m<T>(); }

// Split-K for the weight gradients (K = B·S tokens, few output tiles), each
// split at least 512 rows. f32: enough splits for about two blocks per SM.
// bf16: as many as keep tiles x splits within one wave of the persistent
// grid (132 SMs on the H100; a constant, so the workspace size does not
// depend on the device).
template <typename T>
int gemm_splits(int M, int N, int K) {
  const int most = K / 512 > 1 ? K / 512 : 1;
  int s;
  if (std::is_same<T, bf16>::value) {
    s = 132 / (((N + GB_N - 1) / GB_N) * gemm_row_tiles<T>(M));
  } else {
    const int tiles = (N / 64) * gemm_row_tiles<T>(M);
    s = (264 + tiles - 1) / tiles;
  }
  return s < 1 ? 1 : (s > most ? most : s);
}

template <typename T, int EPI, bool TA = false, bool TB = false>
int launch_gemm(const T* A, const T* W, void* C, int M, int N, int K, const EpiArgs& ep,
                cudaStream_t st, int splits = 1) {
  int k_chunk = (K + splits - 1) / splits;
  if constexpr (std::is_same<T, bf16>::value) {
    static std::atomic<uint64_t> done{0};
    k_chunk = (k_chunk + GB_K - 1) / GB_K * GB_K;
    CUtensorMap map_a, map_b;
    const bool ok = (TA ? make_tensor_map(&map_a, A, K, M, 64)
                        : make_tensor_map(&map_a, A, M, K, GB_M)) &&
                    (TB ? make_tensor_map(&map_b, W, N, K, GB_N)
                        : make_tensor_map(&map_b, W, K, N, 64));
    if (!ok) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(gemm_bf16_kernel<EPI, TA, TB>, GB_SMEM, done);
    if (e != cudaSuccess) return (int)e;
    const int tiles = ((N + GB_N - 1) / GB_N) * gemm_row_tiles<T>(M) * splits;
    const int grid = tiles < sm_count() ? tiles : sm_count();
    gemm_bf16_kernel<EPI, TA, TB><<<grid, GB_THREADS, GB_SMEM, st>>>(map_a, map_b, C, M, N, K,
                                                                      k_chunk, splits, ep);
  } else {
    k_chunk = (k_chunk + 31) / 32 * 32;  // a multiple of the f32 kernel's k-step
    dim3 grid(N / 64, gemm_row_tiles<T>(M), splits);
    gemm_f32_kernel<EPI, TA, TB><<<grid, 256, 0, st>>>(A, W, C, M, N, K, k_chunk, ep);
  }
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// out[c] = sum over r of part[r * ncols + c], in a fixed order. Block: 32
// columns x 8 row phases; grid over the columns. (static: each translation
// unit that includes this header keeps its own copy.)
static __global__ void __launch_bounds__(256)
sum_rows_kernel(const float* __restrict__ part, int nrows, int ncols, float* __restrict__ out) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.0f;
  if (c < ncols)
    for (int r = ty; r < nrows; r += 8) s += part[(size_t)r * ncols + c];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < ncols) {
    float t = 0.0f;
#pragma unroll
    for (int y = 0; y < 8; ++y) t += red[y][tx];
    out[c] = t;
  }
}

inline int launch_sum_rows(const float* part, int nrows, int ncols, float* out,
                           cudaStream_t st) {
  sum_rows_kernel<<<(ncols + 31) / 32, 256, 0, st>>>(part, nrows, ncols, out);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// A weight gradient C(M, N) = A_storedᵀ · B over K token rows, split-K into
// the f32 workspace, then summed in order into out.
template <typename T>
int launch_weight_grad(const T* A, const T* B, float* out, float* ws, int M, int N, int K,
                       cudaStream_t st) {
  const int splits = gemm_splits<T>(M, N, K);
  int err = launch_gemm<T, EPI_PARTIAL, true, false>(A, B, ws, M, N, K, EpiArgs{}, st, splits);
  if (err) return err;
  return launch_sum_rows(ws, splits, M * N, out, st);
}

// ---------------------------------------------------------------------------
// The (S, S) relative-bias rows of head h (MPNet: (nh·S, S) f32, shared by
// every sequence); a row past S is clamped to the last, for query rows that
// pad a tile and are never stored.
__device__ __forceinline__ const float* rel_row(const float* rel, int h, int row, int S) {
  return rel + ((size_t)h * S + (row < S ? row : S - 1)) * S;
}

// f32 attention forward (SIMT): one block per (head, sequence). qkv is (B·S, 3H) with
// q, k, v at column offsets 0, H, 2H; ctx is (B·S, H). Shared memory holds
// Q, K (rows padded by one float against bank conflicts), V, the (S, S)
// scores and the sequence's mask bias, all f32 (S ≤ 128). With REL the
// head's relative-bias row is added after scale and mask bias. Attention dropout (tag
// 16 + (b % nb)·heads + h, element q·S + k) scales the probabilities after
// the softmax and before their bf16 cast, as in the TPU kernel.
// ---------------------------------------------------------------------------
template <typename T, bool REL>
__global__ void __launch_bounds__(256)
attention_kernel(const T* __restrict__ qkv, const float* __restrict__ mask_bias,
                 const float* __restrict__ rel, T* __restrict__ ctx, int S, int H, int hd,
                 float scale, DropSite ad) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, b = blockIdx.y, nh = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  float* Qs = sm;
  float* Ks = Qs + S * hd;
  float* Vs = Ks + S * (hd + 1);
  float* Ps = Vs + S * hd;
  float* bias_s = Ps + S * S;

  const T* base = qkv + (size_t)b * S * 3 * H + h * hd;
  for (int i = tid; i < S * hd; i += nthreads) {
    int r = i / hd, d = i % hd;
    const T* p = base + (size_t)r * 3 * H + d;
    Qs[r * hd + d] = to_f32(p[0]);
    Ks[r * (hd + 1) + d] = to_f32(p[H]);
    Vs[r * hd + d] = to_f32(p[2 * H]);
  }
  for (int j = tid; j < S; j += nthreads) bias_s[j] = mask_bias[(size_t)b * S + j];
  __syncthreads();

  for (int i = tid; i < S * S; i += nthreads) {
    int r = i / S, c = i % S;
    const float* q = Qs + r * hd;
    const float* k = Ks + c * (hd + 1);
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) acc = fmaf(q[d], k[d], acc);
    Ps[i] = acc * scale + bias_s[c];
    if (REL) Ps[i] += rel_row(rel, h, r, S)[c];
  }
  __syncthreads();

  const uint32_t seed = ad.on ? drop_step_seed(ad, b / ad.nb) : 0u;
  const uint32_t tag = ad.on ? 16u + (uint32_t)((b % ad.nb) * nh + h) : 0u;
  // softmax in f32, one warp per row; a fully masked row (all -1e9) comes
  // out uniform and finite, like the TPU kernel's padded rows
  for (int r = warp; r < S; r += nwarps) {
    float* row = Ps + r * S;
    float m = -INFINITY;
    for (int c = lane; c < S; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float s = 0.0f;
    for (int c = lane; c < S; c += 32) {
      float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int c = lane; c < S; c += 32) {
      float p = row[c] / s;
      if (ad.on) p *= drop_keep(ad, seed, (uint32_t)(r * S + c), tag);
      row[c] = to_f32(from_f32<T>(p));
    }
  }
  __syncthreads();

  for (int i = tid; i < S * hd; i += nthreads) {
    int r = i / hd, d = i % hd;
    const float* p = Ps + r * S;
    float acc = 0.0f;
    for (int c = 0; c < S; ++c) acc = fmaf(p[c], Vs[c * hd + d], acc);
    ctx[((size_t)b * S + r) * H + h * hd + d] = from_f32<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// bf16 attention forward on the tensor cores: one block per (head,
// sequence), eight warps of 16 query rows each (a warp whose rows all lie
// past S idles). Q, K and V sit in shared memory as bf16 rows of HD + 8
// values (the 16 bytes of padding spread ldmatrix's eight row addresses
// over all banks), loaded once with 16-byte cp.async from qkv's strided
// columns; rows from S up to S_pad, the next multiple of 16, are zeros.
// S = Q·Kᵀ runs as mma.sync.m16n8k16 with every key column of a query row in
// one quad's registers (S ≤ 128: 64 f32 a thread), so the softmax is the
// exact two-pass one of the f32 kernel, in registers: scale + mask bias
// (padding columns then set to -inf, after the bias, so a fully masked row
// stays uniform over its S real columns), row maximum and sum by quad
// shuffles, p = e / sum (ex2-based __expf and one reciprocal per row: both
// within 1e-6, far below the bf16 cast), dropout, the bf16 cast. The
// probabilities never touch shared memory: two neighbouring accumulators are
// the A operand of P·V as they lie, and V is read through ldmatrix.trans.
// ---------------------------------------------------------------------------
constexpr int ATT_PAD = 8;

// f32 probabilities (before dropout) of the warp's 16 query rows q0 .. q0+15
// against all keys. p[nb] is the accumulator of key columns 8nb .. 8nb + 7
// (see mma_m16n8k16 for its layout); blocks from S_pad / 8 up are untouched.
// With REL, rel_a and rel_b are the relative-bias rows of query rows
// q0 + lane/4 and eight below, added after scale and mask bias as the TPU
// kernel adds them (fused_layer_pallas.py:153-155).
template <int HD, bool REL>
__device__ __forceinline__ void attention_probs(float (&p)[16][4], const bf16* Qs,
                                                const bf16* Ks, const float* bias_s,
                                                const float* rel_a, const float* rel_b, int q0,
                                                int S, int S_pad, float scale, int lane) {
  constexpr int LD = HD + ATT_PAD;
  const int t2 = (lane & 3) * 2;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qa[kk], Qs + (q0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
  for (int nb2 = 0; nb2 < 8; ++nb2) {  // 16 keys at a time
    if (nb2 * 16 < S_pad) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[2 * nb2][i] = p[2 * nb2 + 1][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Ks + (nb2 * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_m16n8k16(p[2 * nb2], qa[kk], kb[0], kb[1]);
        mma_m16n8k16(p[2 * nb2 + 1], qa[kk], kb[2], kb[3]);
      }
    }
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // rows q0 + lane/4 and eight below
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    if (nb * 8 < S_pad) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nb * 8 + t2 + e;
        const float bias = c < S ? bias_s[c] : 0.0f;
        p[nb][e] = c < S ? p[nb][e] * scale + bias : -INFINITY;
        p[nb][2 + e] = c < S ? p[nb][2 + e] * scale + bias : -INFINITY;
        if (REL && c < S) p[nb][e] += rel_a[c], p[nb][2 + e] += rel_b[c];
        m0 = fmaxf(m0, p[nb][e]);
        m1 = fmaxf(m1, p[nb][2 + e]);
      }
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    if (nb * 8 < S_pad) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nb][e] = __expf(p[nb][e] - m0);
        p[nb][2 + e] = __expf(p[nb][2 + e] - m1);
        s0 += p[nb][e];
        s1 += p[nb][2 + e];
      }
    }
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  const float r0 = 1.0f / s0, r1 = 1.0f / s1;
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    if (nb * 8 < S_pad) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nb][e] *= r0;
        p[nb][2 + e] *= r1;
      }
    }
  }
}

// rows 0 .. S-1 of one head's (S, HD) slice (row stride ld_src) into shared
// rows of HD + ATT_PAD, rows S .. S_pad-1 zeroed; complete after
// cp_async_wait_all and a barrier
template <int HD>
__device__ __forceinline__ void load_head_async(bf16* dst, const bf16* __restrict__ src,
                                                size_t ld_src, int S, int S_pad) {
  constexpr int LD = HD + ATT_PAD, CH = HD / 8;
  for (int i = threadIdx.x; i < S_pad * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * 8;
    if (r < S) cp_async16(dst + r * LD + c, src + (size_t)r * ld_src + c);
    else *reinterpret_cast<uint4*>(dst + r * LD + c) = make_uint4(0, 0, 0, 0);
  }
}

// acc (+)= A · B for A = 16 rows x 16 k in registers and B = 16 k-rows of
// `rows` (k-row stride ld, columns col0 .. col0 + HD - 1), read transposed
template <int HD>
__device__ __forceinline__ void mma_rows_trans(float (&acc)[HD / 8][4], const uint32_t (&a)[4],
                                               const bf16* rows, int ld, int lane) {
#pragma unroll
  for (int nb2 = 0; nb2 < HD / 16; ++nb2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, rows + ((((lane >> 3) & 1) << 3) + (lane & 7)) * ld + nb2 * 16 +
                             (lane >> 4) * 8);
    mma_m16n8k16(acc[2 * nb2], a, b[0], b[1]);
    mma_m16n8k16(acc[2 * nb2 + 1], a, b[2], b[3]);
  }
}

// the warp's 16 x HD accumulators → bf16 rows of dst (row stride ld), rows
// row0 + 0..15 below `rows_end` only, as 8-byte stores
template <int HD>
__device__ __forceinline__ void store_rows_bf16(bf16* dst, size_t ld, const float (&acc)[HD / 8][4],
                                                int row0, int rows_end, int lane) {
  const int r = row0 + (lane >> 2) + ((lane & 1) << 3);
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
    float e[4];
    quad_regroup(acc[nb][0], acc[nb][1], acc[nb][2], acc[nb][3], lane, e);
    if (r < rows_end) store_bf16x4(dst + (size_t)r * ld + nb * 8 + ((lane & 2) << 1), e);
  }
}

template <int HD, bool REL>
__global__ void __launch_bounds__(256)
attention_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask_bias,
                     const float* __restrict__ rel, bf16* __restrict__ ctx, int S, int H,
                     float scale, DropSite ad) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  constexpr int LD = HD + ATT_PAD;
  const int h = blockIdx.x, b = blockIdx.y, nh = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S_pad = (S + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(att_smem);
  bf16* Ks = Qs + S_pad * LD;
  bf16* Vs = Ks + S_pad * LD;
  float* bias_s = reinterpret_cast<float*>(Vs + S_pad * LD);

  const bf16* base = qkv + (size_t)b * S * 3 * H + h * HD;
  load_head_async<HD>(Qs, base, 3 * H, S, S_pad);
  load_head_async<HD>(Ks, base + H, 3 * H, S, S_pad);
  load_head_async<HD>(Vs, base + 2 * H, 3 * H, S, S_pad);
  for (int j = tid; j < S; j += 256) bias_s[j] = mask_bias[(size_t)b * S + j];
  cp_async_wait_all();
  __syncthreads();

  const int q0 = warp * 16;
  if (q0 >= S_pad) return;
  float p[16][4];
  const float* rel_a = REL ? rel_row(rel, h, q0 + (lane >> 2), S) : nullptr;
  const float* rel_b = REL ? rel_row(rel, h, q0 + (lane >> 2) + 8, S) : nullptr;
  attention_probs<HD, REL>(p, Qs, Ks, bias_s, rel_a, rel_b, q0, S, S_pad, scale, lane);
  if (ad.on) {
    const uint32_t seed = drop_step_seed(ad, b / ad.nb);
    const uint32_t tag = 16u + (uint32_t)((b % ad.nb) * nh + h);
    const uint32_t i0 = (uint32_t)((q0 + (lane >> 2)) * S + (lane & 3) * 2);
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      if (nb * 8 < S_pad) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[nb][e] *= drop_keep(ad, seed, i0 + nb * 8 + e, tag);
          p[nb][2 + e] *= drop_keep(ad, seed, i0 + 8 * S + nb * 8 + e, tag);
        }
      }
    }
  }
  float o[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nb][i] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {  // 16 keys at a time
    if (kt * 16 < S_pad) {
      const uint32_t a[4] = {pack_bf16(p[2 * kt][0], p[2 * kt][1]),
                             pack_bf16(p[2 * kt][2], p[2 * kt][3]),
                             pack_bf16(p[2 * kt + 1][0], p[2 * kt + 1][1]),
                             pack_bf16(p[2 * kt + 1][2], p[2 * kt + 1][3])};
      mma_rows_trans<HD>(o, a, Vs + kt * 16 * LD, LD, lane);
    }
  }
  store_rows_bf16<HD>(ctx + (size_t)b * S * H + h * HD, H, o, q0, S, lane);
}

inline size_t attention_mma_smem_bytes(int S, int hd) {
  const int S_pad = (S + 15) & ~15;
  return (size_t)3 * S_pad * (hd + ATT_PAD) * sizeof(bf16) + S_pad * sizeof(float);
}

template <int HD, bool REL>
int launch_attention_mma(const bf16* qkv, const float* mask_bias, const float* rel, bf16* ctx,
                         int B, int S, int H, int nh, const DropSite& ad, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  cudaError_t e = allow_smem(attention_mma_kernel<HD, REL>,
                             attention_mma_smem_bytes(kSmallSeq, HD), done);
  if (e != cudaSuccess) return (int)e;
  attention_mma_kernel<HD, REL><<<dim3(nh, B), 256, attention_mma_smem_bytes(S, HD), st>>>(
      qkv, mask_bias, rel, ctx, S, H, 1.0f / sqrtf((float)HD), ad);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// LayerNorm with f32 statistics over rows of an f32 (M, H) buffer, one warp
// per row, H ≤ 1024 held in registers.
template <typename T>
__global__ void __launch_bounds__(256)
layernorm_kernel(const float* __restrict__ in, const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ out, int M, int H,
                 float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const float* x = in + (size_t)row * H;
  float v[32];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int c = lane + 32 * i;
    v[i] = c < H ? x[c] : 0.0f;
    s += v[i];
  }
  const float mean = warp_sum(s) / H;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int c = lane + 32 * i;
    float d = c < H ? v[i] - mean : 0.0f;
    q += d * d;
  }
  const float inv = rsqrtf(warp_sum(q) / H + eps);
  T* o = out + (size_t)row * H;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int c = lane + 32 * i;
    if (c < H) o[c] = from_f32<T>((v[i] - mean) * inv * gamma[c] + beta[c]);
  }
}

inline size_t attention_smem_bytes(int S, int hd) {
  return (size_t)(S * hd + S * (hd + 1) + S * hd + S * S + S) * sizeof(float);
}

// defined in attention_kb.cuh (included by the sources after this header)
template <typename T, bool REL>
int launch_attention_kb(const T* qkv, const float* mask_bias, const float* rel, T* ctx, int B,
                        int S, int H, int nh, const DropSite& ad, cudaStream_t st);

template <typename T, bool REL>
int launch_attention_small(const T* qkv, const float* mask_bias, const float* rel, T* ctx, int B,
                           int S, int H, int nh, const DropSite& ad, cudaStream_t st) {
  const int hd = H / nh;
  if constexpr (std::is_same<T, bf16>::value) {
#define QST_SMALL(HD) launch_attention_mma<HD, REL>(qkv, mask_bias, rel, ctx, B, S, H, nh, ad, st)
    if (hd == 16) return QST_SMALL(16);
    if (hd == 32) return QST_SMALL(32);
    if (hd == 64) return QST_SMALL(64);
#undef QST_SMALL
    return (int)cudaErrorInvalidValue;
  } else {
    static std::atomic<uint64_t> done{0};
    cudaError_t e = allow_smem(attention_kernel<T, REL>,
                               attention_smem_bytes(kSmallSeq, kMaxHeadDim), done);
    if (e != cudaSuccess) return (int)e;
    attention_kernel<T, REL><<<dim3(nh, B), 256, attention_smem_bytes(S, hd), st>>>(
        qkv, mask_bias, rel, ctx, S, H, hd, 1.0f / sqrtf((float)hd), ad);
    QST_RETURN_IF_LAUNCH_FAILED();
    return 0;
  }
}

// The attention forward of K1 (and of K2's recompute): for S ≤ 128 the
// one-block-per-(sequence, head) kernels above, the relative bias a template
// flag (so BERT's instantiation is the one it always was); for 128 < S ≤ 512
// the key-blocked kernels of attention_kb.cuh.
template <typename T>
int launch_attention(const T* qkv, const float* mask_bias, const float* rel, T* ctx, int B,
                     int S, int H, int nh, const DropSite& ad, cudaStream_t st) {
  if (S > kSmallSeq) {
    if (rel) return launch_attention_kb<T, true>(qkv, mask_bias, rel, ctx, B, S, H, nh, ad, st);
    return launch_attention_kb<T, false>(qkv, mask_bias, rel, ctx, B, S, H, nh, ad, st);
  }
  if (rel) return launch_attention_small<T, true>(qkv, mask_bias, rel, ctx, B, S, H, nh, ad, st);
  return launch_attention_small<T, false>(qkv, mask_bias, rel, ctx, B, S, H, nh, ad, st);
}

template <typename T>
int launch_layernorm(const float* in, const float* gamma, const float* beta, T* out, int M,
                     int H, float eps, cudaStream_t st) {
  layernorm_kernel<T><<<(M + 7) / 8, 256, 0, st>>>(in, gamma, beta, out, M, H, eps);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// Dropout arguments of the C entry points → one site
inline DropSite drop_site(const void* seed, int on, unsigned thr, float scale, int nb, int S) {
  DropSite d;
  d.seed = reinterpret_cast<const int*>(seed);
  d.on = on && seed != nullptr;
  d.thr = thr;
  d.scale = scale;
  d.nb = nb > 0 ? nb : 1;
  d.S = S;
  return d;
}

}  // namespace qst
