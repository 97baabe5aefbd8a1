// Device code shared by K1 (fused_layer.cu) and K2 (fused_layer_bwd.cu):
// the tiled GEMMs and their epilogues, the attention forward, LayerNorm and
// a deterministic sum over the rows of a partial-sum matrix. Header-only
// templates: each translation unit instantiates what it launches.
//
// GEMM operands: C(M, N) = op(A)(M, K) · op(B)(K, N). A is stored (M, K)
// row-major, or with TA (K, M) — the "xᵀ·dy" of a weight gradient, where K
// is the token count; B is stored (K, N), or with TB (N, K) — the "dy·Wᵀ" of
// an input gradient. blockIdx.z takes one k_chunk of K (split-K): the
// EPI_PARTIAL epilogue writes one f32 partial per split, summed afterwards
// in a fixed order by sum_rows_kernel, so a weight gradient is the same on
// every run (no atomics).
#pragma once

#include <mma.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace qst {

using namespace nvcuda;

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

// ---------------------------------------------------------------------------
// bf16 GEMM on the tensor cores. Block tile 128x64, k-step 32, 8 warps as
// 4 (M) x 2 (N), each warp 32x32 as 2x2 wmma 16x16x16 fragments (f32
// accumulation). A transposed operand is staged as its stored rows and read
// as a col_major fragment, so every load is 16 bytes. Needs N % 64 == 0;
// K % 32 == 0 unless TA (K then is masked row by row); M % 8 == 0 with TA.
// ---------------------------------------------------------------------------
constexpr int GB_M = 128, GB_N = 64, GB_K = 32;
constexpr int GB_LDA = GB_K + 8, GB_LDAT = GB_M + 8, GB_LDB = GB_N + 8, GB_LDBT = GB_K + 8;
constexpr int GB_LDC = GB_N + 4;
constexpr int GB_A = GB_M * GB_LDA > GB_K * GB_LDAT ? GB_M * GB_LDA : GB_K * GB_LDAT;
constexpr int GB_B = GB_K * GB_LDB > GB_N * GB_LDBT ? GB_K * GB_LDB : GB_N * GB_LDBT;
constexpr int GB_SMEM_AB = (GB_A + GB_B) * 2;
constexpr int GB_SMEM_C = GB_M * GB_LDC * 4;
constexpr int GB_SMEM = GB_SMEM_AB > GB_SMEM_C ? GB_SMEM_AB : GB_SMEM_C;

template <int EPI, bool TA, bool TB>
__global__ void __launch_bounds__(256)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, void* __restrict__ C,
                 int M, int N, int K, int k_chunk, EpiArgs ep) {
  __shared__ __align__(128) unsigned char smem[GB_SMEM];
  __shared__ float red[256];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + GB_A;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the main loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  const int kbeg = blockIdx.z * k_chunk, kend = min(K, kbeg + k_chunk);
  using LA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = kbeg; k0 < kend; k0 += GB_K) {
    if (!TA) {  // 128 rows (m) x 4 chunks of 8 (k)
      for (int i = tid; i < GB_M * (GB_K / 8); i += 256) {
        int r = i >> 2, c = (i & 3) * 8, gm = m0 + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gm < M) v = *reinterpret_cast<const uint4*>(A + (size_t)gm * K + k0 + c);
        *reinterpret_cast<uint4*>(As + r * GB_LDA + c) = v;
      }
    } else {    // stored (K, M): 32 rows (k) x 16 chunks of 8 (m)
      for (int i = tid; i < GB_K * (GB_M / 8); i += 256) {
        int r = i >> 4, c = (i & 15) * 8, gk = k0 + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gk < kend && m0 + c < M)
          v = *reinterpret_cast<const uint4*>(A + (size_t)gk * M + m0 + c);
        *reinterpret_cast<uint4*>(As + r * GB_LDAT + c) = v;
      }
    }
    if (!TB) {  // 32 rows (k) x 8 chunks (n)
      for (int i = tid; i < GB_K * (GB_N / 8); i += 256) {
        int r = i >> 3, c = (i & 7) * 8, gk = k0 + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gk < kend) v = *reinterpret_cast<const uint4*>(W + (size_t)gk * N + n0 + c);
        *reinterpret_cast<uint4*>(Bs + r * GB_LDB + c) = v;
      }
    } else {    // stored (N, K): 64 rows (n) x 4 chunks (k)
      for (int i = tid; i < GB_N * (GB_K / 8); i += 256) {
        int r = i >> 2, c = (i & 3) * 8;
        *reinterpret_cast<uint4*>(Bs + r * GB_LDBT + c) =
            *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + c);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GB_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16;
        if (TA) wmma::load_matrix_sync(a[i], As + kk * GB_LDAT + r, GB_LDAT);
        else wmma::load_matrix_sync(a[i], As + r * GB_LDA + kk, GB_LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        if (TB) wmma::load_matrix_sync(b[j], Bs + c * GB_LDBT + kk, GB_LDBT);
        else wmma::load_matrix_sync(b[j], Bs + kk * GB_LDB + c, GB_LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * GB_LDC + wn * 32 + j * 16,
                              acc[i][j], GB_LDC, wmma::mem_row_major);
  __syncthreads();
  // thread tid always has column tid % 64: its column sum runs over its rows
  float colsum = 0.0f;
  for (int i = tid; i < GB_M * GB_N; i += 256) {
    int r = i / GB_N, c = i % GB_N, gm = m0 + r;
    if (gm >= M) continue;
    colsum += epilogue<bf16, EPI>(C, ep, M, N, gm, n0 + c, Cs[r * GB_LDC + c]);
  }
  if (EPI == EPI_GELU_GRAD) {
    red[tid] = colsum;
    __syncthreads();
    if (tid < GB_N)
      ep.colpart[(size_t)blockIdx.y * N + n0 + tid] =
          red[tid] + red[tid + 64] + red[tid + 128] + red[tid + 192];
  }
}

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

// Split-K for the weight gradients (K = B·S tokens, few output tiles):
// enough splits for about two blocks per SM, each split at least 512 rows.
template <typename T>
int gemm_splits(int M, int N, int K) {
  const int tiles = (N / 64) * gemm_row_tiles<T>(M);
  int s = (264 + tiles - 1) / tiles;
  const int most = K / 512 > 1 ? K / 512 : 1;
  return s < 1 ? 1 : (s > most ? most : s);
}

template <typename T, int EPI, bool TA = false, bool TB = false>
int launch_gemm(const T* A, const T* W, void* C, int M, int N, int K, const EpiArgs& ep,
                cudaStream_t st, int splits = 1) {
  int k_chunk = (K + splits - 1) / splits;
  k_chunk = (k_chunk + GB_K - 1) / GB_K * GB_K;  // a multiple of both k-steps
  dim3 grid(N / 64, gemm_row_tiles<T>(M), splits);
  if constexpr (std::is_same<T, bf16>::value) {
    gemm_bf16_kernel<EPI, TA, TB><<<grid, 256, 0, st>>>(A, W, C, M, N, K, k_chunk, ep);
  } else {
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
// Attention forward: one block per (head, sequence). qkv is (B·S, 3H) with
// q, k, v at column offsets 0, H, 2H; ctx is (B·S, H). Shared memory holds
// Q, K (rows padded by one float against bank conflicts), V, the (S, S)
// scores and the sequence's mask bias, all f32. Attention dropout (tag
// 16 + (b % nb)·heads + h, element q·S + k) scales the probabilities after
// the softmax and before their bf16 cast, as in the TPU kernel.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
attention_kernel(const T* __restrict__ qkv, const float* __restrict__ mask_bias,
                 T* __restrict__ ctx, int S, int H, int hd, float scale, DropSite ad) {
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

constexpr int kMaxSeq = 128, kMaxHeadDim = 64;  // the wrappers' limits

inline size_t attention_smem_bytes(int S, int hd) {
  return (size_t)(S * hd + S * (hd + 1) + S * hd + S * S + S) * sizeof(float);
}

// Lets `kernel` take `bytes` of dynamic shared memory once per device,
// instead of setting the attribute on every layer call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, std::atomic<uint64_t>& done) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

template <typename T>
int launch_attention(const T* qkv, const float* mask_bias, T* ctx, int B, int S, int H, int nh,
                     const DropSite& ad, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  const int hd = H / nh;
  cudaError_t e =
      allow_smem(attention_kernel<T>, attention_smem_bytes(kMaxSeq, kMaxHeadDim), done);
  if (e != cudaSuccess) return (int)e;
  attention_kernel<T><<<dim3(nh, B), 256, attention_smem_bytes(S, hd), st>>>(
      qkv, mask_bias, ctx, S, H, hd, 1.0f / sqrtf((float)hd), ad);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
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
