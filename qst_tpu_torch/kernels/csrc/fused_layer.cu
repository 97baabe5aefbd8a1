// K1: one BERT encoder layer, forward only — a chain of hand-written kernels.
//
// Replaces: qst_tpu/ops/fused_layer_pallas.py `_layer_kernel` (:111), the
// TPU kernel behind `fused_bert_layer` (:189). That kernel holds a block of
// sequences and the whole layer's weights in VMEM and runs QKV, attention,
// output projection, residual+LayerNorm, erf-GELU FFN and residual+LayerNorm
// in one body, so the (S, S) probabilities never reach HBM.
//
// What bounds it on the H100: the five projections, 2·M·(4H² + 2HF) FLOPs
// per layer (M = B·S tokens), against (M·H) activations in and out — at
// M = 32768 and MiniLM widths that is ~116 GFLOP over ~100 MB, far above the
// card's ~295 FLOP/byte bf16 ridge, so the tensor cores are the limit.
// Attention is small (S ≤ 128) and its probabilities must stay on chip.
//
// What this design does about it (a first, simple form):
// - projections run as a tiled GEMM on the tensor cores (nvcuda::wmma bf16
//   16x16x16, f32 accumulation) with the bias, erf-GELU or residual fused
//   into the epilogue; the f32 path (for comparisons) is a SIMT FMA GEMM;
//   Q, K and V are one GEMM over the concatenated (H, 3H) weight, so a layer
//   is seven launches;
// - attention runs one block per (sequence, head): Q, K, V and the (S, S)
//   f32 scores sit in shared memory, so the probabilities never reach device
//   memory, as in the TPU kernel;
// - residual + LayerNorm with f32 statistics runs one warp per row.
// bf16 rounding happens where the TPU kernel rounds: q, k, v after the bias;
// the probabilities before P·V; ctx; the LN1 output; the GELU output; the
// layer output. Not yet: cp.async/TMA pipelining, wgmma, one persistent
// kernel per layer — later work, measured against this one.
#include <mma.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace qst {

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_RESID_F32 = 2 };

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// v already holds acc + bias[gn]
template <typename T, int EPI>
__device__ __forceinline__ void epilogue_store(void* C, const T* resid, int ldc,
                                               int N, int gm, int gn, float v) {
  size_t o = (size_t)gm * ldc + gn;
  if (EPI == EPI_BIAS) {
    reinterpret_cast<T*>(C)[o] = from_f32<T>(v);
  } else if (EPI == EPI_BIAS_GELU) {
    reinterpret_cast<T*>(C)[o] = from_f32<T>(gelu_erf(v));
  } else {
    reinterpret_cast<float*>(C)[o] = v + to_f32(resid[(size_t)gm * N + gn]);
  }
}

// ---------------------------------------------------------------------------
// bf16 GEMM on the tensor cores: C(M, N) = A(M, K) · W(K, N) + bias, with an
// epilogue. Block tile 128x64, k-step 32, 8 warps as 4 (M) x 2 (N), each
// warp 32x32 as 2x2 wmma 16x16x16 fragments. Needs K % 8 == 0 (16-byte row
// loads), K % 32 == 0 and N % 64 == 0 (checked by the wrapper).
// ---------------------------------------------------------------------------
constexpr int GB_M = 128, GB_N = 64, GB_K = 32;
constexpr int GB_LDA = GB_K + 8, GB_LDB = GB_N + 8, GB_LDC = GB_N + 4;
constexpr int GB_SMEM_AB = (GB_M * GB_LDA + GB_K * GB_LDB) * 2;
constexpr int GB_SMEM_C = GB_M * GB_LDC * 4;
constexpr int GB_SMEM = GB_SMEM_AB > GB_SMEM_C ? GB_SMEM_AB : GB_SMEM_C;

template <int EPI>
__global__ void __launch_bounds__(256)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, const bf16* __restrict__ resid,
                 void* __restrict__ C, int M, int N, int K, int ldc) {
  __shared__ __align__(128) unsigned char smem[GB_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + GB_M * GB_LDA;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the main loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += GB_K) {
    // A tile: 128 rows x 32 cols = 4 x 16-byte chunks per row
    for (int i = tid; i < GB_M * (GB_K / 8); i += 256) {
      int r = i >> 2, c = (i & 3) * 8, gm = m0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M) v = *reinterpret_cast<const uint4*>(A + (size_t)gm * K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * GB_LDA + c) = v;
    }
    // W tile: 32 rows x 64 cols = 8 chunks per row
    for (int i = tid; i < GB_K * (GB_N / 8); i += 256) {
      int r = i >> 3, c = (i & 7) * 8;
      *reinterpret_cast<uint4*>(Bs + r * GB_LDB + c) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GB_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * GB_LDA + kk, GB_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * GB_LDB + wn * 32 + j * 16, GB_LDB);
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
  for (int i = tid; i < GB_M * GB_N; i += 256) {
    int r = i / GB_N, c = i % GB_N, gm = m0 + r, gn = n0 + c;
    if (gm >= M) continue;
    epilogue_store<bf16, EPI>(C, resid, ldc, N, gm, gn, Cs[r * GB_LDC + c] + bias[gn]);
  }
}

// ---------------------------------------------------------------------------
// f32 GEMM on the FMA units (the comparison path: tensor-core TF32 would not
// hold an f32 tolerance). Block tile 64x64, k-step 16, 256 threads each
// computing 4x4 outputs. Needs K % 16 == 0 and N % 64 == 0.
// ---------------------------------------------------------------------------
template <int EPI>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* __restrict__ resid,
                void* __restrict__ C, int M, int N, int K, int ldc) {
  __shared__ float As[16][64 + 4];  // k-major
  __shared__ float Bs[16][64];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    for (int i = tid; i < 64 * 16; i += 256) {
      int r = i >> 4, c = i & 15, gm = m0 + r;
      As[c][r] = gm < M ? A[(size_t)gm * K + k0 + c] : 0.0f;
    }
    for (int i = tid; i < 16 * 64; i += 256) {
      int r = i >> 6, c = i & 63;
      Bs[r][c] = W[(size_t)(k0 + r) * N + n0 + c];
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx + 16 * j;
      epilogue_store<float, EPI>(C, resid, ldc, N, gm, gn, acc[i][j] + bias[gn]);
    }
  }
}

template <typename T, int EPI>
int launch_gemm(const T* A, const T* W, const float* bias, const T* resid, void* C,
                int M, int N, int K, int ldc, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    dim3 grid(N / GB_N, (M + GB_M - 1) / GB_M);
    gemm_bf16_kernel<EPI><<<grid, 256, 0, st>>>(A, W, bias, resid, C, M, N, K, ldc);
  } else {
    dim3 grid(N / 64, (M + 63) / 64);
    gemm_f32_kernel<EPI><<<grid, 256, 0, st>>>(A, W, bias, resid, C, M, N, K, ldc);
  }
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// ---------------------------------------------------------------------------
// Attention: one block per (head, sequence). qkv is (B·S, 3H) with q, k, v
// at column offsets 0, H, 2H; ctx is (B·S, H). Shared memory holds Q, K
// (rows padded by one float against bank conflicts), V, the (S, S) scores
// and the sequence's mask bias, all f32.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
attention_kernel(const T* __restrict__ qkv, const float* __restrict__ mask_bias,
                 T* __restrict__ ctx, int S, int H, int hd, float scale) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, b = blockIdx.y;
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
    for (int c = lane; c < S; c += 32) row[c] = to_f32(from_f32<T>(row[c] / s));
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

constexpr int kMaxSeq = 128, kMaxHeadDim = 64;  // the wrapper's limits

size_t attention_smem_bytes(int S, int hd) {
  return (size_t)(S * hd + S * (hd + 1) + S * hd + S * S + S) * sizeof(float);
}

// Lets attention_kernel<T> take the shared memory of the largest shape once
// per device, instead of setting the attribute on every layer call.
template <typename T>
cudaError_t allow_attention_smem() {
  static std::atomic<uint64_t> done{0};
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)attention_smem_bytes(kMaxSeq, kMaxHeadDim));
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

// wqkv is [Wq | Wk | Wv] as one (H, 3H) matrix, bqkv its (1, 3H) bias
template <typename T>
int fused_layer_forward(const T* x, const float* mask_bias, const T* wqkv, const float* bqkv,
                        const T* wo, const float* bo, const float* ln1_g,
                        const float* ln1_b, const T* w1, const float* b1, const T* w2,
                        const float* b2, const float* ln2_g, const float* ln2_b,
                        T* qkv, T* ctx, float* tmp, T* y, T* inter, T* out, int B,
                        int S, int H, int F, int nh, float eps, cudaStream_t st) {
  const int M = B * S, hd = H / nh;
  if (S > kMaxSeq || hd > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  int err;
  if ((err = launch_gemm<T, EPI_BIAS>(x, wqkv, bqkv, nullptr, qkv, M, 3 * H, H, 3 * H, st)))
    return err;

  cudaError_t e = allow_attention_smem<T>();
  if (e != cudaSuccess) return (int)e;
  attention_kernel<T><<<dim3(nh, B), 256, attention_smem_bytes(S, hd), st>>>(
      qkv, mask_bias, ctx, S, H, hd, 1.0f / sqrtf((float)hd));
  QST_RETURN_IF_LAUNCH_FAILED();

  const int ln_blocks = (M + 7) / 8;
  if ((err = launch_gemm<T, EPI_BIAS_RESID_F32>(ctx, wo, bo, x, tmp, M, H, H, H, st))) return err;
  layernorm_kernel<T><<<ln_blocks, 256, 0, st>>>(tmp, ln1_g, ln1_b, y, M, H, eps);
  QST_RETURN_IF_LAUNCH_FAILED();
  if ((err = launch_gemm<T, EPI_BIAS_GELU>(y, w1, b1, nullptr, inter, M, F, H, F, st))) return err;
  if ((err = launch_gemm<T, EPI_BIAS_RESID_F32>(inter, w2, b2, y, tmp, M, H, F, H, st))) return err;
  layernorm_kernel<T><<<ln_blocks, 256, 0, st>>>(tmp, ln2_g, ln2_b, out, M, H, eps);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace qst

using namespace qst;

extern "C" int qst_fused_layer_forward(
    int dtype, const void* x, const void* mask_bias, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* ln1_g, const void* ln1_b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* ln2_g,
    const void* ln2_b, void* qkv, void* ctx, void* tmp, void* y, void* inter,
    void* out, int B, int S, int H, int F, int nh, float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define QST_F(p) reinterpret_cast<const float*>(p)
#define QST_LAYER(T)                                                               \
  fused_layer_forward<T>(                                                          \
      reinterpret_cast<const T*>(x), QST_F(mask_bias), reinterpret_cast<const T*>(wqkv), \
      QST_F(bqkv), reinterpret_cast<const T*>(wo), QST_F(bo), QST_F(ln1_g),        \
      QST_F(ln1_b), reinterpret_cast<const T*>(w1), QST_F(b1),                     \
      reinterpret_cast<const T*>(w2), QST_F(b2), QST_F(ln2_g), QST_F(ln2_b),       \
      reinterpret_cast<T*>(qkv), reinterpret_cast<T*>(ctx),                        \
      reinterpret_cast<float*>(tmp), reinterpret_cast<T*>(y),                      \
      reinterpret_cast<T*>(inter), reinterpret_cast<T*>(out), B, S, H, F, nh, eps, st)
  if (dtype == QST_F32) return QST_LAYER(float);
  if (dtype == QST_BF16) return QST_LAYER(bf16);
#undef QST_LAYER
#undef QST_F
  return (int)cudaErrorInvalidValue;
}
