// K4 (bucket maxima) and K5 (winning-bucket rescore) of exact top-k search.
//
// K4 replaces qst_tpu/ops/topk_pallas.py `_bucket_max_kernel` (:92), the TPU
// kernel behind `bucket_maxima` (:124): a fused (Q, D) x (N, D)^T score
// product that writes only the maximum of each 128-row bucket, so the
// (Q, N) scores never reach device memory.
//   Bound on the H100: 2·Q·N·D operations against N·D corpus bytes read
//   once — at Q = 4096, 1M x 384 bf16 that is 3.2 TFLOP over 0.8 GB, so the
//   tensor cores are the limit when the corpus is not re-read per query tile.
//   Design: one block per (64-query tile, 128-row bucket), queries on grid
//   x so the blocks that run together share one corpus bucket (read from
//   device memory about once, then from L2) and the small query matrix
//   stays in L2. bf16 runs on the tensor cores (wmma 16x16x16, f32
//   accumulation); the (64, 128) score tile goes to shared memory and each
//   warp reduces rows to their bucket maximum. f32 runs on the FMA units;
//   int8 accumulates exactly in int32 with __dp4a. Rows at or past n_real
//   score -inf. Each block writes its own outputs: no merge across blocks.
//
// K5 replaces `_rescore_kernel` (:251) behind `rescore_buckets` (:289): each
// query's k winning buckets are gathered by id and scored exactly.
//   Bound: a gather of Q·k·128·D corpus elements (4 GB at Q = 4096, k = 10,
//   D = 384 bf16) — device-memory bandwidth.
//   Design: one block per (slot, query) loads its own bucket id; each warp
//   reads whole corpus rows with 16-byte loads and reduces the dot product
//   across lanes. Only the owning query is scored (the TPU scored all 8 rows
//   of each alias for Mosaic's sake), and rows at or past N are masked to
//   -inf in the kernel instead of padding the corpus to a 128 multiple.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace qst {

constexpr int BUCKET = 128;
constexpr int MAX_GRID_Y = 65535;

// ---------------------------------------------------------------------------
// K4, bf16 on the tensor cores. Block: 64 queries x one 128-row bucket,
// 8 warps as 2 (queries) x 4 (docs), each warp 32x32 as 2x2 fragments.
// The corpus tile is matrix_b in column-major order: B(k, n) = corpus[n][k].
// Needs D % 8 == 0.
// ---------------------------------------------------------------------------
constexpr int KB_Q = 64, KB_K = 32, KB_LD = KB_K + 8, KB_LDS = BUCKET + 4;
constexpr int KB_SMEM_AB = (KB_Q + BUCKET) * KB_LD * 2;
constexpr int KB_SMEM_S = KB_Q * KB_LDS * 4;
constexpr int KB_SMEM = KB_SMEM_AB > KB_SMEM_S ? KB_SMEM_AB : KB_SMEM_S;

__global__ void __launch_bounds__(256)
bucket_max_bf16_kernel(const bf16* __restrict__ queries, const bf16* __restrict__ corpus,
                       float* __restrict__ out, int Q, int N, int D, int n_real, int NB) {
  __shared__ __align__(128) unsigned char smem[KB_SMEM];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Cs = Qs + KB_Q * KB_LD;
  float* Ss = reinterpret_cast<float*>(smem);  // reused after the product

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wq = warp >> 2, wn = warp & 3;
  const int q0 = blockIdx.x * KB_Q;

  for (int bucket = blockIdx.y; bucket < NB; bucket += gridDim.y) {
    const size_t n0 = (size_t)bucket * BUCKET;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < D; k0 += KB_K) {
      // queries: 64 rows x 4 chunks of 8; corpus: 128 rows x 4 chunks
      for (int i = tid; i < (KB_Q + BUCKET) * 4; i += 256) {
        int r = i >> 2, c = (i & 3) * 8, k = k0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < KB_Q) {
          int gq = q0 + r;
          if (gq < Q && k < D) v = *reinterpret_cast<const uint4*>(queries + (size_t)gq * D + k);
        } else {
          size_t gn = n0 + (r - KB_Q);
          if (gn < (size_t)N && k < D) v = *reinterpret_cast<const uint4*>(corpus + gn * D + k);
        }
        *reinterpret_cast<uint4*>(Qs + r * KB_LD + c) = v;  // Cs follows Qs
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KB_K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], Qs + (wq * 32 + i * 16) * KB_LD + kk, KB_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Cs + (wn * 32 + j * 16) * KB_LD + kk, KB_LD);
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
        wmma::store_matrix_sync(Ss + (wq * 32 + i * 16) * KB_LDS + wn * 32 + j * 16,
                                acc[i][j], KB_LDS, wmma::mem_row_major);
    __syncthreads();
    for (int r = warp; r < KB_Q; r += 8) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < BUCKET / 32; ++i) {
        int c = lane + 32 * i;
        if (n0 + c < (size_t)n_real) m = fmaxf(m, Ss[r * KB_LDS + c]);
      }
      m = warp_max(m);
      int gq = q0 + r;
      if (lane == 0 && gq < Q) out[(size_t)gq * NB + bucket] = m;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4 on the FMA units (f32) or with __dp4a (int8, four values per 32-bit
// word, exact int32 sums). Block: 64 queries x one bucket, 256 threads; a
// thread owns 4 queries x 8 docs (docs tx + 16·j, so a warp's reads of one
// k-slice hit 16 consecutive words) and the 16 threads of a query row reduce
// its bucket maximum with shuffles.
// ---------------------------------------------------------------------------
struct F32Simt {
  using In = float;
  using Word = float;
  using Acc = float;
  static constexpr int KW = 16;  // words per k-step
  __device__ static int words(int D) { return D; }
  __device__ static Acc mac(Word a, Word b, Acc c) { return fmaf(a, b, c); }
};

struct I8Simt {
  using In = int8_t;
  using Word = int;  // four int8 values
  using Acc = int;
  static constexpr int KW = 8;
  __device__ static int words(int D) { return D / 4; }
  __device__ static Acc mac(Word a, Word b, Acc c) { return __dp4a(a, b, c); }
};

template <typename Tr>
__global__ void __launch_bounds__(256)
bucket_max_simt_kernel(const typename Tr::In* __restrict__ queries,
                       const typename Tr::In* __restrict__ corpus, float* __restrict__ out,
                       int Q, int N, int D, int n_real, int NB) {
  using Word = typename Tr::Word;
  using Acc = typename Tr::Acc;
  constexpr int KW = Tr::KW;
  __shared__ Word Qs[KW][KB_Q + 1];
  __shared__ Word Cs[KW][BUCKET + 1];
  const Word* qw = reinterpret_cast<const Word*>(queries);
  const Word* cw = reinterpret_cast<const Word*>(corpus);
  const int W = Tr::words(D);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * KB_Q;

  for (int bucket = blockIdx.y; bucket < NB; bucket += gridDim.y) {
    const size_t n0 = (size_t)bucket * BUCKET;
    Acc acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0;
    for (int w0 = 0; w0 < W; w0 += KW) {
      for (int i = tid; i < KB_Q * KW; i += 256) {
        int r = i / KW, c = i % KW, gq = q0 + r;
        Qs[c][r] = (gq < Q && w0 + c < W) ? qw[(size_t)gq * W + w0 + c] : Word(0);
      }
      for (int i = tid; i < BUCKET * KW; i += 256) {
        int r = i / KW, c = i % KW;
        size_t gn = n0 + r;
        Cs[c][r] = (gn < (size_t)N && w0 + c < W) ? cw[gn * W + w0 + c] : Word(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) {
        Word a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Cs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = Tr::mac(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n0 + tx + 16 * j < (size_t)n_real) m = fmaxf(m, (float)acc[i][j]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      int gq = q0 + ty * 4 + i;
      if (tx == 0 && gq < Q) out[(size_t)gq * NB + bucket] = m;
    }
  }
}

// ---------------------------------------------------------------------------
// K5. Block (slot, query): the query row sits in shared memory in its own
// dtype; each of 8 warps scores 16 rows of the bucket, one row at a time,
// lanes striding over 16-byte chunks (Dot16, common.cuh). Needs
// D·sizeof(T) % 16 == 0.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
rescore_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
               const int* __restrict__ bucket_ids, float* __restrict__ out, int Q, int N,
               int D, int k) {
  extern __shared__ uint4 qs[];
  const int slot = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = D * (int)sizeof(T) / 16;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const uint4* qrow = reinterpret_cast<const uint4*>(queries + (size_t)q * D);
    for (int c = tid; c < chunks; c += 256) qs[c] = qrow[c];
    __syncthreads();
    const long long b = bucket_ids[(size_t)q * k + slot];
    float* o = out + ((size_t)q * k + slot) * BUCKET;
    for (int r = warp; r < BUCKET; r += 8) {
      const long long row = b * BUCKET + r;
      float score = -INFINITY;
      if (b >= 0 && row < N) {  // uniform across the warp
        const uint4* crow = reinterpret_cast<const uint4*>(corpus + (size_t)row * D);
        typename Dot16<T>::Acc acc = 0;
        for (int c = lane; c < chunks; c += 32) acc = Dot16<T>::dot(qs[c], crow[c], acc);
        score = Dot16<T>::reduce(acc);
      }
      if (lane == 0) o[r] = score;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_rescore(const void* q, const void* c, const int* ids, float* out, int Q, int N,
                   int D, int k, cudaStream_t st) {
  const size_t smem = (size_t)D * sizeof(T);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid(k, Q < MAX_GRID_Y ? Q : MAX_GRID_Y);
  rescore_kernel<T><<<grid, 256, smem, st>>>(reinterpret_cast<const T*>(q),
                                             reinterpret_cast<const T*>(c), ids, out, Q, N,
                                             D, k);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace qst

using namespace qst;

extern "C" int qst_bucket_maxima(int dtype, const void* queries, const void* corpus,
                                 void* out, int Q, int N, int D, int n_real, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int NB = (N + BUCKET - 1) / BUCKET;
  dim3 grid((Q + KB_Q - 1) / KB_Q, NB < MAX_GRID_Y ? NB : MAX_GRID_Y);
  float* o = reinterpret_cast<float*>(out);
  if (dtype == QST_BF16) {
    bucket_max_bf16_kernel<<<grid, 256, 0, st>>>(reinterpret_cast<const bf16*>(queries),
                                                 reinterpret_cast<const bf16*>(corpus), o, Q,
                                                 N, D, n_real, NB);
  } else if (dtype == QST_F32) {
    bucket_max_simt_kernel<F32Simt><<<grid, 256, 0, st>>>(
        reinterpret_cast<const float*>(queries), reinterpret_cast<const float*>(corpus), o, Q,
        N, D, n_real, NB);
  } else if (dtype == QST_I8) {
    bucket_max_simt_kernel<I8Simt><<<grid, 256, 0, st>>>(
        reinterpret_cast<const int8_t*>(queries), reinterpret_cast<const int8_t*>(corpus), o,
        Q, N, D, n_real, NB);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

extern "C" int qst_rescore_buckets(int dtype, const void* queries, const void* corpus,
                                   const void* bucket_ids, void* out, int Q, int N, int D,
                                   int k, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* ids = reinterpret_cast<const int*>(bucket_ids);
  float* o = reinterpret_cast<float*>(out);
  if (dtype == QST_F32) return launch_rescore<float>(queries, corpus, ids, o, Q, N, D, k, st);
  if (dtype == QST_BF16) return launch_rescore<bf16>(queries, corpus, ids, o, Q, N, D, k, st);
  if (dtype == QST_I8) return launch_rescore<int8_t>(queries, corpus, ids, o, Q, N, D, k, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* qst_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
