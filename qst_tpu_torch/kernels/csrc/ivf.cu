// K6: the IVF probed-cell scorer.
//
// Replaces qst_tpu/ops/ivf_pallas.py `_cell_score_kernel` (:34), the TPU
// kernel behind `ivf_cell_scores_fn` (:48): every query's dot products with
// every slot of its P probed cells,
//   out[q, p·L + l] = sum_d queries[q, d] · cells[probe[q, p], l, d],
// the cells fetched from the (C, L, D) tensor by probe id. Raw scores for
// every slot, the zero rows of padded slots included: the caller masks by
// its per-cell fill counts.
//   Bound on the H100: a gather of Q·P·L·D cell elements read once (9.4 MB a
//   query at P = 8, L = 1536, D = 384 bf16) against 2 operations per element
//   — device-memory bandwidth, by two orders of magnitude. The output,
//   4 bytes per D·itemsize read, is under 1% of the traffic.
//   Design: one block per (query, probe, 64-row tile of the cell), the large
//   count on grid x. The block loads its own probe id (the TPU kernel's
//   scalar-prefetched, transposed probe table is not needed) and stages the
//   query row once in shared memory; each of 8 warps scores 8 rows of the
//   tile, two at a time so two rows' loads are in flight, lanes striding over
//   16-byte chunks, a shuffle reduction and one f32 store per row. Only the
//   owning query is scored: the TPU kernel's 8 aliases of the cell tensor,
//   its query padding to 8 rows and its <= 1024-row cell tiles existed for
//   Mosaic and are gone. A probe id outside [0, C) reads nothing and scores
//   -inf. Queries that probe the same cell each read it (from L2 when they
//   run together): grouping them is later work.
#include "common.cuh"

namespace qst {

constexpr int IVF_ROWS = 64;   // cell rows per block
constexpr int IVF_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(IVF_WARPS * 32)
ivf_cell_scores_kernel(const T* __restrict__ queries, const T* __restrict__ cells,
                       const int* __restrict__ probe, float* __restrict__ out, int C, int L,
                       int D, int P, int n_tiles) {
  extern __shared__ uint4 qs[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = D * (int)sizeof(T) / 16;
  const long long qp = (long long)blockIdx.x / n_tiles;  // q·P + p
  const int tile = (int)(blockIdx.x % n_tiles);
  const long long q = qp / P;

  const uint4* qrow = reinterpret_cast<const uint4*>(queries + (size_t)q * D);
  for (int c = tid; c < chunks; c += IVF_WARPS * 32) qs[c] = qrow[c];
  __syncthreads();

  const int cell = probe[qp];
  const bool in_range = cell >= 0 && cell < C;  // uniform across the block
  const T* base = cells + (size_t)(in_range ? cell : 0) * L * D;
  float* o = out + (size_t)qp * L;
  const int r_end = min((tile + 1) * IVF_ROWS, L);

  for (int r = tile * IVF_ROWS + warp; r < r_end; r += 2 * IVF_WARPS) {
    const int r2 = r + IVF_WARPS;
    const bool two = r2 < r_end;  // uniform across the warp
    float s1 = -INFINITY, s2 = -INFINITY;
    if (in_range) {
      const uint4* row1 = reinterpret_cast<const uint4*>(base + (size_t)r * D);
      const uint4* row2 = reinterpret_cast<const uint4*>(base + (size_t)(two ? r2 : r) * D);
      typename Dot16<T>::Acc a1 = 0, a2 = 0;
      for (int c = lane; c < chunks; c += 32) {
        const uint4 x = qs[c], v1 = row1[c], v2 = row2[c];
        a1 = Dot16<T>::dot(x, v1, a1);
        a2 = Dot16<T>::dot(x, v2, a2);
      }
      s1 = Dot16<T>::reduce(a1);
      s2 = Dot16<T>::reduce(a2);
    }
    if (lane == 0) {
      o[r] = s1;
      if (two) o[r2] = s2;
    }
  }
}

template <typename T>
int launch_ivf_cell_scores(const void* q, const void* cells, const int* probe, float* out,
                           int Q, int C, int L, int D, int P, cudaStream_t st) {
  const size_t smem = (size_t)D * sizeof(T);
  if (smem > 48 * 1024 || smem % 16) return (int)cudaErrorInvalidValue;
  const int n_tiles = (L + IVF_ROWS - 1) / IVF_ROWS;
  const long long blocks = (long long)Q * P * n_tiles;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  ivf_cell_scores_kernel<T><<<(unsigned int)blocks, IVF_WARPS * 32, smem, st>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(cells), probe, out, C, L, D,
      P, n_tiles);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace qst

using namespace qst;

// queries (Q, D) in the cells' dtype, cells (C, L, D) f32 or bf16, probe
// (Q, P) int32, out (Q, P·L) f32; all contiguous, 16-byte aligned.
extern "C" int qst_ivf_cell_scores(int dtype, const void* queries, const void* cells,
                                   const void* probe, void* out, int Q, int C, int L, int D,
                                   int P, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* ids = reinterpret_cast<const int*>(probe);
  float* o = reinterpret_cast<float*>(out);
  if (dtype == QST_F32)
    return launch_ivf_cell_scores<float>(queries, cells, ids, o, Q, C, L, D, P, st);
  if (dtype == QST_BF16)
    return launch_ivf_cell_scores<bf16>(queries, cells, ids, o, Q, C, L, D, P, st);
  return (int)cudaErrorInvalidValue;
}
