// K6: the IVF probed-cell scorer.
//
// Replaces qst_tpu/ops/ivf_pallas.py `_cell_score_kernel` (:34), the TPU
// kernel behind `ivf_cell_scores_fn` (:48): every query's dot products with
// every slot of its P probed cells,
//   out[q, p·L + l] = sum_d queries[q, d] · cells[probe[q, p], l, d],
// the cells fetched from the (C, L, D) tensor by probe id. Without `fill`
// every slot is scored, the zero rows of padded slots included, as the TPU
// kernel does; with the (C,) fill counts a slot at or past its cell's count
// scores -inf and its row is never read.
//   Bound on the H100: bytes. Each distinct probed cell's filled rows read
//   once (768 bytes a row at D = 384 bf16) against 2·D operations a row and
//   query, and the (Q, P·L) f32 scores written once: at 256 queries of 8
//   probes over 1,024 half-filled cells of 2,048 slots about 0.7 GB of rows
//   and 17 MB of scores, where one read per (query, probe) pair of every slot
//   would be 3.2 GB.
//   Design: the wrapper hands over the (query, probe) pairs as one cell id a
//   position, sorted by cell id with the pair of each position in `order`
//   (the grouped form), or as they came with one pair a block (`order` null:
//   the small-Q form, no sort). A block takes `pairs_per_block` neighbouring
//   positions and a range of row tiles, and walks the (run of equal ids, tile)
//   items of that rectangle: a tile of a cell comes into shared memory once
//   for the whole run of pairs that probe the cell, and only its rows below
//   the fill count come at all. A popular cell is split by the fixed block
//   size; a run cut by a block edge is fetched twice (the second time from
//   L2). The items pass through a ring of up to 4 stages: the next items'
//   copies are in flight while this one is scored, across the runs of the
//   block, and two blocks fit an SM at D = 384 (a row of tens of KiB leaves
//   room for one stage of a few rows: copy and score then take turns).
//   The tiles come by cp.async, not TMA: a copy takes exactly the filled rows
//   (a TMA box has a fixed height and would fetch up to a tile of padding a
//   cell), rows of any multiple of 16 bytes land 16 bytes apart from a bank
//   period (no swizzle to undo in the f32 path's plain loads), and no tensor
//   map is encoded on the host for a call that is host-bound at small Q, nor
//   cached against buffers an index may replace.
//   bf16 on the tensor cores (mma.sync 16 x 8 x 16): a tile's 64 rows are the
//   A operand, 16 rows a warp, up to eight of the run's queries the B
//   operand, staged beside the tile; two accumulator sets halve the chain of
//   dependent products; a run of more than eight pairs takes further rounds
//   over the tile where it lies. Each score goes from the accumulators to its
//   pair's own place in `out`, the eight lanes that hold one query's column
//   writing eight neighbouring slots (one 32-byte sector). At a mean run of
//   two or three pairs most of the n dimension idles: the kernel is bound by
//   bytes. f32 (exact f32 products), and rows too wide for two staged tiles,
//   on the FMA units: a thread on one row of the tile for the pairs of the
//   run in turn, the query read through L1.
//   Slots that score -inf (past the fill count, or a probe id outside
//   [0, C): the whole cell) are written by a pass of their own before the
//   ring starts, so the ring only ever sees live rows.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace qst {

constexpr int IVF_THREADS = 128;
constexpr int IVF_QUERIES = 8;     // queries scored at once: the n of mma.sync
constexpr int IVF_MAX_STAGES = 4;
constexpr int IVF_SMEM_MAX = 232448;           // the most dynamic shared memory of a block
constexpr int IVF_SMEM_TWO_BLOCKS = 113 * 1024;  // a block's share where two fit an SM
// blocks aimed at, to even out the cells' fills (8 and 32, 32-row tiles and
// three blocks an SM were no faster over a 1M-row index)
constexpr int IVF_BLOCKS_PER_SM = 16;

struct IvfArgs {
  const unsigned char* queries;  // (Q, row_bytes)
  const unsigned char* cells;    // (C, L, row_bytes)
  const void* ids;               // (n_pairs,) cell id of each position, int32 or int64
  const long long* order;        // (n_pairs,) pair q·n_probe + p of each position, or null
  const int* fill;               // (C,) rows in use, or null: all L
  float* out;                    // (Q, n_probe·L): pair·L + slot
  int ids64, C, L, row_bytes, n_probe, n_pairs;
  int pairs_per_block, tile_rows, tiles_per_block, stages;
  int ld, stage_rows;            // a stage's row pitch in 16-byte pieces, and its rows
};

// the cell id at a position; an int64 id outside [0, C) reads as -1
__device__ __forceinline__ int ivf_cell(const IvfArgs& a, int pos) {
  if (!a.ids64) return reinterpret_cast<const int*>(a.ids)[pos];
  const long long v = reinterpret_cast<const long long*>(a.ids)[pos];
  return v < 0 || v >= a.C ? -1 : (int)v;
}

__device__ __forceinline__ int ivf_live_rows(const IvfArgs& a, int cell) {
  if (cell < 0 || cell >= a.C) return 0;
  if (a.fill == nullptr) return a.L;
  const int f = a.fill[cell];
  return f < 0 ? 0 : (f < a.L ? f : a.L);
}

__device__ __forceinline__ size_t ivf_pair(const IvfArgs& a, int pos) {
  return a.order ? (size_t)a.order[pos] : (size_t)pos;
}

// One item of a block's walk: rows r .. of the cell that positions p .. e - 1
// probe; r_end is where the cell's live rows end inside the block's rows.
struct IvfCursor {
  int p, e, cell, r, r_end;
};

// the first run at or after position p with live rows in [r_lo, r_hi); p_hi when none
__device__ __forceinline__ void ivf_seek(const IvfArgs& a, IvfCursor& c, int p, int p_hi,
                                         int r_lo, int r_hi) {
  while (p < p_hi) {
    const int cell = ivf_cell(a, p);
    int e = p + 1;
    while (e < p_hi && ivf_cell(a, e) == cell) ++e;
    const int live = ivf_live_rows(a, cell);
    const int r_end = live < r_hi ? live : r_hi;
    if (r_lo < r_end) {
      c.p = p, c.e = e, c.cell = cell, c.r = r_lo, c.r_end = r_end;
      return;
    }
    p = e;
  }
  c.p = p_hi;
}

__device__ __forceinline__ void ivf_next(const IvfArgs& a, IvfCursor& c, int p_hi, int r_lo,
                                         int r_hi) {
  c.r += a.tile_rows;
  if (c.r >= c.r_end) ivf_seek(a, c, c.e, p_hi, r_lo, r_hi);
}

__device__ __forceinline__ int ivf_rows(const IvfArgs& a, const IvfCursor& c) {
  return c.r_end - c.r < a.tile_rows ? c.r_end - c.r : a.tile_rows;
}

// the item's live rows, one contiguous piece of the cell tensor, into a stage
__device__ __forceinline__ void ivf_load_tile(const IvfArgs& a, const IvfCursor& c, uint4* tile) {
  const int chunks = a.row_bytes / 16, n = ivf_rows(a, c) * chunks;
  const uint4* src =
      reinterpret_cast<const uint4*>(a.cells + ((size_t)c.cell * a.L + c.r) * a.row_bytes);
  for (int i = threadIdx.x; i < n; i += IVF_THREADS) {
    const int row = i / chunks;
    cp_async16(tile + row * a.ld + (i - row * chunks), src + i);
  }
}

// the queries of positions t0 .. t0 + cnt - 1 beside the tile
__device__ __forceinline__ void ivf_load_queries(const IvfArgs& a, int t0, int cnt,
                                                 uint4* staged) {
  const int chunks = a.row_bytes / 16;
  for (int i = threadIdx.x; i < cnt * chunks; i += IVF_THREADS) {
    const int j = i / chunks, c = i - j * chunks;
    const size_t q = ivf_pair(a, t0 + j) / a.n_probe;
    cp_async16(staged + j * a.ld + c, a.queries + q * a.row_bytes + 16 * c);
  }
}

__device__ __forceinline__ void ivf_wait_for_oldest(int stages) {
  if (stages == 1) cp_async_wait<0>();
  else if (stages == 2) cp_async_wait<1>();
  else if (stages == 3) cp_async_wait<2>();
  else cp_async_wait<3>();
}

// bf16: the tile's rows against eight staged queries at a time on mma.sync
struct IvfMma {
  static constexpr bool kStagesQueries = true;
  static constexpr int kMinTileRows = 16;

  __device__ static void score(const IvfArgs& a, const IvfCursor& c, uint4* tile) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int chunks = a.row_bytes / 16, ksteps = (chunks + 1) / 2;
    const int rows = ivf_rows(a, c);
    uint4* staged = tile + a.tile_rows * a.ld;
    // lane's pieces of the operands: A by ldmatrix (row lane % 16 of the warp's
    // 16, bytes 16·(lane / 16) of a step), B as two words of query lane / 4
    const unsigned char* a_row =
        reinterpret_cast<const unsigned char*>(tile + (16 * warp + (lane & 15)) * a.ld) +
        16 * (lane >> 4);
    const unsigned char* b_row =
        reinterpret_cast<const unsigned char*>(staged + (lane >> 2) * a.ld) + 4 * (lane & 3);
    const int r = 16 * warp + (lane >> 2);  // the accumulators' rows: r and r + 8
    for (int t0 = c.p; t0 < c.e; t0 += IVF_QUERIES) {
      const int cnt = c.e - t0 < IVF_QUERIES ? c.e - t0 : IVF_QUERIES;
      if (t0 > c.p) {  // a further round: the next eight queries where the first lay
        __syncthreads();
        ivf_load_queries(a, t0, cnt, staged);
        cp_async_wait_all();
        __syncthreads();
      }
      if (16 * warp >= rows) continue;
      float acc0[4] = {0, 0, 0, 0}, acc1[4] = {0, 0, 0, 0};
      int s = 0;
      for (; s + 1 < ksteps; s += 2) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, a_row + 32 * s);
        ldmatrix_x4(a1, a_row + 32 * s + 32);
        mma_m16n8k16(acc0, a0, *reinterpret_cast<const uint32_t*>(b_row + 32 * s),
                     *reinterpret_cast<const uint32_t*>(b_row + 32 * s + 16));
        mma_m16n8k16(acc1, a1, *reinterpret_cast<const uint32_t*>(b_row + 32 * s + 32),
                     *reinterpret_cast<const uint32_t*>(b_row + 32 * s + 48));
      }
      if (s < ksteps) {
        uint32_t a0[4];
        ldmatrix_x4(a0, a_row + 32 * s);
        mma_m16n8k16(acc0, a0, *reinterpret_cast<const uint32_t*>(b_row + 32 * s),
                     *reinterpret_cast<const uint32_t*>(b_row + 32 * s + 16));
      }
      // acc[h], acc[2 + h]: rows r and r + 8 against query 2·(lane % 4) + h
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * (lane & 3) + h;
        if (j < cnt) {
          float* o = a.out + ivf_pair(a, t0 + j) * a.L + c.r;
          if (r < rows) o[r] = acc0[h] + acc1[h];
          if (r + 8 < rows) o[r + 8] = acc0[2 + h] + acc1[2 + h];
        }
      }
    }
  }
};

// f32, and rows too wide for IvfMma's stages: thread t on row t % tile_rows
// for the pairs t / tile_rows, + 128 / tile_rows, ... of the run (Dot16,
// common.cuh, two sums a row), the query read through L1
template <typename T>
struct IvfSimt {
  static constexpr bool kStagesQueries = false;
  static constexpr int kMinTileRows = 1;

  __device__ static void score(const IvfArgs& a, const IvfCursor& c, uint4* tile) {
    using Acc = typename Dot16<T>::Acc;
    const int tid = threadIdx.x, chunks = a.row_bytes / 16;
    const int row = tid & (a.tile_rows - 1);
    if (row >= ivf_rows(a, c)) return;
    const uint4* crow = tile + row * a.ld;
    for (int pp = c.p + tid / a.tile_rows; pp < c.e; pp += IVF_THREADS / a.tile_rows) {
      const size_t pair = ivf_pair(a, pp);
      const uint4* qrow =
          reinterpret_cast<const uint4*>(a.queries + (pair / a.n_probe) * a.row_bytes);
      Acc a0 = 0, a1 = 0;
      int k = 0;
      for (; k + 1 < chunks; k += 2) {
        a0 = Dot16<T>::dot(__ldg(qrow + k), crow[k], a0);
        a1 = Dot16<T>::dot(__ldg(qrow + k + 1), crow[k + 1], a1);
      }
      if (k < chunks) a0 = Dot16<T>::dot(__ldg(qrow + k), crow[k], a0);
      a.out[pair * a.L + c.r + row] = (float)(a0 + a1);
    }
  }
};

// Block (x, y): positions x·pairs_per_block .. of `ids`, row tiles
// y·tiles_per_block .. of every cell.
template <typename Scorer>
__global__ void __launch_bounds__(IVF_THREADS) ivf_cell_scores_kernel(const IvfArgs a) {
  extern __shared__ uint4 ivf_smem[];  // [stages][stage_rows][ld]
  const int tid = threadIdx.x;
  const long long p_first = (long long)blockIdx.x * a.pairs_per_block;
  const int p_lo = (int)p_first;
  const int p_hi = p_first + a.pairs_per_block < a.n_pairs ? (int)(p_first + a.pairs_per_block)
                                                           : a.n_pairs;
  const int r_lo = blockIdx.y * a.tiles_per_block * a.tile_rows;
  const int r_hi = r_lo + a.tiles_per_block * a.tile_rows < a.L
                       ? r_lo + a.tiles_per_block * a.tile_rows
                       : a.L;
  const int stage_pieces = a.stage_rows * a.ld;

  // the 16 bytes after each row: the k tail of a row that is no multiple of 32 bytes
  if (Scorer::kStagesQueries)
    for (int i = tid; i < a.stages * a.stage_rows; i += IVF_THREADS)
      ivf_smem[i * a.ld + a.row_bytes / 16] = make_uint4(0, 0, 0, 0);

  // the slots no row is read for: past the cell's fill count, or no cell at all
  for (int pp = p_lo; pp < p_hi; ++pp) {
    const int live = ivf_live_rows(a, ivf_cell(a, pp));
    float* o = a.out + ivf_pair(a, pp) * a.L;
    for (int r = (live > r_lo ? live : r_lo) + tid; r < r_hi; r += IVF_THREADS) o[r] = -INFINITY;
  }

  IvfCursor load, cur;
  ivf_seek(a, load, p_lo, p_hi, r_lo, r_hi);
  cur = load;
  auto start_load = [&](int slot) {  // the load cursor's item into `slot`, if there is one
    if (load.p < p_hi) {
      uint4* tile = ivf_smem + slot * stage_pieces;
      ivf_load_tile(a, load, tile);
      if (Scorer::kStagesQueries) {
        const int cnt = load.e - load.p < IVF_QUERIES ? load.e - load.p : IVF_QUERIES;
        ivf_load_queries(a, load.p, cnt, tile + a.tile_rows * a.ld);
      }
      ivf_next(a, load, p_hi, r_lo, r_hi);
    }
    cp_async_commit();  // an empty group keeps the count of groups in step
  };
  for (int s = 0; s + 1 < a.stages; ++s) start_load(s);
  int slot = 0, free_slot = a.stages - 1;
  while (cur.p < p_hi) {
    start_load(free_slot);
    ivf_wait_for_oldest(a.stages);
    __syncthreads();  // this item's copies, by every thread, have landed
    Scorer::score(a, cur, ivf_smem + slot * stage_pieces);
    __syncthreads();  // the stage is free for the load after next
    ivf_next(a, cur, p_hi, r_lo, r_hi);
    slot = slot + 1 == a.stages ? 0 : slot + 1;
    free_slot = free_slot + 1 == a.stages ? 0 : free_slot + 1;
  }
}

template <typename Scorer>
int launch_ivf(IvfArgs a, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  const int chunks = a.row_bytes / 16;
  const int extra = Scorer::kStagesQueries ? IVF_QUERIES : 0;
  // rows 16 bytes (or, with no staged queries, an odd count of pieces) apart
  // from a multiple of 128 bytes: eight rows' pieces on different banks
  a.ld = Scorer::kStagesQueries ? chunks + 1 : (chunks | 1);
  // the tallest tile of which two stages fit a block of two an SM, else a
  // block of one; a row too wide for that goes through a single stage, its
  // copy and its scoring in turn
  auto tallest = [&](int stages, int budget) {
    for (int rows = 64; rows >= Scorer::kMinTileRows; rows >>= 1)
      if (stages * (rows + extra) * a.ld * 16 <= budget) return rows;
    return 0;
  };
  int budget = IVF_SMEM_TWO_BLOCKS;
  a.tile_rows = tallest(2, budget);
  if (!a.tile_rows) a.tile_rows = tallest(2, budget = IVF_SMEM_MAX);
  if (!a.tile_rows) a.tile_rows = tallest(1, budget);
  if (!a.tile_rows) return (int)cudaErrorInvalidValue;
  a.stage_rows = a.tile_rows + extra;
  const int stage_bytes = a.stage_rows * a.ld * 16;
  a.stages = budget / stage_bytes < IVF_MAX_STAGES ? budget / stage_bytes : IVF_MAX_STAGES;
  // enough blocks for IVF_BLOCKS_PER_SM an SM: the row tiles of a cell are
  // split over grid y as far as the groups of pairs on grid x leave it short
  const int n_tiles = (a.L + a.tile_rows - 1) / a.tile_rows;
  const long long groups = ((long long)a.n_pairs + a.pairs_per_block - 1) / a.pairs_per_block;
  if (groups > 2147483647LL) return (int)cudaErrorInvalidValue;
  const long long want = (long long)IVF_BLOCKS_PER_SM * sm_count();
  long long split = (want + groups - 1) / groups;
  if (split > n_tiles) split = n_tiles;
  a.tiles_per_block = (int)((n_tiles + split - 1) / split);
  if ((n_tiles + a.tiles_per_block - 1) / a.tiles_per_block > 65535)
    a.tiles_per_block = (n_tiles + 65534) / 65535;
  const dim3 grid((unsigned int)groups, (n_tiles + a.tiles_per_block - 1) / a.tiles_per_block);
  cudaError_t e = allow_smem(ivf_cell_scores_kernel<Scorer>, IVF_SMEM_MAX, done);
  if (e != cudaSuccess) return (int)e;
  ivf_cell_scores_kernel<Scorer><<<grid, IVF_THREADS, a.stages * stage_bytes, st>>>(a);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace qst

using namespace qst;

// queries (Q, D) in the cells' dtype, cells (C, L, D) f32 or bf16, out
// (Q, P·L) f32; all contiguous, 16-byte aligned, D·itemsize a multiple of 16.
// `ids` (Q·P,) int32, or int64 when `ids64`: the cell id of each position;
// `order` (Q·P,) int64: the pair q·P + p of each position, or null when
// position i is pair i (`ids` is then the (Q, P) probe table as it came).
// `fill` (C,) int32 or null.
extern "C" int qst_ivf_cell_scores(int dtype, const void* queries, const void* cells,
                                   const void* ids, int ids64, const void* order,
                                   const void* fill,
                                   void* out, int Q, int C, int L, int D, int P,
                                   int pairs_per_block, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (Q <= 0 || P <= 0 || L <= 0) return 0;
  if ((long long)Q * P > 2147483647LL || pairs_per_block < 1) return (int)cudaErrorInvalidValue;
  IvfArgs a{};
  a.queries = reinterpret_cast<const unsigned char*>(queries);
  a.cells = reinterpret_cast<const unsigned char*>(cells);
  a.ids = ids, a.ids64 = ids64;
  a.order = reinterpret_cast<const long long*>(order);
  a.fill = reinterpret_cast<const int*>(fill);
  a.out = reinterpret_cast<float*>(out);
  a.C = C, a.L = L, a.n_probe = P, a.n_pairs = Q * P, a.pairs_per_block = pairs_per_block;
  if (dtype == QST_F32) {
    a.row_bytes = D * 4;
    return a.row_bytes % 16 ? (int)cudaErrorInvalidValue : launch_ivf<IvfSimt<float>>(a, st);
  }
  if (dtype != QST_BF16) return (int)cudaErrorInvalidValue;
  a.row_bytes = D * 2;
  if (a.row_bytes % 16) return (int)cudaErrorInvalidValue;
  // two stages of 16 rows and the staged queries must fit a block
  if (2 * (16 + IVF_QUERIES) * (a.row_bytes / 16 + 1) * 16 <= IVF_SMEM_MAX)
    return launch_ivf<IvfMma>(a, st);
  return launch_ivf<IvfSimt<bf16>>(a, st);
}
