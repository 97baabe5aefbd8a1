// K4 (bucket maxima) and K5 (winning-bucket rescore) of exact top-k search.
//
// K4 replaces qst_tpu/ops/topk_pallas.py `_bucket_max_kernel` (:92), the TPU
// kernel behind `bucket_maxima` (:124): a fused (Q, D) x (N, D)^T score
// product that writes only the maximum of each 128-row bucket, so the
// (Q, N) scores never reach device memory.
//   Bound on the H100: 2·Q·N·D operations against N·D corpus bytes read
//   once. At Q = 4096 over 1M x 384 bf16 that is 3.30e12 operations (3.3 ms
//   at 989 TFLOP/s) over 0.8 GB (0.24 ms): the tensor cores are the limit as
//   long as the corpus is not read again per query tile. At Q <= 256, the
//   serving shape, the corpus bytes are.
//   Design (bf16, and int8 with D % 16 == 0): a kernel of its own on
//   hopper.cuh's pieces rather than an epilogue of K1's GEMM, because three
//   things differ from a GEMM. (1) D is the whole k dimension, so a block
//   keeps its 128-query tile in shared memory for its whole life and only
//   corpus tiles stream through the TMA ring: half a GEMM's traffic from L2.
//   (2) The tile order: block b keeps query tile b mod W and the blocks of
//   one group walk the same range of buckets in step, so a bucket comes from
//   device memory about once and from L2 for the rest of the group; where
//   the query tiles do not pack the SMs (68 tiles would leave 64 of 132
//   idle) the launcher takes fewer columns and more groups, and a block
//   makes several passes over its range. (3) The
//   epilogue never leaves the registers: a thread masks its 32 columns of
//   two rows against n_real, takes their maximum, two shuffles finish the
//   row over the quad, and the maxima of four neighbouring buckets are
//   stored together (16 bytes a row). A producer thread fills the ring; two
//   consumer warpgroups (64 query rows each) run wgmma on the tiles where
//   they lie, one group of products in flight, and drift apart by up to a
//   ring so that one's epilogue runs under the other's products. Rows past
//   N, Q or D arrive as zeros from TMA: no branch in the mainloop; a
//   zero-filled corpus row would score 0, so columns are masked by index
//   against n_real before the maximum. int8 sums exactly in int32
//   (wgmma.m64n128k32.s32.s8.s8); in bytes its tiles are the bf16 tiles.
//   f32 stays on the FMA units.
//
// K5 replaces `_rescore_kernel` (:251) behind `rescore_buckets` (:289): each
// query's k winning buckets are gathered by id and scored exactly.
//   Bound: each distinct winning bucket read once (0.8 GB at Q = 4096,
//   k = 10, D = 384 bf16: the 40,960 (query, slot) pairs land on about
//   8,190 buckets) and the (Q, k·128) f32 scores written once — bytes.
//   Design: the wrapper sorts the pairs by bucket id; a block takes a fixed
//   number of neighbouring pairs of that order and brings a bucket into
//   shared memory once (cp.async) for the whole run of pairs that chose it,
//   then scores it against each of them, a thread on one corpus row (rows
//   padded by 16 bytes: no bank conflicts), the query read through L1.
//   Scores go to the pair's own place in the output, so nothing after the
//   kernel changes. A very popular bucket is split by the fixed block size;
//   a run cut by a block edge is fetched twice (the second time from L2).
//   Unsorted ids with one pair a block are the small-Q form: no sort, every
//   pair its own block. Ids out of range and rows at or past N score -inf
//   in the kernel; the corpus is not padded to a bucket multiple.
#include <limits.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace qst {

constexpr int BUCKET = 128;
constexpr int MAX_GRID_Y = 65535;
constexpr int SMEM_MAX = 232448;  // the most dynamic shared memory a block can take

// ---------------------------------------------------------------------------
// K4 on the tensor cores. In bytes: a tile is 128 rows (a bucket, or a query
// tile) x 128 bytes of k (64 bf16 or 128 int8: one line of the 128-byte
// swizzle), 16 KB; a product step is 32 bytes of k. Needs row bytes % 16 == 0.
// Shared memory: the resident query tile (KC tiles) where at least four
// stages fit beside it (row bytes <= 1280), then the ring of corpus tiles;
// else both operands stream, a stage holding a query tile and a corpus tile.
// ---------------------------------------------------------------------------
constexpr int KT_TILE_BYTES = BUCKET * 128;
constexpr int KT_HALF_BYTES = KT_TILE_BYTES / 2;  // 64 rows: one warpgroup's queries
constexpr int KT_MAX_STAGES = 8;
constexpr int KT_THREADS = 3 * 128;  // two consumer warpgroups, then the producer's
constexpr int KT_BARRIER_BYTES = 256;  // full[8], empty[8], qfull, qempty
constexpr int KT_STORE = 4;  // buckets whose maxima are stored together

struct Bf16Mma {
  using Acc = float;
  __device__ static void mma(Acc (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    wgmma_m64n128k16<0, 0>(d, a, b, accumulate);
  }
  __device__ static Acc lowest() { return -INFINITY; }
  __device__ static Acc mx(Acc a, Acc b) { return fmaxf(a, b); }
  __device__ static float score(Acc m) { return m; }
};

struct I8Mma {
  using Acc = int;
  __device__ static void mma(Acc (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    wgmma_m64n128k32_s8(d, a, b, accumulate);
  }
  __device__ static Acc lowest() { return INT_MIN; }  // no sum of int8 products reaches it
  __device__ static Acc mx(Acc a, Acc b) { return a > b ? a : b; }
  __device__ static float score(Acc m) { return m == INT_MIN ? -INFINITY : (float)m; }
};

// Block b keeps query tile b % W (then b % W + W, ...: a pass each, where the
// launcher chose fewer columns than there are tiles) and walks the buckets of
// group b / W: one of G equal ranges of the buckets, cut at multiples of
// KT_STORE.
template <typename Tr>
__global__ void __launch_bounds__(KT_THREADS, 1)
bucket_max_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_c, float* __restrict__ out,
                        int Q, int NB, int n_real, int KC, int stages, int resident, int W,
                        int G) {
  using Acc = typename Tr::Acc;
  extern __shared__ unsigned char kt_smem[];
  const uint32_t qs = (smem_u32(kt_smem) + 1023u) & ~1023u;
  const uint32_t stage_bytes = resident ? KT_TILE_BYTES : 2 * KT_TILE_BYTES;
  const uint32_t ring = qs + (resident ? KC * KT_TILE_BYTES : 0);
  const uint32_t full = ring + stages * stage_bytes;  // [KT_MAX_STAGES]
  const uint32_t empty = full + 8 * KT_MAX_STAGES;    // [KT_MAX_STAGES]
  const uint32_t qfull = empty + 8 * KT_MAX_STAGES, qempty = qfull + 8;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int QT = (Q + BUCKET - 1) / BUCKET;
  const int group = blockIdx.x / W;
  const long long units = (NB + KT_STORE - 1) / KT_STORE;
  const int b_lo = KT_STORE * (int)(units * group / G);
  const int b_end = KT_STORE * (int)(units * (group + 1) / G);
  const int b_hi = b_end < NB ? b_end : NB;
  if (b_lo >= b_hi) return;

  if (tid == 2 * 128) {
    // ---- producer: one thread starts every load
    int stage = 0;
    uint32_t phase = 0, pass = 0;
    for (int qt = blockIdx.x % W; qt < QT; qt += W, ++pass) {
      const int q0 = qt * BUCKET;
      if (resident) {
        if (pass > 0) mbar_wait(qempty, (pass - 1) & 1u);  // the last tile is read out
        mbar_expect_tx(qfull, KC * KT_TILE_BYTES);
        for (int c = 0; c < KC; ++c)
          tma_load(qs + c * KT_TILE_BYTES, &map_q, qfull, c * 128, q0);
      }
      for (int bucket = b_lo; bucket < b_hi; ++bucket) {
        for (int c = 0; c < KC; ++c) {
          mbar_wait(empty + 8 * stage, phase ^ 1u);
          const uint32_t bar = full + 8 * stage;
          uint32_t dst = ring + stage * stage_bytes;
          mbar_expect_tx(bar, stage_bytes);
          if (!resident) {
            tma_load(dst, &map_q, bar, c * 128, q0);
            dst += KT_TILE_BYTES;
          }
          tma_load(dst, &map_c, bar, c * 128, bucket * BUCKET);
          if (++stage == stages) stage = 0, phase ^= 1u;
        }
      }
    }
  } else if (tid < 2 * 128) {
    // ---- consumers: warpgroup wg takes query rows 64·wg .. 64·wg + 63 of the tile
    const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31, quad = lane & 3;
    Acc d[64];
    int stage = 0;
    uint32_t phase = 0, pass = 0;
    for (int qt = blockIdx.x % W; qt < QT; qt += W, ++pass) {
      // this thread's accumulators are rows row0 and row0 + 8 of the queries
      const int row0 = qt * BUCKET + 64 * wg + 16 * (warp & 3) + (lane >> 2);
      if (resident) mbar_wait(qfull, pass & 1u);
      Acc keep0 = Tr::lowest(), keep1 = Tr::lowest();
      for (int bucket = b_lo; bucket < b_hi; ++bucket) {
        int prev = -1;
        for (int c = 0; c < KC; ++c) {
          mbar_wait(full + 8 * stage, phase);
          const uint32_t in_stage = ring + stage * stage_bytes;
          const uint32_t a_src =
              (resident ? qs + c * KT_TILE_BYTES : in_stage) + wg * KT_HALF_BYTES;
          const uint32_t b_src = resident ? in_stage : in_stage + KT_TILE_BYTES;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Tr::mma(d, wgmma_desc(a_src + 32 * kk, KT_HALF_BYTES, 1024),
                    wgmma_desc(b_src + 32 * kk, KT_HALF_BYTES, 1024), (c > 0 || kk > 0) ? 1 : 0);
          wgmma_commit();
          if (prev >= 0) {  // the group before this one is done with its stage
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(empty + 8 * prev);
          }
          prev = stage;
          if (++stage == stages) stage = 0, phase ^= 1u;
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);

        // the bucket maximum of two rows, from the accumulators: d[4j], d[4j+1]
        // are columns 8j + 2·quad + {0, 1} of row0, d[4j+2], d[4j+3] of row0 + 8
        const int real = n_real - bucket * BUCKET;  // columns below it are real rows
        Acc m0 = Tr::lowest(), m1 = Tr::lowest();
        if (real >= BUCKET) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            m0 = Tr::mx(m0, Tr::mx(d[4 * j], d[4 * j + 1]));
            m1 = Tr::mx(m1, Tr::mx(d[4 * j + 2], d[4 * j + 3]));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = 8 * j + 2 * quad;
            if (col < real) m0 = Tr::mx(m0, d[4 * j]), m1 = Tr::mx(m1, d[4 * j + 2]);
            if (col + 1 < real) m0 = Tr::mx(m0, d[4 * j + 1]), m1 = Tr::mx(m1, d[4 * j + 3]);
          }
        }
        m0 = Tr::mx(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m1 = Tr::mx(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m0 = Tr::mx(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = Tr::mx(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
        // lane `quad` of the quad keeps bucket 4i + quad; after the fourth
        // (or the range's last) the quad stores up to 16 bytes of each row
        const int slot = bucket & (KT_STORE - 1);
        if (quad == slot) keep0 = m0, keep1 = m1;
        if (slot == KT_STORE - 1 || bucket == b_hi - 1) {
          const int ob = bucket - slot + quad;
          if (ob <= bucket) {
            if (row0 < Q) out[(size_t)row0 * NB + ob] = Tr::score(keep0);
            if (row0 + 8 < Q) out[(size_t)(row0 + 8) * NB + ob] = Tr::score(keep1);
          }
        }
      }
      if (resident && lane == 0) mbar_arrive(qempty);
    }
  }
}

template <typename Tr>
int launch_bucket_max_wgmma(const void* queries, const void* corpus, float* out, int Q, int N,
                            int row_bytes, int n_real, int NB, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  CUtensorMap map_q, map_c;
  if (!make_tensor_map_bytes(&map_q, queries, Q, row_bytes, BUCKET) ||
      !make_tensor_map_bytes(&map_c, corpus, N, row_bytes, BUCKET))
    return (int)cudaErrorInvalidValue;
  const int KC = (row_bytes + 127) / 128;
  const int room = SMEM_MAX - 1024 - KT_BARRIER_BYTES;  // 1024 to align the tiles
  const int resident = (KC + 4) * KT_TILE_BYTES <= room;
  const int held = resident ? KC * KT_TILE_BYTES : 0;
  const int stage_bytes = resident ? KT_TILE_BYTES : 2 * KT_TILE_BYTES;
  int stages = (room - held) / stage_bytes;
  if (stages > KT_MAX_STAGES) stages = KT_MAX_STAGES;
  const size_t smem = 1024 + held + stages * stage_bytes + KT_BARRIER_BYTES;
  // W query tiles side by side, G groups of blocks over the buckets: the W
  // with the shortest walk for a block, its passes over the query tiles times
  // the buckets of a group (in units of KT_STORE); a tie goes to the larger W,
  // which reads the corpus fewer times
  const int QT = (Q + BUCKET - 1) / BUCKET, sms = sm_count();
  const long long units = (NB + KT_STORE - 1) / KT_STORE;
  int W = 1, G = sms;
  long long least = LLONG_MAX;
  for (int w = 1; w <= QT && w <= sms; ++w) {
    const int g = sms / w;
    const long long walk = (long long)((QT + w - 1) / w) * ((units + g - 1) / g);
    if (walk <= least) least = walk, W = w, G = g;
  }
  cudaError_t e = allow_smem(bucket_max_wgmma_kernel<Tr>, SMEM_MAX, done);
  if (e != cudaSuccess) return (int)e;
  bucket_max_wgmma_kernel<Tr><<<W * G, KT_THREADS, smem, st>>>(map_q, map_c, out, Q, NB, n_real,
                                                               KC, stages, resident, W, G);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

constexpr int KB_Q = 64;  // queries of a block of the kernels below

// ---------------------------------------------------------------------------
// K4 on the FMA units (f32: the 1e-4 check needs exact f32 products, which
// TF32 would not give) or with __dp4a (int8 whose D is no multiple of 16, so
// that TMA cannot take its rows; four values per 32-bit word, exact int32
// sums). One block per (64 queries, one bucket), queries on grid x so the
// blocks that run together share a bucket; 256 threads; a
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
// K5. `ids` holds one bucket id per (query, slot) pair, `order` the pair
// (q·k + slot) at each position of `ids` (null: position p is pair p). A
// block takes P neighbouring positions and, for each run of equal ids among
// them, loads the bucket once and scores it against the run's pairs. Needs
// row bytes % 16 == 0. Shared-memory rows carry 16 bytes of padding, so that
// eight rows' 16-byte pieces fall on different banks.
//
// bf16 and int8 on the tensor cores (mma.sync 16 x 8 over 32 bytes of k): the
// bucket's 128 rows are the A operand, 16 rows a warp, eight of the run's
// queries the B operand, staged beside the bucket; a run of more than eight
// pairs takes further rounds over the bucket where it lies. The padding is
// zeroed and serves as the k tail where the row bytes are no multiple of 32.
// ---------------------------------------------------------------------------
constexpr int RS_SMEM_TWO_BLOCKS = 110 * 1024;
constexpr int RS_QUERIES = 8;  // queries scored at once: the n of mma.sync

struct Bf16Dot {
  using Acc = float;
  __device__ static void mma(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_m16n8k16(c, a, b0, b1);
  }
};

struct I8Dot {
  using Acc = int;
  __device__ static void mma(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_m16n8k32_s8(c, a, b0, b1);
  }
};

// the run of equal ids that starts at position p, cut at p_hi → its end
__device__ __forceinline__ int run_end(const int* __restrict__ ids, int p, int p_hi) {
  const int b = ids[p];
  int e = p + 1;
  while (e < p_hi && ids[e] == b) ++e;
  return e;
}

// -inf for every row of the pairs at positions p .. e - 1 (a bucket id out of range)
__device__ __forceinline__ void rescore_no_bucket(const long long* __restrict__ order,
                                                  float* __restrict__ out, int p, int e) {
  for (int i = threadIdx.x; i < (e - p) * BUCKET; i += blockDim.x) {
    const int pp = p + i / BUCKET;
    const size_t pair = order ? (size_t)order[pp] : (size_t)pp;
    out[pair * BUCKET + i % BUCKET] = -INFINITY;
  }
}

template <typename Tr>
__global__ void __launch_bounds__(256)
rescore_mma_kernel(const unsigned char* __restrict__ queries,
                   const unsigned char* __restrict__ corpus, const int* __restrict__ ids,
                   const long long* __restrict__ order, float* __restrict__ out, int N,
                   int row_bytes, int k, int n_pairs, int P) {
  using Acc = typename Tr::Acc;
  extern __shared__ uint4 tile[];  // [BUCKET + RS_QUERIES][chunks + 1]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = row_bytes / 16, ld = chunks + 1, ksteps = (chunks + 1) / 2;
  uint4* staged = tile + BUCKET * ld;  // the queries
  for (int i = tid; i < BUCKET + RS_QUERIES; i += 256)
    tile[i * ld + chunks] = make_uint4(0, 0, 0, 0);
  const int NB = (N + BUCKET - 1) / BUCKET;
  const long long p_end = (long long)(blockIdx.x + 1) * P;
  const int p_hi = p_end < n_pairs ? (int)p_end : n_pairs;
  // lane's pieces of the operands: A by ldmatrix (row lane % 16 of the warp's
  // 16, bytes 16·(lane / 16) of a step), B as two words of query lane / 4
  const unsigned char* a_row =
      reinterpret_cast<const unsigned char*>(tile + (16 * warp + (lane & 15)) * ld) +
      16 * (lane >> 4);
  const unsigned char* b_row =
      reinterpret_cast<const unsigned char*>(staged + (lane >> 2) * ld) + 4 * (lane & 3);
  const int r = 16 * warp + (lane >> 2);  // the accumulators' rows: r and r + 8
  int p = blockIdx.x * P;
  while (p < p_hi) {
    const int b = ids[p], e = run_end(ids, p, p_hi);
    if (b < 0 || b >= NB) {
      rescore_no_bucket(order, out, p, e);
      p = e;
      continue;
    }
    const long long first = (long long)b * BUCKET;
    const int live = N - first < BUCKET ? (int)(N - first) : BUCKET;  // rows inside the corpus
    for (int t0 = p; t0 < e; t0 += RS_QUERIES) {
      const int cnt = e - t0 < RS_QUERIES ? e - t0 : RS_QUERIES;
      __syncthreads();  // the bucket (of the run before) and the staged queries are free
      if (t0 == p) {
        for (int i = tid; i < live * chunks; i += 256) {
          const int row = i / chunks, c = i - row * chunks;
          cp_async16(tile + row * ld + c, corpus + (size_t)(first + row) * row_bytes + 16 * c);
        }
      }
      for (int i = tid; i < cnt * chunks; i += 256) {
        const int j = i / chunks, c = i - j * chunks;
        const size_t pair = order ? (size_t)order[t0 + j] : (size_t)(t0 + j);
        cp_async16(staged + j * ld + c, queries + (pair / k) * row_bytes + 16 * c);
      }
      cp_async_wait_all();
      __syncthreads();
      Acc acc[4] = {0, 0, 0, 0};
      for (int s = 0; s < ksteps; ++s) {
        uint32_t a[4];
        ldmatrix_x4(a, a_row + 32 * s);
        Tr::mma(acc, a, *reinterpret_cast<const uint32_t*>(b_row + 32 * s),
                *reinterpret_cast<const uint32_t*>(b_row + 32 * s + 16));
      }
      // acc[h], acc[2 + h]: rows r and r + 8 against query 2·(lane % 4) + h
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * (lane & 3) + h;
        if (j < cnt) {
          const size_t pair = order ? (size_t)order[t0 + j] : (size_t)(t0 + j);
          float* o = out + pair * BUCKET;
          o[r] = r < live ? (float)acc[h] : -INFINITY;
          o[r + 8] = r + 8 < live ? (float)acc[2 + h] : -INFINITY;
        }
      }
    }
    p = e;
  }
}

// f32 (exact f32 products), and rows too wide for the kernel above, on the
// FMA units / __dp4a: the bucket comes TR rows at a time (all 128 where two
// blocks of that size fit an SM), thread t on row t % TR for the pairs t / TR,
// t / TR + 256 / TR, ... of the run (Dot16, common.cuh, two sums a row), the
// query read through L1.
template <typename T>
__global__ void __launch_bounds__(256)
rescore_kernel(const T* __restrict__ queries, const T* __restrict__ corpus,
               const int* __restrict__ ids, const long long* __restrict__ order,
               float* __restrict__ out, int N, int D, int k, int n_pairs, int P, int TR) {
  using Acc = typename Dot16<T>::Acc;
  extern __shared__ uint4 tile[];  // [TR][chunks + 1]
  const int tid = threadIdx.x;
  const int chunks = D * (int)sizeof(T) / 16, ld = chunks + 1;
  const int row = tid & (TR - 1), first_pair = tid / TR, pair_step = 256 / TR;
  const int NB = (N + BUCKET - 1) / BUCKET;
  const long long p_end = (long long)(blockIdx.x + 1) * P;
  const int p_hi = p_end < n_pairs ? (int)p_end : n_pairs;
  int p = blockIdx.x * P;
  while (p < p_hi) {
    const int b = ids[p], e = run_end(ids, p, p_hi);
    if (b < 0 || b >= NB) {
      rescore_no_bucket(order, out, p, e);
      p = e;
      continue;
    }
    for (int r0 = 0; r0 < BUCKET; r0 += TR) {
      __syncthreads();  // the tile is free
      const long long first = (long long)b * BUCKET + r0;
      const int live = N - first < TR ? (int)(N - first) : TR;  // rows inside the corpus
      for (int i = tid; i < live * chunks; i += 256) {
        const int r = i / chunks, c = i - r * chunks;
        cp_async16(tile + r * ld + c,
                   reinterpret_cast<const uint4*>(corpus + (size_t)(first + r) * D) + c);
      }
      cp_async_wait_all();
      __syncthreads();
      const uint4* crow = tile + row * ld;
      for (int pp = p + first_pair; pp < e; pp += pair_step) {
        const size_t pair = order ? (size_t)order[pp] : (size_t)pp;
        const uint4* qrow = reinterpret_cast<const uint4*>(queries + (pair / k) * D);
        Acc a0 = 0, a1 = 0;
        int c = 0;
        for (; c + 1 < chunks; c += 2) {
          a0 = Dot16<T>::dot(__ldg(qrow + c), crow[c], a0);
          a1 = Dot16<T>::dot(__ldg(qrow + c + 1), crow[c + 1], a1);
        }
        if (c < chunks) a0 = Dot16<T>::dot(__ldg(qrow + c), crow[c], a0);
        out[pair * BUCKET + r0 + row] = row < live ? (float)(a0 + a1) : -INFINITY;
      }
    }
    p = e;
  }
}

template <typename T>
int launch_rescore(const void* q, const void* c, const int* ids, const long long* order,
                   float* out, int Q, int N, int D, int k, int P, cudaStream_t st) {
  const int ld = D * (int)sizeof(T) / 16 + 1, n_pairs = Q * k;
  if (P < 1) P = 1;
  const int grid = (n_pairs + P - 1) / P;
  if constexpr (!std::is_same<T, float>::value) {
    using Tr = typename std::conditional<std::is_same<T, bf16>::value, Bf16Dot, I8Dot>::type;
    const size_t smem = (size_t)(BUCKET + RS_QUERIES) * ld * 16;
    if (smem <= (size_t)SMEM_MAX) {
      static std::atomic<uint64_t> done{0};
      cudaError_t e = allow_smem(rescore_mma_kernel<Tr>, SMEM_MAX, done);
      if (e != cudaSuccess) return (int)e;
      rescore_mma_kernel<Tr><<<grid, 256, smem, st>>>(
          reinterpret_cast<const unsigned char*>(q), reinterpret_cast<const unsigned char*>(c),
          ids, order, out, N, D * (int)sizeof(T), k, n_pairs, P);
      QST_RETURN_IF_LAUNCH_FAILED();
      return 0;
    }
  }
  static std::atomic<uint64_t> done{0};
  int TR = BUCKET;
  while (TR > 8 && TR * ld * 16 > RS_SMEM_TWO_BLOCKS) TR >>= 1;
  const size_t smem = (size_t)TR * ld * 16;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(rescore_kernel<T>, SMEM_MAX, done);
  if (e != cudaSuccess) return (int)e;
  rescore_kernel<T><<<grid, 256, smem, st>>>(reinterpret_cast<const T*>(q),
                                             reinterpret_cast<const T*>(c), ids, order, out, N,
                                             D, k, n_pairs, P, TR);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace qst

using namespace qst;

extern "C" int qst_bucket_maxima(int dtype, const void* queries, const void* corpus,
                                 void* out, int Q, int N, int D, int n_real, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int NB = (N + BUCKET - 1) / BUCKET;
  float* o = reinterpret_cast<float*>(out);
  if (Q <= 0 || NB <= 0) return 0;
  if (dtype == QST_BF16)
    return launch_bucket_max_wgmma<Bf16Mma>(queries, corpus, o, Q, N, 2 * D, n_real, NB, st);
  if (dtype == QST_I8 && D % 16 == 0)
    return launch_bucket_max_wgmma<I8Mma>(queries, corpus, o, Q, N, D, n_real, NB, st);
  dim3 grid((Q + KB_Q - 1) / KB_Q, NB < MAX_GRID_Y ? NB : MAX_GRID_Y);
  if (dtype == QST_F32) {
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

// `order` may be null (see rescore_kernel); `pairs_per_block` is P.
extern "C" int qst_rescore_buckets(int dtype, const void* queries, const void* corpus,
                                   const void* bucket_ids, const void* order, void* out, int Q,
                                   int N, int D, int k, int pairs_per_block, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* ids = reinterpret_cast<const int*>(bucket_ids);
  const long long* ord = reinterpret_cast<const long long*>(order);
  float* o = reinterpret_cast<float*>(out);
  const int P = pairs_per_block;
  if (Q <= 0 || k <= 0) return 0;
  if (dtype == QST_F32)
    return launch_rescore<float>(queries, corpus, ids, ord, o, Q, N, D, k, P, st);
  if (dtype == QST_BF16)
    return launch_rescore<bf16>(queries, corpus, ids, ord, o, Q, N, D, k, P, st);
  if (dtype == QST_I8)
    return launch_rescore<int8_t>(queries, corpus, ids, ord, o, Q, N, D, k, P, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* qst_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
