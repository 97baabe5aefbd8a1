// K2: one BERT encoder layer, backward — a chain of hand-written kernels.
//
// Replaces: qst_tpu/ops/fused_layer_pallas.py `_layer_bwd_kernel` (:345),
// the TPU kernel behind `_fused_layer_bwd` (:520) and the custom VJP of
// `_make_diff_layer` (:587). That kernel saves only the layer input,
// recomputes the forward in VMEM (remat), regenerates the dropout masks
// from the seed, and returns dx plus all 16 weight gradients, adding each
// grid step's weight gradients into one output block across its
// sequential grid.
//
// What bounds it on the H100: twice the forward's projection FLOPs for the
// backward (dX = dY·Wᵀ and dW = Xᵀ·dY for each of the five products) plus
// the recomputed forward — about 3 × 2·M·(4H² + 2HF) ≈ 174 GFLOP per layer
// at M = B·S = 16,384 and MiniLM widths — over a few hundred MB of f32 and
// bf16 activations: the tensor cores are the limit.
//
// What this design does about it (bf16):
// - the forward recompute reuses K1's kernels (layer_common.cuh), keeping
//   the f32 residual sums, the f32 GELU pre-activation and the bf16
//   activations the backward reads: only the layer input is saved between
//   forward and backward, as on the TPU;
// - all 15 products run on K1's TMA + wgmma GEMM: dX = dY·Wᵀ reads W as it is
//   stored, (N, K), as a K-major operand, with the GELU derivative or the
//   residual gradient fused into the epilogue; dW = Xᵀ·dY reads X as
//   it is stored, (K, M), through wgmma's transpose bit, split over the
//   16,384 token rows into f32 partials;
// - every reduction over token rows (weight, bias and LayerNorm gradients)
//   writes f32 partials that a second pass sums in a fixed order: blocks of
//   a GPU grid run at once, so the TPU's add-into-one-block would race, and
//   atomics would make the gradient differ from run to run;
// - LayerNorm backward runs one warp per row; attention backward one block
//   per (sequence, head) on mma.sync.m16n8k16, with P, dP and dS in
//   registers and the two (S, S) tiles its transposed products need in
//   shared memory as bf16, regenerating P and the dropout mask from the seed
//   as K1 made them (see attention_bwd_mma_kernel), for BERT at S ≤ 128;
//   for 128 < S ≤ 512 or with MPNet's relative bias, the key-blocked
//   backward of attention_kb.cuh, which also returns drel (:457-474,
//   506-507): the logits' gradient summed over the batch inside blocks of
//   one head and tile (groups of sequences when the tiles alone would not
//   fill the card: groups x nh·S² f32 of workspace, 4.7 MB at MPNet-base,
//   B = 128, S = 128, 6.3 MB at S = 256, none from S = 320 up), never
//   B·nh·S² per-sequence partials (906 MB at S = 384).
// The f32 path keeps the SIMT GEMM and the SIMT attention backward: it is
// the comparison path that holds 1e-4.
// bf16 rounding happens where the TPU kernel rounds: df, dipre, da, dctx,
// the dropped probabilities, dS·scale and dq/dk/dv before their products;
// bias gradients sum the f32 values.
#include "attention_kb.cuh"

namespace qst {

// ---------------------------------------------------------------------------
// LayerNorm backward, one warp per row and LN_ROWS rows per warp; lane owns
// columns lane + 32 i (NC = columns per lane, H ≤ 32·NC). r is the f32
// residual sum the forward normalised, dy the gradient at the LayerNorm's
// output. Writes dr (f32), dm = T(dr · dropout mask of `tag`), and one row
// of partial sums per warp: part[warp row][3H] = [Σ dy·n | Σ dy | Σ dm].
// ---------------------------------------------------------------------------
constexpr int LN_ROWS = 8;

template <typename T, typename TD, int NC>
__global__ void __launch_bounds__(256)
layernorm_bwd_kernel(const float* __restrict__ r, const TD* __restrict__ dy,
                     const float* __restrict__ gamma, int M, int H, float eps, DropSite d,
                     uint32_t tag, float* __restrict__ dr, T* __restrict__ dm,
                     float* __restrict__ part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wrow = blockIdx.x * 8 + warp;
  float ag[NC], ab[NC], ad[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) ag[i] = ab[i] = ad[i] = 0.0f;
  for (int rr = 0; rr < LN_ROWS; ++rr) {
    const int row = wrow * LN_ROWS + rr;
    if (row >= M) break;
    const float* x = r + (size_t)row * H;
    const TD* g = dy + (size_t)row * H;  // dy row
    float v[NC], dn[NC];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < H ? x[c] : 0.0f;
      s += v[i];
    }
    const float mean = warp_sum(s) / H;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      const float e = c < H ? v[i] - mean : 0.0f;
      q += e * e;
    }
    const float inv = rsqrtf(warp_sum(q) / H + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      const float n = (v[i] - mean) * inv;  // v[i] becomes n̂
      v[i] = dn[i] = 0.0f;
      if (c < H) {
        const float gy = to_f32(g[c]);
        ag[i] += gy * n;
        ab[i] += gy;
        v[i] = n;
        dn[i] = gy * gamma[c];
        s1 += dn[i];
        s2 += dn[i] * n;
      }
    }
    const float m1 = warp_sum(s1) / H, m2 = warp_sum(s2) / H;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < H) {
        const float drv = inv * (dn[i] - m1 - v[i] * m2);
        dr[(size_t)row * H + c] = drv;
        const float dmv = d.on ? drv * drop_hidden(d, row, c, H, tag) : drv;
        dm[(size_t)row * H + c] = from_f32<T>(dmv);
        ad[i] += dmv;
      }
    }
  }
  float* p = part + (size_t)wrow * 3 * H;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c < H) {
      p[c] = ag[i];
      p[H + c] = ab[i];
      p[2 * H + c] = ad[i];
    }
  }
}

inline int ln_bwd_warp_rows(int M) { return ((M + LN_ROWS - 1) / LN_ROWS + 7) / 8 * 8; }

template <typename T, typename TD>
int launch_layernorm_bwd(const float* r, const TD* dy, const float* gamma, int M, int H,
                         float eps, const DropSite& d, uint32_t tag, float* dr, T* dm,
                         float* part, float* out3, cudaStream_t st) {
  const int rows = ln_bwd_warp_rows(M);
  dim3 grid(rows / 8);
#define QST_LN_BWD(NC)                                                                  \
  layernorm_bwd_kernel<T, TD, NC><<<grid, 256, 0, st>>>(r, dy, gamma, M, H, eps, d, tag, \
                                                         dr, dm, part)
  if (H <= 128) QST_LN_BWD(4);
  else if (H <= 256) QST_LN_BWD(8);
  else if (H <= 384) QST_LN_BWD(12);
  else if (H <= 512) QST_LN_BWD(16);
  else if (H <= 768) QST_LN_BWD(24);
  else if (H <= 1024) QST_LN_BWD(32);
  else return (int)cudaErrorInvalidValue;
#undef QST_LN_BWD
  QST_RETURN_IF_LAUNCH_FAILED();
  return launch_sum_rows(part, rows, 3 * H, out3, st);
}

// ---------------------------------------------------------------------------
// f32 attention backward (SIMT): one block per (head, sequence), blockDim 256, which
// hd (16, 32 or 64) divides, so each thread keeps one column d = tid % hd of
// every (S, hd) output and sums it for the bias gradient. Shared memory:
// X and Y (S x (hd+1) each: Q and K, then V and dC, then Q and K again),
// P (the f32 probabilities before dropout), D (the dropped probabilities
// as rounded for P·V, then dP, then dS·scale as rounded), the mask bias and
// 256 floats for the column sums.
// ---------------------------------------------------------------------------
inline size_t attention_bwd_smem_bytes(int S, int hd) {
  return (size_t)(2 * S * (hd + 1) + 2 * S * S + S + 256) * sizeof(float);
}

// the column sums of the block's threads (tid % hd), in a fixed order
__device__ __forceinline__ void block_colsum(float cs, float* red, int hd, float* out) {
  red[threadIdx.x] = cs;
  __syncthreads();
  if ((int)threadIdx.x < hd) {
    float t = 0.0f;
    for (int j = threadIdx.x; j < (int)blockDim.x; j += hd) t += red[j];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void load_head(const T* __restrict__ src, size_t ld_src, int S,
                                          int hd, float* dst) {
  for (int i = threadIdx.x; i < S * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    dst[r * (hd + 1) + d] = to_f32(src[(size_t)r * ld_src + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                     const float* __restrict__ mask_bias, T* __restrict__ dqkv,
                     float* __restrict__ dbias_part, int S, int H, int hd, float scale,
                     DropSite ad) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, b = blockIdx.y, nh = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int ld = hd + 1;
  float* X = sm;
  float* Y = X + S * ld;
  float* P = Y + S * ld;
  float* D = P + S * S;
  float* bias_s = D + S * S;
  float* red = bias_s + S;
  const size_t row0 = (size_t)b * S;
  const T* q_g = qkv + row0 * 3 * H + h * hd;
  T* dq_g = dqkv + row0 * 3 * H + h * hd;
  float* part = dbias_part + (size_t)b * 3 * H + h * hd;
  const uint32_t seed = ad.on ? drop_step_seed(ad, b / ad.nb) : 0u;
  const uint32_t tag = ad.on ? 16u + (uint32_t)((b % ad.nb) * nh + h) : 0u;

  // recompute P exactly as the forward did
  load_head(q_g, 3 * H, S, hd, X);
  load_head(q_g + H, 3 * H, S, hd, Y);
  for (int j = tid; j < S; j += nthreads) bias_s[j] = mask_bias[row0 + j];
  __syncthreads();
  for (int i = tid; i < S * S; i += nthreads) {
    const int r = i / S, c = i % S;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) acc = fmaf(X[r * ld + d], Y[c * ld + d], acc);
    P[i] = acc * scale + bias_s[c];
  }
  __syncthreads();
  for (int r = warp; r < S; r += nwarps) {
    float* row = P + r * S;
    float m = -INFINITY;
    for (int c = lane; c < S; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float s = 0.0f;
    for (int c = lane; c < S; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int c = lane; c < S; c += 32) row[c] = row[c] / s;
  }
  __syncthreads();

  // V and dC; D = the probabilities P·V used (dropped, rounded)
  load_head(q_g + 2 * H, 3 * H, S, hd, X);
  load_head(dctx + row0 * H + h * hd, H, S, hd, Y);
  for (int i = tid; i < S * S; i += nthreads) {
    float p = P[i];
    if (ad.on) p *= drop_keep(ad, seed, (uint32_t)i, tag);
    D[i] = to_f32(from_f32<T>(p));
  }
  __syncthreads();
  float cs = 0.0f;  // dV = Dᵀ·dC
  for (int i = tid; i < S * hd; i += nthreads) {
    const int k = i / hd, d = i % hd;
    float acc = 0.0f;
    for (int q = 0; q < S; ++q) acc = fmaf(D[q * S + k], Y[q * ld + d], acc);
    dq_g[(size_t)k * 3 * H + 2 * H + d] = from_f32<T>(acc);
    cs += acc;
  }
  block_colsum(cs, red, hd, part + 2 * H);  // (its barrier also ends the reads of D)
  // dP = dC·Vᵀ, through the dropout mask
  for (int i = tid; i < S * S; i += nthreads) {
    const int q = i / S, k = i % S;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) acc = fmaf(Y[q * ld + d], X[k * ld + d], acc);
    if (ad.on) acc *= drop_keep(ad, seed, (uint32_t)i, tag);
    D[i] = acc;
  }
  __syncthreads();
  // dS = P (dP − Σ dP·P), scaled and rounded for its two products
  for (int r = warp; r < S; r += nwarps) {
    const float* p = P + r * S;
    float* dp = D + r * S;
    float s = 0.0f;
    for (int c = lane; c < S; c += 32) s += dp[c] * p[c];
    s = warp_sum(s);
    for (int c = lane; c < S; c += 32) dp[c] = to_f32(from_f32<T>(p[c] * (dp[c] - s) * scale));
  }
  __syncthreads();
  load_head(q_g, 3 * H, S, hd, X);
  load_head(q_g + H, 3 * H, S, hd, Y);
  __syncthreads();
  cs = 0.0f;  // dQ = dS·K
  for (int i = tid; i < S * hd; i += nthreads) {
    const int q = i / hd, d = i % hd;
    float acc = 0.0f;
    for (int k = 0; k < S; ++k) acc = fmaf(D[q * S + k], Y[k * ld + d], acc);
    dq_g[(size_t)q * 3 * H + d] = from_f32<T>(acc);
    cs += acc;
  }
  block_colsum(cs, red, hd, part);
  cs = 0.0f;  // dK = dSᵀ·Q
  for (int i = tid; i < S * hd; i += nthreads) {
    const int k = i / hd, d = i % hd;
    float acc = 0.0f;
    for (int q = 0; q < S; ++q) acc = fmaf(D[q * S + k], X[q * ld + d], acc);
    dq_g[(size_t)k * 3 * H + H + d] = from_f32<T>(acc);
    cs += acc;
  }
  block_colsum(cs, red, hd, part + H);
}

// ---------------------------------------------------------------------------
// bf16 attention backward on the tensor cores: one block per (head,
// sequence), eight warps. Q, K, V and dC are loaded once into shared memory
// as bf16 rows of HD + 8 values (as in the forward). Each warp first owns 16
// query rows: it recomputes the f32 probabilities P in registers exactly as
// the forward made them (attention_probs, then the same dropout mask, kept
// as 64 bits a thread), writes D (the dropped, rounded P that P·V used) to a
// bf16 (S, S) tile in shared memory, takes dP = dC·Vᵀ twice through the
// tensor cores — once for the row term Σ dP·P (quad shuffles), once more
// for dS = P·(dP − Σ)·scale, which costs less than holding dP's 64
// registers — rounds dS to bf16 into a second (S, S) tile and, from the same
// registers, accumulates dQ = dS·K. After one barrier each warp owns 16 key
// rows and reads the two tiles transposed (ldmatrix.trans) for dV = Dᵀ·dC
// and dK = dSᵀ·Q. The tiles' rows are S_pad + 8 values, again for the banks:
// 111 KB a block at S = 128, HD = 32, so two blocks fit an SM.
// The bias gradients — column sums of the f32 dQ, dK and dV — go lanes →
// warps (shared memory) → one row of dbias_part per (sequence, head), in a
// fixed order; launch_sum_rows adds the sequences.
// ---------------------------------------------------------------------------
inline size_t attention_bwd_mma_smem_bytes(int S, int hd) {
  const int S_pad = (S + 15) & ~15;
  return (size_t)4 * S_pad * (hd + ATT_PAD) * sizeof(bf16) +
         (size_t)2 * S_pad * (S_pad + ATT_PAD) * sizeof(bf16) + S_pad * sizeof(float) +
         8 * 3 * hd * sizeof(float);
}

// dP of keys 16·nb2 .. + 15 for the warp's 16 query rows: dC (A operand ca)
// · Vᵀ, through the dropout mask (`keep` bit 4nb + i, `kept` = 1 / (1 - rate))
template <int HD>
__device__ __forceinline__ void dp_block(float (&dp)[2][4], const uint32_t (&ca)[HD / 16][4],
                                         const bf16* Vs, int nb2, uint64_t keep, float kept,
                                         int lane) {
  constexpr int LD = HD + ATT_PAD;
#pragma unroll
  for (int i = 0; i < 4; ++i) dp[0][i] = dp[1][i] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t vb[4];
    ldmatrix_x4(vb, Vs + (nb2 * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
    mma_m16n8k16(dp[0], ca[kk], vb[0], vb[1]);
    mma_m16n8k16(dp[1], ca[kk], vb[2], vb[3]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dp[j][i] = (keep >> (4 * (2 * nb2 + j) + i)) & 1ull ? dp[j][i] * kept : 0.0f;
}

template <int HD>
__global__ void __launch_bounds__(256)
attention_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                         const float* __restrict__ mask_bias, bf16* __restrict__ dqkv,
                         float* __restrict__ dbias_part, int S, int H, float scale,
                         DropSite ad) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  constexpr int LD = HD + ATT_PAD;
  const int h = blockIdx.x, b = blockIdx.y, nh = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S_pad = (S + 15) & ~15, LP = S_pad + ATT_PAD;
  bf16* Qs = reinterpret_cast<bf16*>(att_smem);
  bf16* Ks = Qs + S_pad * LD;
  bf16* Vs = Ks + S_pad * LD;
  bf16* Cs = Vs + S_pad * LD;   // dC
  bf16* Ds = Cs + S_pad * LD;   // D: dropped, rounded probabilities
  bf16* Gs = Ds + S_pad * LP;   // dS·scale, rounded
  float* bias_s = reinterpret_cast<float*>(Gs + S_pad * LP);
  float* red = bias_s + S_pad;  // [8 warps][dQ | dK | dV][HD]

  const size_t row0 = (size_t)b * S;
  const bf16* base = qkv + row0 * 3 * H + h * HD;
  bf16* dbase = dqkv + row0 * 3 * H + h * HD;
  load_head_async<HD>(Qs, base, 3 * H, S, S_pad);
  load_head_async<HD>(Ks, base + H, 3 * H, S, S_pad);
  load_head_async<HD>(Vs, base + 2 * H, 3 * H, S, S_pad);
  load_head_async<HD>(Cs, dctx + row0 * H + h * HD, H, S, S_pad);
  for (int j = tid; j < S; j += 256) bias_s[j] = mask_bias[row0 + j];
  cp_async_wait_all();
  __syncthreads();

  const int r0 = warp * 16;              // this warp's query rows, then key rows
  const bool active = r0 < S_pad;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  float* my_red = red + warp * 3 * HD;
  if (active) {
    float p[16][4];
    attention_probs<HD, false>(p, Qs, Ks, bias_s, nullptr, nullptr, r0, S, S_pad, scale, lane);
    // the dropout mask of this thread's 64 probabilities, bit 4nb + i
    uint64_t keep = ~0ull;
    if (ad.on) {
      const uint32_t seed = drop_step_seed(ad, b / ad.nb);
      const uint32_t tag = 16u + (uint32_t)((b % ad.nb) * nh + h);
      const uint32_t i0 = (uint32_t)((r0 + g) * S + t2);
      keep = 0ull;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) {
        if (nb * 8 < S_pad) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (drop_hash(i0 + nb * 8 + e, seed, tag) < ad.thr) keep |= 1ull << (4 * nb + e);
            if (drop_hash(i0 + 8 * S + nb * 8 + e, seed, tag) < ad.thr)
              keep |= 1ull << (4 * nb + 2 + e);
          }
        }
      }
    }
    const float kept = ad.on ? ad.scale : 1.0f;
    const bool row_a = r0 + g < S, row_b = r0 + g + 8 < S;  // real query rows
    // D → shared memory (zeros in the rows past S)
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      if (nb * 8 < S_pad) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = (keep >> (4 * nb + i)) & 1ull ? p[nb][i] * kept : 0.0f;
        *reinterpret_cast<uint32_t*>(Ds + (r0 + g) * LP + nb * 8 + t2) =
            row_a ? pack_bf16(v[0], v[1]) : 0u;
        *reinterpret_cast<uint32_t*>(Ds + (r0 + g + 8) * LP + nb * 8 + t2) =
            row_b ? pack_bf16(v[2], v[3]) : 0u;
      }
    }
    // dP of 16 keys: dC (this warp's rows) · Vᵀ, through the dropout mask
    uint32_t ca[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(ca[kk], Cs + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    float sum_a = 0.0f, sum_b = 0.0f;  // Σ dP·P of rows r0 + g and eight below
#pragma unroll
    for (int nb2 = 0; nb2 < 8; ++nb2) {
      if (nb2 * 16 < S_pad) {
        float dp[2][4];
        dp_block<HD>(dp, ca, Vs, nb2, keep, kept, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sum_a += dp[j][0] * p[2 * nb2 + j][0] + dp[j][1] * p[2 * nb2 + j][1];
          sum_b += dp[j][2] * p[2 * nb2 + j][2] + dp[j][3] * p[2 * nb2 + j][3];
        }
      }
    }
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
    // dS → shared memory and, from the same registers, dQ = dS·K
    float dq[HD / 8][4];
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[nb][i] = 0.0f;
#pragma unroll
    for (int nb2 = 0; nb2 < 8; ++nb2) {
      if (nb2 * 16 < S_pad) {
        float dp[2][4];
        dp_block<HD>(dp, ca, Vs, nb2, keep, kept, lane);
        uint32_t a[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nb = 2 * nb2 + j;
          const float s0 = row_a ? p[nb][0] * (dp[j][0] - sum_a) * scale : 0.0f;
          const float s1 = row_a ? p[nb][1] * (dp[j][1] - sum_a) * scale : 0.0f;
          const float s2 = row_b ? p[nb][2] * (dp[j][2] - sum_b) * scale : 0.0f;
          const float s3 = row_b ? p[nb][3] * (dp[j][3] - sum_b) * scale : 0.0f;
          a[2 * j] = pack_bf16(s0, s1);
          a[2 * j + 1] = pack_bf16(s2, s3);
          *reinterpret_cast<uint32_t*>(Gs + (r0 + g) * LP + nb * 8 + t2) = a[2 * j];
          *reinterpret_cast<uint32_t*>(Gs + (r0 + g + 8) * LP + nb * 8 + t2) = a[2 * j + 1];
        }
        mma_rows_trans<HD>(dq, a, Ks + nb2 * 16 * LD, LD, lane);
      }
    }
    store_rows_bf16<HD>(dbase, 3 * H, dq, r0, S, lane);
    warp_colsum<HD>(dq, my_red, lane);
  } else if (lane < 4) {
    for (int i = lane; i < 3 * HD; i += 4) my_red[i] = 0.0f;
  }
  __syncthreads();

  if (active) {  // key rows r0 .. r0 + 15: dV = Dᵀ·dC, dK = dSᵀ·Q
    float dv[HD / 8][4], dk[HD / 8][4];
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[nb][i] = dk[nb][i] = 0.0f;
#pragma unroll 1
    for (int qt = 0; qt < S_pad; qt += 16) {
      // Aᵀ from the (query, key) tiles: lanes 8i..8i+7 address eight query
      // lines of matrix i = (queries + 8·(i/2), keys + 8·(i%2))
      const int off = (qt + ((lane >> 4) << 3) + (lane & 7)) * LP + r0 + ((lane >> 3) & 1) * 8;
      uint32_t a[4];
      ldmatrix_x4_trans(a, Ds + off);
      mma_rows_trans<HD>(dv, a, Cs + qt * LD, LD, lane);
      ldmatrix_x4_trans(a, Gs + off);
      mma_rows_trans<HD>(dk, a, Qs + qt * LD, LD, lane);
    }
    store_rows_bf16<HD>(dbase + H, 3 * H, dk, r0, S, lane);
    store_rows_bf16<HD>(dbase + 2 * H, 3 * H, dv, r0, S, lane);
    warp_colsum<HD>(dk, my_red + HD, lane);
    warp_colsum<HD>(dv, my_red + 2 * HD, lane);
  }
  __syncthreads();
  if (tid < 3 * HD) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * 3 * HD + tid];
    dbias_part[(size_t)b * 3 * H + (tid / HD) * H + h * HD + tid % HD] = s;
  }
}

template <int HD>
int launch_attention_bwd_mma(const bf16* qkv, const bf16* dctx, const float* mask_bias,
                             bf16* dqkv, float* part, int B, int S, int H, int nh,
                             const DropSite& ad, cudaStream_t st) {
  static std::atomic<uint64_t> done{0};
  cudaError_t e = allow_smem(attention_bwd_mma_kernel<HD>,
                             attention_bwd_mma_smem_bytes(kSmallSeq, HD), done);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_mma_kernel<HD><<<dim3(nh, B), 256, attention_bwd_mma_smem_bytes(S, HD), st>>>(
      qkv, dctx, mask_bias, dqkv, part, S, H, 1.0f / sqrtf((float)HD), ad);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

template <typename T>
int launch_attention_bwd(const T* qkv, const T* dctx, const float* mask_bias, T* dqkv,
                         float* part, int B, int S, int H, int nh, const DropSite& ad,
                         cudaStream_t st) {
  const int hd = H / nh;
  if constexpr (std::is_same<T, bf16>::value) {
    if (hd == 16)
      return launch_attention_bwd_mma<16>(qkv, dctx, mask_bias, dqkv, part, B, S, H, nh, ad, st);
    if (hd == 32)
      return launch_attention_bwd_mma<32>(qkv, dctx, mask_bias, dqkv, part, B, S, H, nh, ad, st);
    if (hd == 64)
      return launch_attention_bwd_mma<64>(qkv, dctx, mask_bias, dqkv, part, B, S, H, nh, ad, st);
    return (int)cudaErrorInvalidValue;
  } else {
    static std::atomic<uint64_t> done{0};
    cudaError_t e = allow_smem(attention_bwd_kernel<T>,
                               attention_bwd_smem_bytes(kSmallSeq, kMaxHeadDim), done);
    if (e != cudaSuccess) return (int)e;
    attention_bwd_kernel<T><<<dim3(nh, B), 256, attention_bwd_smem_bytes(S, hd), st>>>(
        qkv, dctx, mask_bias, dqkv, part, S, H, hd, 1.0f / sqrtf((float)hd), ad);
    QST_RETURN_IF_LAUNCH_FAILED();
    return 0;
  }
}

// ---------------------------------------------------------------------------
// The workspace: forward activations, backward intermediates, partial sums.
// ---------------------------------------------------------------------------
struct Workspace {
  size_t used = 0;
  char* base;
  explicit Workspace(void* p) : base(reinterpret_cast<char*>(p)) {}
  template <typename U>
  U* take(size_t n) {
    U* p = base ? reinterpret_cast<U*>(base + used) : nullptr;
    used += (n * sizeof(U) + 255) / 256 * 256;
    return p;
  }
};

template <typename T>
struct BwdBuffers {
  T *qkv, *ctx, *y, *inter, *df, *dipre, *da, *dctx, *dqkv;
  float *r1, *ipre, *r2, *dr2, *dy, *dr1, *ln_part, *col_part, *attn_part, *splitk;
  float *stats, *drel_part;  // the key-blocked path's row statistics and drel groups
  size_t bytes;

  // the key-blocked attention backward: S > 128, or the relative bias
  static bool key_blocked(int S, bool rel) { return S > kSmallSeq || rel; }

  BwdBuffers(void* ws, int B, int S, int H, int F, int nh, bool rel) {
    const size_t M = (size_t)B * S;
    Workspace w(ws);
    qkv = w.take<T>(M * 3 * H);
    ctx = w.take<T>(M * H);
    y = w.take<T>(M * H);
    inter = w.take<T>(M * F);
    df = w.take<T>(M * H);
    dipre = w.take<T>(M * F);
    da = w.take<T>(M * H);
    dctx = w.take<T>(M * H);
    dqkv = w.take<T>(M * 3 * H);
    r1 = w.take<float>(M * H);
    ipre = w.take<float>(M * F);
    r2 = w.take<float>(M * H);
    dr2 = w.take<float>(M * H);
    dy = w.take<float>(M * H);
    dr1 = w.take<float>(M * H);
    ln_part = w.take<float>((size_t)ln_bwd_warp_rows((int)M) * 3 * H);
    col_part = w.take<float>((size_t)gemm_row_tiles<T>((int)M) * F);
    const bool kb = key_blocked(S, rel);
    attn_part = w.take<float>((size_t)B * (kb ? kb_tiles<T>(S) : 1) * 3 * H);
    stats = w.take<float>(kb ? (size_t)3 * B * nh * S : 0);
    const int groups = rel ? drel_groups<T>(B, S, nh, nullptr) : 1;
    drel_part = w.take<float>(groups > 1 ? (size_t)groups * nh * S * S : 0);
    size_t sk = 0;
    const int shapes[4][2] = {{F, H}, {H, F}, {H, H}, {H, 3 * H}};
    for (const auto& s : shapes) {
      const size_t n = (size_t)gemm_splits<T>(s[0], s[1], (int)M) * s[0] * s[1];
      sk = n > sk ? n : sk;
    }
    splitk = w.take<float>(sk);
    bytes = w.used;
  }
};

// dvec = [dbq dbk dbv (3H) | dln1_g dln1_b dbo (3H) | db1 (F) | dln2_g dln2_b db2 (3H)]
template <typename T>
int fused_layer_backward(const T* x, const float* mask_bias, const T* wqkv, const float* bqkv,
                         const T* wo, const float* bo, const float* ln1_g,
                         const float* ln1_b, const T* w1, const float* b1, const T* w2,
                         const float* b2, const float* ln2_g, const float* ln2_b,
                         const float* rel, const T* g, T* dx, float* dwqkv, float* dwo,
                         float* dw1, float* dw2, float* dvec, float* drel, void* workspace,
                         int B, int S, int H, int F, int nh,
                         float eps, const DropSite& attn_drop, const DropSite& hid_drop,
                         cudaStream_t st) {
  const int M = B * S, hd = H / nh;
  if (S > kMaxSeq || hd > kMaxHeadDim || 256 % hd || (rel && !drel))
    return (int)cudaErrorInvalidValue;
  const bool kb = BwdBuffers<T>::key_blocked(S, rel != nullptr);
  BwdBuffers<T> w(workspace, B, S, H, F, nh, rel != nullptr);
  float* d_qkv_b = dvec;
  float* d_ln1 = dvec + 3 * H;
  float* d_b1 = dvec + 6 * H;
  float* d_ln2 = dvec + 6 * H + F;
  int err;

  // ---- forward recompute (K1's kernels), keeping what the backward reads
  EpiArgs ep;
  ep.bias = bqkv;
  if ((err = launch_gemm<T, EPI_BIAS>(x, wqkv, w.qkv, M, 3 * H, H, ep, st))) return err;
  if ((err = launch_attention<T>(w.qkv, mask_bias, rel, w.ctx, B, S, H, nh, attn_drop, st)))
    return err;
  EpiArgs res;
  res.bias = bo;
  res.resid = x;
  res.drop = hid_drop;
  res.drop_tag = 0;
  if ((err = launch_gemm<T, EPI_BIAS_RESID_F32>(w.ctx, wo, w.r1, M, H, H, res, st))) return err;
  if ((err = launch_layernorm<T>(w.r1, ln1_g, ln1_b, w.y, M, H, eps, st))) return err;
  EpiArgs up;
  up.bias = b1;
  up.aux = w.ipre;
  if ((err = launch_gemm<T, EPI_BIAS_GELU_SAVE>(w.y, w1, w.inter, M, F, H, up, st))) return err;
  res.bias = b2;
  res.resid = w.y;
  res.drop_tag = 1;
  if ((err = launch_gemm<T, EPI_BIAS_RESID_F32>(w.inter, w2, w.r2, M, H, F, res, st)))
    return err;

  // ---- LayerNorm 2 and the FFN
  if ((err = launch_layernorm_bwd<T, T>(w.r2, g, ln2_g, M, H, eps, hid_drop, 1, w.dr2, w.df,
                                        w.ln_part, d_ln2, st)))
    return err;
  EpiArgs gg;
  gg.aux = w.ipre;
  gg.colpart = w.col_part;
  if ((err = launch_gemm<T, EPI_GELU_GRAD, false, true>(w.df, w2, w.dipre, M, F, H, gg, st)))
    return err;
  if ((err = launch_sum_rows(w.col_part, gemm_row_tiles<T>(M), F, d_b1, st))) return err;
  if ((err = launch_weight_grad<T>(w.inter, w.df, dw2, w.splitk, F, H, M, st))) return err;
  if ((err = launch_weight_grad<T>(w.y, w.dipre, dw1, w.splitk, H, F, M, st))) return err;
  EpiArgs add;
  add.resid = w.dr2;
  if ((err = launch_gemm<T, EPI_ADD_F32, false, true>(w.dipre, w1, w.dy, M, H, F, add, st)))
    return err;

  // ---- LayerNorm 1 and the attention output projection
  if ((err = launch_layernorm_bwd<T, float>(w.r1, w.dy, ln1_g, M, H, eps, hid_drop, 0, w.dr1,
                                            w.da, w.ln_part, d_ln1, st)))
    return err;
  if ((err = launch_weight_grad<T>(w.ctx, w.da, dwo, w.splitk, H, H, M, st))) return err;
  if ((err = launch_gemm<T, EPI_STORE, false, true>(w.da, wo, w.dctx, M, H, H, EpiArgs{}, st)))
    return err;

  // ---- attention, then Q, K and V as one product
  if (!kb) {
    if ((err = launch_attention_bwd<T>(w.qkv, w.dctx, mask_bias, w.dqkv, w.attn_part, B, S, H,
                                       nh, attn_drop, st)))
      return err;
  } else if (rel) {
    if ((err = launch_attention_bwd_kb<T, true>(w.qkv, w.dctx, mask_bias, rel, w.dqkv, w.stats,
                                                w.attn_part, drel, w.drel_part, B, S, H, nh,
                                                attn_drop, st)))
      return err;
  } else if ((err = launch_attention_bwd_kb<T, false>(w.qkv, w.dctx, mask_bias, rel, w.dqkv,
                                                      w.stats, w.attn_part, drel, w.drel_part, B,
                                                      S, H, nh, attn_drop, st))) {
    return err;
  }
  if ((err = launch_sum_rows(w.attn_part, B * (kb ? kb_tiles<T>(S) : 1), 3 * H, d_qkv_b, st)))
    return err;
  if ((err = launch_weight_grad<T>(x, w.dqkv, dwqkv, w.splitk, H, 3 * H, M, st))) return err;
  EpiArgs to_x;
  to_x.resid = w.dr1;
  return launch_gemm<T, EPI_ADD_F32_TO_T, false, true>(w.dqkv, wqkv, dx, M, H, 3 * H, to_x,
                                                        st);
}

}  // namespace qst

using namespace qst;

extern "C" size_t qst_fused_layer_backward_workspace(int dtype, int B, int S, int H, int F,
                                                     int nh, int rel) {
  if (dtype == QST_BF16) return BwdBuffers<bf16>(nullptr, B, S, H, F, nh, rel != 0).bytes;
  return BwdBuffers<float>(nullptr, B, S, H, F, nh, rel != 0).bytes;
}

extern "C" int qst_fused_layer_backward(
    int dtype, const void* x, const void* mask_bias, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* ln1_g, const void* ln1_b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* ln2_g, const void* ln2_b,
    const void* rel, const void* g, void* dx, void* dwqkv, void* dwo, void* dw1, void* dw2,
    void* dvec, void* drel, void* workspace, int B, int S, int H, int F, int nh, float eps,
    const void* seed, int nb,
    int attn_on, unsigned attn_thr, float attn_scale, int hid_on, unsigned hid_thr,
    float hid_scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const DropSite ad = drop_site(seed, attn_on, attn_thr, attn_scale, nb, S);
  const DropSite hdp = drop_site(seed, hid_on, hid_thr, hid_scale, nb, S);
#define QST_F(p) reinterpret_cast<const float*>(p)
#define QST_BWD(T)                                                                        \
  fused_layer_backward<T>(                                                                \
      reinterpret_cast<const T*>(x), QST_F(mask_bias), reinterpret_cast<const T*>(wqkv),  \
      QST_F(bqkv), reinterpret_cast<const T*>(wo), QST_F(bo), QST_F(ln1_g), QST_F(ln1_b), \
      reinterpret_cast<const T*>(w1), QST_F(b1), reinterpret_cast<const T*>(w2),          \
      QST_F(b2), QST_F(ln2_g), QST_F(ln2_b), QST_F(rel), reinterpret_cast<const T*>(g),   \
      reinterpret_cast<T*>(dx), reinterpret_cast<float*>(dwqkv),                          \
      reinterpret_cast<float*>(dwo), reinterpret_cast<float*>(dw1),                       \
      reinterpret_cast<float*>(dw2), reinterpret_cast<float*>(dvec),                      \
      reinterpret_cast<float*>(drel), workspace, B, S, H, F, nh, eps, ad, hdp, st)
  if (dtype == QST_F32) return QST_BWD(float);
  if (dtype == QST_BF16) return QST_BWD(bf16);
#undef QST_BWD
#undef QST_F
  return (int)cudaErrorInvalidValue;
}

// The bf16 GEMM alone: C (M, N) f32 = op(A)·op(B), split-K partials in ws
// ((splits, M, N) f32) summed in order — for holding each operand layout
// (ta: A stored (K, M); tb: B stored (N, K)) against a plain product.
extern "C" int qst_layer_gemm_bf16(const void* A, const void* B, void* C, void* ws, int M, int N,
                                   int K, int ta, int tb, int splits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* a = reinterpret_cast<const bf16*>(A);
  const bf16* b = reinterpret_cast<const bf16*>(B);
  if (splits < 1 || N % 4) return (int)cudaErrorInvalidValue;
  const EpiArgs ep{};
  int err;
  if (ta && tb)
    err = launch_gemm<bf16, EPI_PARTIAL, true, true>(a, b, ws, M, N, K, ep, st, splits);
  else if (ta)
    err = launch_gemm<bf16, EPI_PARTIAL, true, false>(a, b, ws, M, N, K, ep, st, splits);
  else if (tb)
    err = launch_gemm<bf16, EPI_PARTIAL, false, true>(a, b, ws, M, N, K, ep, st, splits);
  else
    err = launch_gemm<bf16, EPI_PARTIAL, false, false>(a, b, ws, M, N, K, ep, st, splits);
  if (err) return err;
  return launch_sum_rows(reinterpret_cast<const float*>(ws), splits, M * N,
                         reinterpret_cast<float*>(C), st);
}
