// Streaming logsumexp over a full catalog for Hopper (sm_90a), and its two
// gradients.
//
// Replaces the TPU kernels of chaorec_tpu/ops/pallas_lse.py:
//   _fwd_kernel (:44)  lse[b]   = log sum_j exp(q_b . k_j)
//   _dq_kernel  (:95)  dq[b]    = g_b sum_j exp(q_b . k_j - lse_b) k_j
//   _dk_kernel  (:116) dk[j]    = sum_b exp(q_b . k_j - lse_b) g_b q_b
// for q (B, E) and k (N, E) fp32, row-major and contiguous, 1 <= E <= 256.
// The logits never reach device memory; the contrastive losses of the
// SSL models call this with k a whole user or item table (N 15-30 k).
//
// What bounds it. Each call does 2 B N E flops for the logits (dq and dk
// twice that) and moves only q, k and (B,) or (N, E) results: at B 1024,
// N 28940, E 64 that is 3.8 GFLOP against 8 MB, 0.057 ms at the card's
// 67 TFLOP/s of fp32 FMA and 0.002 ms at 3.35 TB/s. So it is bound by
// fp32 arithmetic (the logits are summed in fp32 FMA, not on tensor
// cores, as the TPU kernel sums them in fp32), then by the shared-memory
// reads that feed the FMAs, and by one exp per logit.
//
// The generic path (E != 64, or an unaligned q or k). A block of
// 256 threads computes a 64 x 64 tile of logits at a time from a 64-row q
// tile and a 64-row k tile staged in shared memory, each thread a 4 x 4
// register tile (rows ty + 16 i, columns tx + 16 j), with 16-byte shared
// loads that hit 32 distinct banks (the row stride is padded to 4 mod 32
// floats). Every ragged edge (B, N, E) is masked here: out-of-range rows
// load as zeros, and no padded copy of q or k exists.
//
// - Forward and dq: B = 1024 is only 16 row tiles, so the catalog is also
//   split across blocks (grid = row tiles x catalog splits, about four
//   blocks per SM). A forward block keeps a running (max, sum) per row
//   over its split's k tiles (the TPU kernel's online rescale, needed
//   because logits of unit rows over a temperature of 0.01 reach +-100),
//   reduces it across the 16 threads of a row with shuffles and writes one
//   partial pair per row; a second pass combines the splits in a fixed
//   order. A split with no valid column holds (-1e30, 0): the finite
//   floor keeps every exp(m_old - m_new) a real number, as the TPU's _NEG
//   does. A dq block stages p = exp(logit - lse) in shared memory, adds
//   p . k_tile into a register tile of its rows' dq, and writes its
//   split's partial (B, E); the second pass sums the splits in order and
//   scales by g.
// - dk: parallel over the catalog already. A block owns 64 k rows and
//   walks every q tile, with lse and g staged beside it, accumulating
//   (p * g)^T . q_tile in registers; each dk row is written once.
//
// At E = 64 (the path's only width), one tile engine for all three, in
// namespace e64: lse_fwd64_kernel and lse_bwd64_kernel.
// - 128 threads (4 warps). A block keeps 128 rows of one side (the staying
//   tile: q for the forward and dq, k for dk) and streams the other in
//   64-row tiles. Each thread owns 8 staying rows (warp w: rows
//   32 w + (lane / 8) + 4 i) and, of each streamed tile, 8 columns
//   (lane % 8 + 8 j): an 8 x 8 register tile of logits. Each 4-wide step of
//   E reads 16 float4 from shared memory for 256 FMAs: 4 FMAs a word read
//   by a thread (the generic path's 4 x 4 tile gives 2), and a warp's loads
//   of one row are broadcasts to 8 or 4 of its threads. Every such load
//   falls on distinct banks (row strides 68 and 72 floats: 4 and 8 mod 32).
// - Streamed tiles come by cp.async (16 bytes a copy, rows past the end
//   zero-filled) into a ring of two stages: tile t + 1 is in flight while
//   tile t is computed. Two block barriers a tile (the stage has landed;
//   its readers are done).
// - The streamed side is split across blocks (grid = staying tiles x
//   splits): the forward and dq split the catalog; dk splits B where
//   ceil(N / 128) blocks would leave SMs idle (the item side's 119 tiles on
//   132 SMs). Each split writes a partial, and a second pass combines the
//   splits in order (the forward merges (max, sum) pairs, dq sums and
//   scales by g, dk sums); one dk split writes dk directly.
// - Forward (lse_fwd64_kernel, 68 KB of shared memory and 248 registers,
//   2 blocks an SM; held to 168 registers for 3, it spilled and ran SGL's
//   user side 2% slower): each thread keeps a running (max, sum) for each
//   of its 8 rows. A tile takes the max of the row's 8 logits first, then
//   one rescale exp2 of the old sum and 8 exp2 of fmaf(logit, log2 e,
//   -max log2 e): one exp a logit and one a row a tile (the generic kernel
//   rescales once every 4 logits). Columns past N (the zero-filled rows of the catalog's last
//   tile) are set to -inf in that tile only. At the end the 8 threads of a
//   row (lane % 8) merge their pairs by shuffles (xor 1, 2, 4, in that
//   order) and one writes the split's pair. Its grid is one wave, laid
//   out so that the busiest SM computes the fewest tiles
//   (ops/streaming_lse.py:forward_splits; 33 x 8 blocks of 14 tiles at
//   SGL's user side, 30 x 8 of 8 at the item side).
// - Backward (lse_bwd64_kernel, 105 KB, 2 blocks an SM): dq and dk differ
//   only in which operand stays, where lse and g enter (dq: per staying
//   row, g in the combine pass; dk: per streamed row, both in p) and which
//   side is split. The logit tile becomes p, which goes from a thread to
//   the 8 threads that share its rows (all in its warp) through the warp's
//   own slab of shared memory (32 rows x 64), behind a __syncwarp, not a
//   block barrier; then an 8 x 8 tile of its rows' output (columns
//   4 (lane % 8) .. + 3 and 32 + the same) takes p . the streamed tile.
// The E = 64 path needs q and k 16-byte aligned (cp.async); the wrapper
// sends any other q or k down the generic path.
// No atomics: the same inputs on the same card give the same bits.
//
// Each C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = threadIdx.x % 16, ty = threadIdx.x / 16
constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kMaxE = 256;
constexpr int kPLd = kTile + 4;  // row stride of the staged p tile (4 mod 32)
constexpr float kNeg = -1e30f;

// Row stride (floats) of a staged (rows, e4) tile: a multiple of 4 that is
// 4 mod 32, so the 16-byte loads of rows tx + 16 j fall on distinct banks.
__host__ __device__ constexpr int row_stride(int e4) { return e4 + (36 - e4 % 32) % 32; }

// rows [row0, row0 + kTile) of src (total rows, e) into dst (kTile, ld),
// zero past the last row and in columns e .. e4 - 1.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          long long row0, long long total, int e, int e4) {
  for (int idx = threadIdx.x; idx < kTile * e4; idx += kThreads) {
    const int r = idx / e4;
    const int c = idx - r * e4;
    const long long gr = row0 + r;
    dst[r * ld + c] = (gr < total && c < e) ? __ldg(src + gr * e + c) : 0.f;
  }
}

// s[i][j] = qs row (ty + 16 i) . ks row (tx + 16 j), over e4 columns.
__device__ __forceinline__ void tile_logits(const float* qs, const float* ks, int ld, int e4,
                                            float s[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  }
#pragma unroll 2
  for (int c = 0; c < e4; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * ld + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ld + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        s[i][j] = t;
      }
    }
  }
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// acc[i][m] += sum_{r < kTile} p[row (ty + 16 i)][r] * x[r][tx * 4 + 64 m .. + 3],
// p staged (kTile, kPLd), x staged (kTile, ld). NC = ceil(e4 / 64).
template <int NC>
__device__ __forceinline__ void tile_product(const float* p, const float* x, int ld, int e4,
                                             float4 acc[4][NC]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kPLd + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int col = tx * 4 + 64 * m;
        if (col < e4) {
          const float4 xv = *reinterpret_cast<const float4*>(x + (r + rr) * ld + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = comp(pv[i], rr);
            acc[i][m].x = fmaf(w, xv.x, acc[i][m].x);
            acc[i][m].y = fmaf(w, xv.y, acc[i][m].y);
            acc[i][m].z = fmaf(w, xv.z, acc[i][m].z);
            acc[i][m].w = fmaf(w, xv.w, acc[i][m].w);
          }
        }
      }
    }
  }
}

// Row `row` (< rows) of an (rows, e) fp32 output from acc[i][m] columns.
template <int NC>
__device__ __forceinline__ void store_rows(float* __restrict__ out, long long row0, long long rows,
                                           int e, float4 acc[4][NC]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int col = tx * 4 + 64 * m;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col + c < e) out[r * e + col + c] = comp(acc[i][m], c);
      }
    }
  }
}

// (m, s) <- the merge of two running (max, sum of exp(x - max)) pairs.
__device__ __forceinline__ void merge(float& m, float& s, float mo, float so) {
  const float mn = fmaxf(m, mo);
  s = s * __expf(m - mn) + so * __expf(mo - mn);
  m = mn;
}

// grid (row tiles, splits): per row, the (max, sum) over split y's k tiles.
__global__ void __launch_bounds__(kThreads)
    lse_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   float* __restrict__ part_m, float* __restrict__ part_s, int b, int n, int e,
                   int e4, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  const int ld = row_stride(e4);
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * ld;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  const int split = blockIdx.y;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);

  load_tile(qs, ld, q, row0, b, e, e4);
  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    s[i] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the last tile's readers are done (and q is staged)
    load_tile(ks, ld, k, static_cast<long long>(t) * kTile, n, e, e4);
    __syncthreads();
    float sc[4][4];
    tile_logits(qs, ks, ld, e4, sc);
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) valid[j] = t * kTile + tx + 16 * j < n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (valid[j]) tmax = fmaxf(tmax, sc[i][j]);
      }
      const float mn = fmaxf(m[i], tmax);
      float acc = s[i] * __expf(m[i] - mn);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (valid[j]) acc += __expf(sc[i][j] - mn);
      }
      m[i] = mn;
      s[i] = acc;
    }
  }
  // the 16 threads of a row are one half of a warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[i], off);
      merge(m[i], s[i], mo, so);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long r = row0 + ty + 16 * i;
      if (r < b) {
        part_m[split * static_cast<long long>(b) + r] = m[i];
        part_s[split * static_cast<long long>(b) + r] = s[i];
      }
    }
  }
}

// lse[r] = the merge of row r's partial pairs, splits in order.
__global__ void lse_combine_kernel(const float* __restrict__ part_m,
                                   const float* __restrict__ part_s, float* __restrict__ lse,
                                   int b, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= b) return;
  float m = kNeg, s = 0.f;
  for (int i = 0; i < splits; ++i) {
    merge(m, s, part_m[static_cast<long long>(i) * b + r], part_s[static_cast<long long>(i) * b + r]);
  }
  lse[r] = m + logf(s);
}

// grid (row tiles, splits): split y's partial sum_j p_bj k_j, (B, E) each.
template <int NC>
__global__ void __launch_bounds__(kThreads)
    lse_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ lse, float* __restrict__ part, int b, int n, int e,
                  int e4, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  const int ld = row_stride(e4);
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * ld;
  float* ps = ks + kTile * ld;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  const int split = blockIdx.y;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);

  load_tile(qs, ld, q, row0, b, e, e4);
  float lr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty + 16 * i;
    lr[i] = r < b ? __ldg(lse + r) : 0.f;
  }
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int mm = 0; mm < NC; ++mm) acc[i][mm] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int t = t0; t < t1; ++t) {
    __syncthreads();
    load_tile(ks, ld, k, static_cast<long long>(t) * kTile, n, e, e4);
    __syncthreads();
    float sc[4][4];
    tile_logits(qs, ks, ld, e4, sc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = t * kTile + tx + 16 * j < n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ps[(ty + 16 * i) * kPLd + tx + 16 * j] = valid ? __expf(sc[i][j] - lr[i]) : 0.f;
      }
    }
    __syncthreads();
    tile_product<NC>(ps, ks, ld, e4, acc);
  }
  store_rows<NC>(part + split * static_cast<long long>(b) * e, row0, b, e, acc);
}

// dq[r][c] = g[r] * sum over splits (in order) of part[split][r][c].
__global__ void dq_combine_kernel(const float* __restrict__ part, const float* __restrict__ g,
                                  float* __restrict__ dq, int b, int e, int splits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(b) * e;
  if (idx >= total) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[i * total + idx];
  dq[idx] = s * __ldg(g + idx / e);
}

// grid (k tiles): dk rows [64 x, 64 x + 64) = sum_b p_bj g_b q_b over all q tiles.
template <int NC>
__global__ void __launch_bounds__(kThreads)
    lse_dk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  float* __restrict__ dk, int b, int n, int e, int e4) {
  extern __shared__ float4 smem4[];
  __shared__ float lse_s[kTile], g_s[kTile];
  const int ld = row_stride(e4);
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * ld;
  float* pt = ks + kTile * ld;  // (p * g) transposed: pt[k row][q row]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile;

  load_tile(ks, ld, k, col0, n, e, e4);
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int mm = 0; mm < NC; ++mm) acc[i][mm] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (long long row0 = 0; row0 < b; row0 += kTile) {
    __syncthreads();
    load_tile(qs, ld, q, row0, b, e, e4);
    if (threadIdx.x < kTile) {
      const long long r = row0 + threadIdx.x;
      // rows past B weigh 0; their logits are 0 (q rows of zeros)
      lse_s[threadIdx.x] = r < b ? __ldg(lse + r) : 0.f;
      g_s[threadIdx.x] = r < b ? __ldg(g + r) : 0.f;
    }
    __syncthreads();
    float sc[4][4];
    tile_logits(qs, ks, ld, e4, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
      const float li = lse_s[qr], gi = g_s[qr];
#pragma unroll
      for (int j = 0; j < 4; ++j) pt[(tx + 16 * j) * kPLd + qr] = __expf(sc[i][j] - li) * gi;
    }
    __syncthreads();
    tile_product<NC>(pt, qs, ld, e4, acc);
  }
  store_rows<NC>(dk, col0, n, e, acc);
}

// ---------------------------------------------------------------------------
// The backward pair at E = 64: lse_bwd64_kernel (see the note at the top).

namespace e64 {

constexpr int kE = 64;
constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 128;     // staying rows a block, 32 a warp
constexpr int kCols = kTile;   // streamed rows a tile
constexpr int kLd = kE + 4;    // row stride of the staged tiles: 4 mod 32
constexpr int kPLd = kCols + 8;  // row stride of a warp's p slab: 8 mod 32
constexpr int kStayFloats = kRows * kLd;
constexpr int kStageFloats = kCols * kLd;
constexpr int kSlabFloats = 32 * kPLd;
// staying tile, two streamed stages, four p slabs, and (dk) lse and g of
// each stage's rows
constexpr int kSmemBytes = (kStayFloats + 2 * kStageFloats + 4 * kSlabFloats + 2 * 2 * kCols) *
                           static_cast<int>(sizeof(float));
// the forward: the staying tile and two streamed stages (68 KB, 2 blocks an SM)
constexpr int kFwdSmemBytes = (kStayFloats + 2 * kStageFloats) * static_cast<int>(sizeof(float));
constexpr int kFwdBlocksPerSm = 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// cp.async rows [row0, row0 + ROWS) of src (total rows, 64) into dst
// (ROWS, kLd); rows past the last are zeros.
template <int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           long long row0, long long total) {
#pragma unroll
  for (int u = 0; u < ROWS * 16 / kThreads; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int r = idx >> 4, c = (idx & 15) * 4;
    const long long gr = row0 + r;
    const bool valid = gr < total;
    cp_async16(dst + r * kLd + c, src + (valid ? gr * kE + c : 0), valid);
  }
}

// kDk false (dq): stay = q (n_stay = B), stream = k (n_stream = N); part
// (splits, B, 64) gets sum_j p_bj k_j over split y's k tiles, p_bj =
// exp(q_b . k_j - lse_b).
// kDk true (dk): stay = k (n_stay = N), stream = q (n_stream = B); part
// (splits, N, 64) gets sum_b p_bj g_b q_b over split y's q tiles.
template <bool kDk>
__global__ void __launch_bounds__(kThreads, 2)
    lse_bwd64_kernel(const float* __restrict__ stay, const float* __restrict__ stream,
                     const float* __restrict__ lse, const float* __restrict__ g,
                     float* __restrict__ part, int n_stay, int n_stream, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);     // staying tile
  float* ss = ys + kStayFloats;                     // two streamed stages
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg = lane & 7;
  float* slab = ss + 2 * kStageFloats + warp * kSlabFloats;  // this warp's p
  float* ls = ss + 2 * kStageFloats + 4 * kSlabFloats;      // dk: lse, 2 stages
  float* gs = ls + 2 * kCols;                               // dk: g, 2 stages
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int split = blockIdx.y;
  const int n_tiles = (n_stream + kCols - 1) / kCols;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);

  stage_rows<kRows>(ys, stay, row0, n_stay);
  stage_rows<kCols>(ss, stream, static_cast<long long>(t0) * kCols, n_stream);
  cp_async_commit();
  float lr[8];  // dq: lse of this thread's rows
  if (kDk) {
    if (tid < kCols) {
      // streamed rows past B weigh 0 (their logits are 0: q rows of zeros)
      const long long r = static_cast<long long>(t0) * kCols + tid;
      ls[tid] = r < n_stream ? __ldg(lse + r) : 0.f;
      gs[tid] = r < n_stream ? __ldg(g + r) : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = row0 + warp * 32 + rg + 4 * i;
      lr[i] = r < n_stay ? __ldg(lse + r) : 0.f;
    }
  }
  float4 acc[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);

  const float* ya = ys + (warp * 32 + rg) * kLd;  // + 4 i rows: this thread's rows
  for (int t = t0; t < t1; ++t) {
    const int cur = (t - t0) & 1;
    float next_l = 0.f, next_g = 0.f;
    if (t + 1 < t1) {  // stage cur ^ 1's readers (tile t - 1) passed the last barrier
      stage_rows<kCols>(ss + (cur ^ 1) * kStageFloats, stream,
                        static_cast<long long>(t + 1) * kCols, n_stream);
      if (kDk && tid < kCols) {
        const long long r = static_cast<long long>(t + 1) * kCols + tid;
        next_l = r < n_stream ? __ldg(lse + r) : 0.f;
        next_g = r < n_stream ? __ldg(g + r) : 0.f;
      }
    }
    cp_async_commit();  // possibly empty: the wait below then still leaves tile t landed
    cp_async_wait_all_but_one();
    __syncthreads();
    const float* ts = ss + cur * kStageFloats;

    // logits: s[i][j] = stay row (32 w + rg + 4 i) . streamed row (cg + 8 j)
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
    const float* tb = ts + cg * kLd;
#pragma unroll 2
    for (int e = 0; e < kE; e += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(ya + 4 * i * kLd + e);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(tb + 8 * j * kLd + e);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = s[i][j];
          v = fmaf(a[i].x, b.x, v);
          v = fmaf(a[i].y, b.y, v);
          v = fmaf(a[i].z, b.z, v);
          v = fmaf(a[i].w, b.w, v);
          s[i][j] = v;
        }
      }
    }
    // p into the warp's slab: row rg + 4 i, column cg + 8 j
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cg + 8 * j;
      if (kDk) {
        const float l = ls[cur * kCols + c], w = gs[cur * kCols + c];
#pragma unroll
        for (int i = 0; i < 8; ++i) slab[(rg + 4 * i) * kPLd + c] = __expf(s[i][j] - l) * w;
      } else {
        const bool valid = static_cast<long long>(t) * kCols + c < n_stream;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          slab[(rg + 4 * i) * kPLd + c] = valid ? __expf(s[i][j] - lr[i]) : 0.f;
        }
      }
    }
    __syncwarp();
    // acc[i][h] += sum_c p[row i][c] * streamed row c, columns 4 cg + 32 h .. + 3
    const float* pr = slab + rg * kPLd;
    const float* xb = ts + cg * 4;
#pragma unroll 2
    for (int c = 0; c < kCols; c += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = *reinterpret_cast<const float4*>(pr + 4 * i * kPLd + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 x0 = *reinterpret_cast<const float4*>(xb + (c + cc) * kLd);
        const float4 x1 = *reinterpret_cast<const float4*>(xb + (c + cc) * kLd + 32);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float w = comp(pv[i], cc);
          acc[i][0].x = fmaf(w, x0.x, acc[i][0].x);
          acc[i][0].y = fmaf(w, x0.y, acc[i][0].y);
          acc[i][0].z = fmaf(w, x0.z, acc[i][0].z);
          acc[i][0].w = fmaf(w, x0.w, acc[i][0].w);
          acc[i][1].x = fmaf(w, x1.x, acc[i][1].x);
          acc[i][1].y = fmaf(w, x1.y, acc[i][1].y);
          acc[i][1].z = fmaf(w, x1.z, acc[i][1].z);
          acc[i][1].w = fmaf(w, x1.w, acc[i][1].w);
        }
      }
    }
    if (kDk && t + 1 < t1 && tid < kCols) {  // stage cur ^ 1's lse and g: read from tile t + 1 on
      ls[(cur ^ 1) * kCols + tid] = next_l;
      gs[(cur ^ 1) * kCols + tid] = next_g;
    }
    __syncthreads();  // stage cur and the slabs are free again
  }
  float* out = part + static_cast<long long>(split) * n_stay * kE;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = row0 + warp * 32 + rg + 4 * i;
    if (r < n_stay) {
      *reinterpret_cast<float4*>(out + r * kE + cg * 4) = acc[i][0];
      *reinterpret_cast<float4*>(out + r * kE + 32 + cg * 4) = acc[i][1];
    }
  }
}

// out[idx] = sum over splits (in order) of part[split][idx].
__global__ void split_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 long long total, int splits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[i * total + idx];
  out[idx] = s;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// grid (q row tiles, splits): per q row, the (max, sum of exp(logit - max))
// pair over split y's k tiles, into part_m and part_s (splits, B).
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
    lse_fwd64_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     float* __restrict__ part_m, float* __restrict__ part_s, int b, int n,
                     int tiles_per_split) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);  // 128 q rows
  float* ss = ys + kStayFloats;                  // two k stages
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int split = blockIdx.y;
  const int n_tiles = (n + kCols - 1) / kCols;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);

  stage_rows<kRows>(ys, q, row0, b);
  stage_rows<kCols>(ss, k, static_cast<long long>(t0) * kCols, n);
  cp_async_commit();
  float m[8], l[8];  // this thread's running (max, sum) of rows 32 w + rg + 4 i
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
  }

  const float* ya = ys + (warp * 32 + rg) * kLd;
  for (int t = t0; t < t1; ++t) {
    const int cur = (t - t0) & 1;
    if (t + 1 < t1) {  // stage cur ^ 1's readers (tile t - 1) passed the last barrier
      stage_rows<kCols>(ss + (cur ^ 1) * kStageFloats, k, static_cast<long long>(t + 1) * kCols,
                        n);
    }
    cp_async_commit();  // possibly empty: the wait below then still leaves tile t landed
    cp_async_wait_all_but_one();
    __syncthreads();
    const float* ts = ss + cur * kStageFloats;

    // logits: s[i][j] = q row (32 w + rg + 4 i) . k row (64 t + cg + 8 j)
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
    const float* tb = ts + cg * kLd;
#pragma unroll 2
    for (int e = 0; e < kE; e += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(ya + 4 * i * kLd + e);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(tb + 8 * j * kLd + e);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = s[i][j];
          v = fmaf(a[i].x, bv.x, v);
          v = fmaf(a[i].y, bv.y, v);
          v = fmaf(a[i].z, bv.z, v);
          v = fmaf(a[i].w, bv.w, v);
          s[i][j] = v;
        }
      }
    }
    if (static_cast<long long>(t + 1) * kCols > n) {  // the catalog's last tile, partial
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (t * kCols + cg + 8 * j >= n) {
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i][j] = -INFINITY;
        }
      }
    }
    // the online rescale: one exp2 a row for the old sum, one a logit
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float tmax = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) tmax = fmaxf(tmax, s[i][j]);
      const float mn = fmaxf(m[i], tmax);
      const float neg = -mn * kLog2e;
      float acc = l[i] * ex2((m[i] - mn) * kLog2e);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += ex2(fmaf(s[i][j], kLog2e, neg));
      m[i] = mn;
      l[i] = acc;
    }
    __syncthreads();  // stage cur is free again
  }
  // the 8 threads of a row are lanes 8 rg .. 8 rg + 7 of one warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      merge(m[i], l[i], mo, lo);
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = row0 + warp * 32 + rg + 4 * i;
      if (r < b) {
        part_m[split * static_cast<long long>(b) + r] = m[i];
        part_s[split * static_cast<long long>(b) + r] = l[i];
      }
    }
  }
}

// lse_fwd64_kernel's shared memory allowed, with the SM's carveout at its
// most shared memory, so that kFwdBlocksPerSm blocks fit.
cudaError_t allow_fwd_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      lse_fwd64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lse_fwd64_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaError_t launch_fwd(const float* q, const float* k, float* part_m, float* part_s, int b, int n,
                       int splits, int tiles_per_split, cudaStream_t s) {
  cudaError_t err = allow_fwd_smem();
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kRows - 1) / kRows, splits);
  lse_fwd64_kernel<<<grid, kThreads, kFwdSmemBytes, s>>>(q, k, part_m, part_s, b, n,
                                                         tiles_per_split);
  return cudaGetLastError();
}

bool takes(const void* q, const void* k, int e) {
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(q) | reinterpret_cast<unsigned long long>(k);
  return e == kE && (bits & 15) == 0;
}

template <bool kDk>
cudaError_t launch(const float* stay, const float* stream, const float* lse, const float* g,
                   float* part, int n_stay, int n_stream, int splits, int tiles_per_split,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(lse_bwd64_kernel<kDk>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_stay + kRows - 1) / kRows, splits);
  lse_bwd64_kernel<kDk><<<grid, kThreads, kSmemBytes, s>>>(stay, stream, lse, g, part, n_stay,
                                                           n_stream, tiles_per_split);
  return cudaGetLastError();
}

}  // namespace e64

int smem_bytes(int e4, int buffers_of_rows, bool p_tile) {
  return (buffers_of_rows * kTile * row_stride(e4) + (p_tile ? kTile * kPLd : 0)) *
         static_cast<int>(sizeof(float));
}

// Allows `bytes` of dynamic shared memory where it is above the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool shape_ok(int b, int n, int e) { return b >= 1 && n >= 1 && e >= 1 && e <= kMaxE; }

// splits x tiles_per_split must cover the catalog's tiles, each split non-empty.
bool splits_ok(int n, int splits, int tiles_per_split) {
  const int n_tiles = (n + kTile - 1) / kTile;
  return splits >= 1 && splits <= 65535 && tiles_per_split >= 1 &&
         static_cast<long long>(splits) * tiles_per_split >= n_tiles &&
         static_cast<long long>(splits - 1) * tiles_per_split < n_tiles;
}

template <int NC>
cudaError_t launch_dq(const float* q, const float* k, const float* lse, float* part, int b, int n,
                      int e, int e4, int splits, int tiles_per_split, cudaStream_t stream) {
  const int bytes = smem_bytes(e4, 2, true);
  cudaError_t err = allow_smem(lse_dq_kernel<NC>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kTile - 1) / kTile, splits);
  lse_dq_kernel<NC><<<grid, kThreads, bytes, stream>>>(q, k, lse, part, b, n, e, e4,
                                                       tiles_per_split);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_dk(const float* q, const float* k, const float* lse, const float* g, float* dk,
                      int b, int n, int e, int e4, cudaStream_t stream) {
  const int bytes = smem_bytes(e4, 2, true);
  cudaError_t err = allow_smem(lse_dk_kernel<NC>, bytes);
  if (err != cudaSuccess) return err;
  lse_dk_kernel<NC><<<(n + kTile - 1) / kTile, kThreads, bytes, stream>>>(q, k, lse, g, dk, b, n,
                                                                          e, e4);
  return cudaGetLastError();
}

}  // namespace

// lse (b,) = logsumexp(q (b, e) . k (n, e)^T) per row. part_m and part_s:
// (splits, b) fp32 scratch; splits x tiles_per_split cover the catalog's
// 64-row tiles. At e 64 with q and k 16-byte aligned, lse_fwd64_kernel (128
// q rows a block), else the generic lse_fwd_kernel (64 q rows a block).
// Returns a cudaError_t: cudaErrorInvalidValue for a shape or split it does
// not take, else the launches'.
extern "C" int chaorec_lse_fwd(const float* q, const float* k, float* part_m, float* part_s,
                               float* lse, int b, int n, int e, int splits, int tiles_per_split,
                               void* stream) {
  if (!shape_ok(b, n, e) || !splits_ok(n, splits, tiles_per_split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (e64::takes(q, k, e)) {
    err = e64::launch_fwd(q, k, part_m, part_s, b, n, splits, tiles_per_split, s);
  } else {
    const int e4 = (e + 3) / 4 * 4;
    const int bytes = smem_bytes(e4, 2, false);
    err = allow_smem(lse_fwd_kernel, bytes);
    if (err == cudaSuccess) {
      const dim3 grid((b + kTile - 1) / kTile, splits);
      lse_fwd_kernel<<<grid, kThreads, bytes, s>>>(q, k, part_m, part_s, b, n, e, e4,
                                                   tiles_per_split);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_combine_kernel<<<(b + 255) / 256, 256, 0, s>>>(part_m, part_s, lse, b, splits);
  return static_cast<int>(cudaGetLastError());
}

// dq (b, e) = g[:, None] * softmax(q k^T - lse) k. part: (splits, b, e)
// fp32 scratch; splits x tiles_per_split cover the catalog's 64-row tiles.
// At e 64 with q and k 16-byte aligned, lse_bwd64_kernel (128 q rows a
// block), else the generic lse_dq_kernel (64 q rows a block).
extern "C" int chaorec_lse_dq(const float* q, const float* k, const float* lse, const float* g,
                              float* part, float* dq, int b, int n, int e, int splits,
                              int tiles_per_split, void* stream) {
  if (!shape_ok(b, n, e) || !splits_ok(n, splits, tiles_per_split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e4 = (e + 3) / 4 * 4;
  cudaError_t err;
  if (e64::takes(q, k, e)) {
    err = e64::launch<false>(q, k, lse, g, part, b, n, splits, tiles_per_split, s);
  } else {
    switch ((e4 + 63) / 64) {
      case 1: err = launch_dq<1>(q, k, lse, part, b, n, e, e4, splits, tiles_per_split, s); break;
      case 2: err = launch_dq<2>(q, k, lse, part, b, n, e, e4, splits, tiles_per_split, s); break;
      case 3: err = launch_dq<3>(q, k, lse, part, b, n, e, e4, splits, tiles_per_split, s); break;
      default: err = launch_dq<4>(q, k, lse, part, b, n, e, e4, splits, tiles_per_split, s); break;
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(b) * e;
  dq_combine_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(part, g, dq, b, e,
                                                                               splits);
  return static_cast<int>(cudaGetLastError());
}

// dk (n, e) = (softmax(q k^T - lse) * g[:, None])^T q. At e 64 with q and
// k 16-byte aligned, lse_bwd64_kernel (128 k rows a block) with B split:
// splits x tiles_per_split cover q's 64-row tiles, part is (splits, n, e)
// fp32 scratch when splits > 1 (one split writes dk directly, part unused).
// Else the generic lse_dk_kernel, which takes splits 1 only.
extern "C" int chaorec_lse_dk(const float* q, const float* k, const float* lse, const float* g,
                              float* part, float* dk, int b, int n, int e, int splits,
                              int tiles_per_split, void* stream) {
  if (!shape_ok(b, n, e) || !splits_ok(b, splits, tiles_per_split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e64::takes(q, k, e)) {
    cudaError_t err = e64::launch<true>(k, q, lse, g, splits == 1 ? dk : part, n, b, splits,
                                          tiles_per_split, s);
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const long long total = static_cast<long long>(n) * e;
    e64::split_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
        part, dk, total, splits);
    return static_cast<int>(cudaGetLastError());
  }
  if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int e4 = (e + 3) / 4 * 4;
  cudaError_t err;
  switch ((e4 + 63) / 64) {
    case 1: err = launch_dk<1>(q, k, lse, g, dk, b, n, e, e4, s); break;
    case 2: err = launch_dk<2>(q, k, lse, g, dk, b, n, e, e4, s); break;
    case 3: err = launch_dk<3>(q, k, lse, g, dk, b, n, e, e4, s); break;
    default: err = launch_dk<4>(q, k, lse, g, dk, b, n, e, e4, s); break;
  }
  return static_cast<int>(err);
}

// Blocks of lse_fwd64_kernel that one SM holds at once (after allowing its
// shared memory), into *blocks. Returns a cudaError_t.
extern "C" int chaorec_lse_fwd64_blocks_per_sm(int* blocks) {
  const cudaError_t err = e64::allow_fwd_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, e64::lse_fwd64_kernel, e64::kThreads, e64::kFwdSmemBytes));
}
