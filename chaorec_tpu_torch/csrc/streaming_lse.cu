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
// Design. A block of 256 threads computes a 64 x 64 tile of logits at a
// time from a 64-row q tile and a 64-row k tile staged in shared memory,
// each thread a 4 x 4 register tile (rows ty + 16 i, columns tx + 16 j),
// with 16-byte shared loads that hit 32 distinct banks (the row stride is
// padded to 4 mod 32 floats). Every ragged edge (B, N, E) is masked here:
// out-of-range rows load as zeros, and no padded copy of q or k exists.
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
// (splits, b) fp32 scratch. Returns a cudaError_t: cudaErrorInvalidValue
// for a shape or split it does not take, else the launches'.
extern "C" int chaorec_lse_fwd(const float* q, const float* k, float* part_m, float* part_s,
                               float* lse, int b, int n, int e, int splits, int tiles_per_split,
                               void* stream) {
  if (!shape_ok(b, n, e) || !splits_ok(n, splits, tiles_per_split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e4 = (e + 3) / 4 * 4;
  const int bytes = smem_bytes(e4, 2, false);
  cudaError_t err = allow_smem(lse_fwd_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((b + kTile - 1) / kTile, splits);
  lse_fwd_kernel<<<grid, kThreads, bytes, s>>>(q, k, part_m, part_s, b, n, e, e4, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lse_combine_kernel<<<(b + 255) / 256, 256, 0, s>>>(part_m, part_s, lse, b, splits);
  return static_cast<int>(cudaGetLastError());
}

// dq (b, e) = g[:, None] * softmax(q k^T - lse) k. part: (splits, b, e)
// fp32 scratch.
extern "C" int chaorec_lse_dq(const float* q, const float* k, const float* lse, const float* g,
                              float* part, float* dq, int b, int n, int e, int splits,
                              int tiles_per_split, void* stream) {
  if (!shape_ok(b, n, e) || !splits_ok(n, splits, tiles_per_split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e4 = (e + 3) / 4 * 4;
  cudaError_t err;
  switch ((e4 + 63) / 64) {
    case 1: err = launch_dq<1>(q, k, lse, part, b, n, e, e4, splits, tiles_per_split, s); break;
    case 2: err = launch_dq<2>(q, k, lse, part, b, n, e, e4, splits, tiles_per_split, s); break;
    case 3: err = launch_dq<3>(q, k, lse, part, b, n, e, e4, splits, tiles_per_split, s); break;
    default: err = launch_dq<4>(q, k, lse, part, b, n, e, e4, splits, tiles_per_split, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(b) * e;
  dq_combine_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(part, g, dq, b, e,
                                                                               splits);
  return static_cast<int>(cudaGetLastError());
}

// dk (n, e) = (softmax(q k^T - lse) * g[:, None])^T q.
extern "C" int chaorec_lse_dk(const float* q, const float* k, const float* lse, const float* g,
                              float* dk, int b, int n, int e, void* stream) {
  if (!shape_ok(b, n, e)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
