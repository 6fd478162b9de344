// Fused small-head attention forward for Hopper (sm_90a), fp32, with
// in-kernel attention-weight dropout.
//
// Replaces the TPU kernel chaorec_tpu/ops/pallas_attn.py:_fwd_kernel
// (launched by _mha_fwd_raw):
//
//   p[g, i, j]   = softmax_j(q[g, i] . k[g, j] / sqrt(DH))
//   out[g, i, :] = sum_j p[g, i, j] * D[g, i, j] * v[g, j, :]
//
// over all Lk keys, no key mask, for every group g = batch * heads + head.
// D is 1 at keep_prob 1; below it, D is 1/keep with probability keep and 0
// otherwise, drawn here from csrc/philox.cuh as a function of (seed, g, i,
// j), so the (G, Lq, Lk) mask never reaches memory and the backward
// (csrc/fused_mha_bwd.cu) draws the same bits. When asked, the kernel also
// writes each row's natural-log log-sum-exp of the scaled scores, lse
// (G, Lq), which the backward uses in place of a second softmax pass. Lq
// and Lk are arbitrary and independent.
//
// What bounds it. CF_Diff's CAM_AE runs this at d_head 4 over 1034 tokens.
// Each score costs 4 FMAs for q.k, one exp and 4 FMAs to accumulate v:
// q, k, v and out are a few MB per launch against ~10^10 scores, so the
// kernel is bound by instruction issue (FP32 and the SFU's exp), not by
// HBM. Tensor cores do not help at d_head 4: TF32 rounds q and k to 10
// bits, outside the 1e-5 tolerance. Dropout adds one Philox4x32-10 call
// (20 integer multiplies) per four scores.
//
// Design, to spend as few instructions per score as possible:
// - Rows. A thread owns R query rows (a template parameter, 1 or 3), so
//   each broadcast shared-memory load of k_j or v_j serves R rows and the
//   R rows' chains hide each other's latency. A warp owns 32 R consecutive
//   rows; a group's ceil(Lq / 32R) warps are split evenly over its blocks
//   of up to kWarps warps, and a warp whose rows all lie past Lq skips the
//   compute, so at most 32 R - 1 rows are computed in vain. The host picks
//   R from the grid (attn_rows.cuh:pick_row_shape, which the backward's dq
//   kernel shares): 3 where that wastes at most 5% of the rows and still
//   gives each SM enough warps (CF_Diff's training and export batches: 1056
//   rows for 1034), else 1 (its serving batch of one user, 4 groups).
// - Keys. The block stages its group's whole K and V in shared memory once
//   (Lk x 32 B: 33 KB at Lk 1034; dynamic shared memory above 48 KB), the
//   tail zero-padded to a chunk of kChunk keys, so the inner loop tests no
//   key bound: only the last chunk masks its padded keys with a -inf score.
//   Above kMaxStaged keys the block walks K and V in tiles of that size.
// - exp2. q is scaled by log2(e) / sqrt(DH) once, scores are in log2
//   units, and each weight is one ex2.approx.ftz.f32.
// - Lazy rescaling. The running max m starts at the score of key 0 and
//   enters each score's FMA chain as its initial value, so a score costs
//   no subtraction. A chunk rescales the row (m, l and out's accumulator)
//   only when one of its scores exceeds m by more than kTau (2^8): weights
//   stay below 2^8, and l >= 1 from the weight of the key that set m.
// - Dropout. The softmax is normalised before it is dropped, so l counts
//   every weight while the accumulator takes the kept ones, unscaled;
//   1/keep multiplies out once at the end. The ten Philox round keys are
//   computed once per thread (philox4x32_10_keyed); the keep bits are those
//   of keep_bits4, counter (j / 4, i, g, 0).
// - No atomics: every output is written by the thread that owns its row,
//   the same bits every run.
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "attn_rows.cuh"
#include "philox.cuh"

namespace {

constexpr int kDH = 4;          // d_head, one float4 per row
constexpr int kChunk = 16;      // keys scored between two rescale checks
constexpr int kMaxStaged = 4096;  // keys of K and V staged at once (128 KB)
constexpr int kWarps = chaorec::kRowWarps;  // warps per block, at most
constexpr float kTau = 8.f;     // log2 growth of the max a chunk may leave
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2e = 1.44269504088896341f;

static_assert(kChunk % 4 == 0 && kMaxStaged % kChunk == 0,
              "chunks start on a multiple of 4 keys (one Philox call each)");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// q . k + c, in one chain of four FMAs
__device__ __forceinline__ float dot4(const float4& q, const float4& k, float c) {
  return fmaf(q.x, k.x, fmaf(q.y, k.y, fmaf(q.z, k.z, fmaf(q.w, k.w, c))));
}

__device__ __forceinline__ void axpy4(float a, const float4& x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// The running state of a thread's R rows.
template <int R>
struct Rows {
  float4 q[R];    // scaled into log2 units
  float m[R];     // running max of the scores, log2 units
  float l[R];     // sum of 2^(s - m) over the keys so far, kept or not
  float4 acc[R];  // sum of the kept 2^(s - m) v
  uint32_t i[R];  // row indices (clamped to Lq - 1 past the end)
};

// One chunk of kChunk keys starting at staged key c0 (global key j0). With
// kMasked, keys from n_valid on (a staged index) score -inf.
template <int R, bool kDropout, bool kMasked>
__device__ __forceinline__ void chunk(Rows<R>& st, const float4* __restrict__ ks,
                                      const float4* __restrict__ vs, int c0,
                                      uint32_t j0, int n_valid, uint32_t g,
                                      const chaorec::PhiloxKeys& keys,
                                      uint32_t thresh) {
  float t[R][kChunk];
  float mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const float4 kk = ks[c0 + c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = dot4(st.q[r], kk, -st.m[r]);
      if (kMasked && c0 + c >= n_valid) s = -INFINITY;
      t[r][c] = s;
      mx[r] = fmaxf(mx[r], s);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (mx[r] > kTau) {  // rare: the row's max grew by more than 2^kTau
      const float corr = ex2(-mx[r]);
      st.m[r] += mx[r];
      st.l[r] *= corr;
      st.acc[r].x *= corr; st.acc[r].y *= corr;
      st.acc[r].z *= corr; st.acc[r].w *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) t[r][c] -= mx[r];
    }
  }
#pragma unroll
  for (int w = 0; w < kChunk / 4; ++w) {
    uint32_t word[R][4];
    if (kDropout) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const chaorec::Philox4 x =
            chaorec::philox4x32_10_keyed(j0 / 4 + w, st.i[r], g, 0u, keys);
        word[r][0] = x.x; word[r][1] = x.y; word[r][2] = x.z; word[r][3] = x.w;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 4 * w + u;
      const float4 vv = vs[c0 + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = ex2(t[r][c]);
        st.l[r] += p;
        axpy4(kDropout ? (word[r][u] < thresh ? p : 0.f) : p, vv, st.acc[r]);
      }
    }
  }
}

template <int R, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
mha_fwd_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
               const float4* __restrict__ v, float4* __restrict__ out,
               float* __restrict__ lse, int lq, int lk, float qscale,
               const long long* __restrict__ seed, uint32_t thresh,
               float inv_keep) {
  extern __shared__ float4 smem[];
  const int n_stage = min(lk, kMaxStaged);
  const int n_pad = (n_stage + kChunk - 1) / kChunk * kChunk;
  float4* ks = smem;
  float4* vs = smem + n_pad;

  const long long g = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (blockIdx.y * (blockDim.x / 32) + warp) * 32 * R;
  const bool busy = row0 < lq;  // a warp wholly past Lq only stages
  Rows<R> st;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(row0 + r * 32 + lane, lq - 1);
    st.i[r] = static_cast<uint32_t>(row);
    float4 x = q[g * lq + row];
    x.x *= qscale; x.y *= qscale; x.z *= qscale; x.w *= qscale;
    st.q[r] = x;
    st.l[r] = 0.f;
    st.acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const chaorec::PhiloxKeys keys =
      chaorec::philox_keys(kDropout ? static_cast<uint64_t>(*seed) : 0);
  const float4* kg = k + g * lk;
  const float4* vg = v + g * lk;

  for (int t0 = 0; t0 < lk; t0 += kMaxStaged) {
    const int n = min(kMaxStaged, lk - t0);
    if (t0 > 0) __syncthreads();  // the previous tile is no longer read
    for (int x = threadIdx.x; x < n_pad; x += blockDim.x) {
      const bool in = x < n;
      ks[x] = in ? kg[t0 + x] : make_float4(0.f, 0.f, 0.f, 0.f);
      vs[x] = in ? vg[t0 + x] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (!busy) continue;
    if (t0 == 0) {
      // m starts at the score of key 0; its weight, 1, keeps l >= 1
#pragma unroll
      for (int r = 0; r < R; ++r) st.m[r] = dot4(st.q[r], ks[0], 0.f);
    }
    const int full = n / kChunk * kChunk;
    for (int c0 = 0; c0 < full; c0 += kChunk) {
      chunk<R, kDropout, false>(st, ks, vs, c0, t0 + c0, n, g, keys, thresh);
    }
    if (full < n) {
      chunk<R, kDropout, true>(st, ks, vs, full, t0 + full, n, g, keys, thresh);
    }
  }

  if (!busy) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * 32 + lane;
    if (row < lq) {
      const float s = inv_keep / st.l[r];
      out[g * lq + row] = make_float4(st.acc[r].x * s, st.acc[r].y * s,
                                      st.acc[r].z * s, st.acc[r].w * s);
      if (lse != nullptr) lse[g * lq + row] = (st.m[r] + log2f(st.l[r])) * kLn2;
    }
  }
}

template <int R, bool kDropout>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* lse, long long g, int lq, int lk,
                   const chaorec::RowShape& shape, const long long* seed,
                   uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const int n_pad = (std::min(lk, kMaxStaged) + kChunk - 1) / kChunk * kChunk;
  const size_t smem = 2 * sizeof(float4) * static_cast<size_t>(n_pad);
  auto kernel = mha_fwd_kernel<R, kDropout>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(g), static_cast<unsigned>(shape.blocks_per_group));
  kernel<<<grid, shape.warps * 32, smem, stream>>>(
      reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(k),
      reinterpret_cast<const float4*>(v), reinterpret_cast<float4*>(out), lse,
      lq, lk, kLog2e / sqrtf(static_cast<float>(kDH)), seed, thresh, inv_keep);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t dispatch(const float* q, const float* k, const float* v, float* out,
                     float* lse, long long g, int lq, int lk,
                     const chaorec::RowShape& shape, const long long* seed,
                     uint32_t thresh, float inv_keep, cudaStream_t s) {
  switch (shape.rows_per_thread) {
    case 1: return launch<1, kDropout>(q, k, v, out, lse, g, lq, lk, shape, seed, thresh, inv_keep, s);
    case 3: return launch<3, kDropout>(q, k, v, out, lse, g, lq, lk, shape, seed, thresh, inv_keep, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (g, lq, dh), k and v: (g, lk, dh), out: (g, lq, dh); contiguous fp32,
// 16-byte aligned. lse: (g, lq) fp32, or null to skip it. With dropout != 0,
// seed points to one int64 on the device (read by the kernel, so drawing it
// needs no host sync), a weight is kept when its Philox word is below
// thresh, and kept weights are scaled by inv_keep. Returns a cudaError_t:
// cudaErrorInvalidValue for a d_head this file was not built for, an empty
// shape, a missing seed or a grid out of range, else the launch's.
extern "C" int chaorec_mha_fwd_f32(const float* q, const float* k,
                                   const float* v, float* out, float* lse,
                                   long long g, int lq, int lk, int dh,
                                   int dropout, const long long* seed,
                                   unsigned thresh, float inv_keep,
                                   void* stream) {
  if (g < 1 || g > 0x7fffffffLL || lq < 1 || lk < 1 || dh != kDH ||
      (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const chaorec::RowShape shape = chaorec::pick_row_shape(g, lq);
  if (shape.blocks_per_group > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dropout ? dispatch<true>(q, k, v, out, lse, g, lq, lk, shape, seed, thresh,
                               inv_keep, s)
              : dispatch<false>(q, k, v, out, lse, g, lq, lk, shape, seed, thresh,
                                inv_keep, s));
}
