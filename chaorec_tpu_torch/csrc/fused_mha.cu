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
// writes each row's log-sum-exp of the scaled scores, lse (G, Lq), which
// the backward uses in place of a second softmax pass. Lq and Lk are
// arbitrary and independent.
//
// What bounds it. CF_Diff's CAM_AE runs this at d_head 4 over 1034 tokens.
// Each score costs 4 FMAs for q.k, one exp and 4 FMAs to accumulate v:
// tensor cores have nothing to do at that width, and q, k, v and out are
// a few MB per launch against ~10^10 scores, so the kernel is bound by
// FP32 issue and by exp throughput (the SFU), not by HBM. Dropout adds one
// Philox4x32-10 call (20 integer multiplies) per four scores.
//
// Design. Grid (G, ceil(Lq / 128)), 128 threads, one query row per thread.
// The block walks the keys of its group in tiles of kTileK, staged in
// shared memory as float4 rows; every thread of a warp reads the same key
// row, so the loads are broadcasts. An online softmax (running max m,
// running sum l, a DH-wide accumulator) is rescaled once per chunk of
// kChunk keys, not once per key, so the extra exps cost 1/kChunk of the
// main ones. The dropout mask multiplies only what is accumulated into
// out, never l: the softmax is normalised before it is dropped. Nothing of
// size Lq x Lk is ever stored. The TPU kernel's blocking (256-row q tiles,
// the whole K/V in VMEM, q zero-padded to a tile multiple, one PRNG seed
// per q tile) is not carried over: ragged rows are masked here.
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 128;  // query rows per block, one per thread
constexpr int kTileK = 512;    // keys staged in shared memory per pass
constexpr int kChunk = 16;     // keys scored between two softmax rescales

static_assert(kChunk % 4 == 0 && kTileK % kChunk == 0,
              "chunks start on a multiple of 4 keys (one Philox call each)");

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

template <int DH, bool kDropout>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
               const float4* __restrict__ v, float4* __restrict__ out,
               float* __restrict__ lse, int lq, int lk, float scale,
               const long long* __restrict__ seed, uint32_t thresh,
               float inv_keep) {
  static_assert(DH % 4 == 0, "rows are read as float4");
  constexpr int V4 = DH / 4;
  __shared__ float4 ks[kTileK * V4];
  __shared__ float4 vs[kTileK * V4];

  const long long g = blockIdx.x;
  const int row = blockIdx.y * kThreads + threadIdx.x;
  const bool active = row < lq;
  // Rows past Lq compute on row 0 and store nothing; they still take part
  // in staging the key tiles.
  const int qi = active ? row : 0;
  const float4* qrow = q + (g * lq + qi) * V4;
  float4 qr[V4];
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    qr[c] = qrow[c];
    qr[c].x *= scale; qr[c].y *= scale; qr[c].z *= scale; qr[c].w *= scale;
  }
  const float4* kg = k + g * lk * V4;
  const float4* vg = v + g * lk * V4;
  const uint64_t key = kDropout ? static_cast<uint64_t>(*seed) : 0;

  float m = -INFINITY;
  float l = 0.f;
  float4 acc[V4];
#pragma unroll
  for (int c = 0; c < V4; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t0 = 0; t0 < lk; t0 += kTileK) {
    const int n = min(kTileK, lk - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < n * V4; i += kThreads) {
      ks[i] = kg[t0 * V4 + i];
      vs[i] = vg[t0 * V4 + i];
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        float d = -INFINITY;
        if (j < n) {
          d = 0.f;
#pragma unroll
          for (int e = 0; e < V4; ++e) d += dot4(qr[e], ks[j * V4 + e]);
        }
        s[c] = d;
        cmax = fmaxf(cmax, d);
      }
      // Keep bits of the chunk's keys: bit c is key t0 + j0 + c.
      unsigned bits = 0xFFFFu;
      if (kDropout) {
        bits = 0;
        const uint32_t j4 = static_cast<uint32_t>((t0 + j0) / 4);
#pragma unroll
        for (int w = 0; w < kChunk / 4; ++w) {
          bits |= chaorec::keep_bits4(j4 + w, qi, static_cast<uint32_t>(g),
                                      key, thresh) << (4 * w);
        }
      }
      // j0 < n, so cmax and m_new are finite; exp(-inf) = 0 on the first
      // chunk clears the empty accumulator.
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int e = 0; e < V4; ++e) {
        acc[e].x *= corr; acc[e].y *= corr; acc[e].z *= corr; acc[e].w *= corr;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        if (j < n) {
          const float p = expf(s[c] - m_new);
          l += p;
          const float pd = kDropout ? (((bits >> c) & 1u) ? p * inv_keep : 0.f) : p;
#pragma unroll
          for (int e = 0; e < V4; ++e) {
            const float4 vv = vs[j * V4 + e];
            acc[e].x = fmaf(pd, vv.x, acc[e].x);
            acc[e].y = fmaf(pd, vv.y, acc[e].y);
            acc[e].z = fmaf(pd, vv.z, acc[e].z);
            acc[e].w = fmaf(pd, vv.w, acc[e].w);
          }
        }
      }
      m = m_new;
    }
  }

  if (active) {
    const float inv = 1.f / l;
    float4* orow = out + (g * lq + row) * V4;
#pragma unroll
    for (int e = 0; e < V4; ++e) {
      orow[e] = make_float4(acc[e].x * inv, acc[e].y * inv, acc[e].z * inv,
                            acc[e].w * inv);
    }
    if (lse != nullptr) lse[g * lq + row] = m + logf(l);
  }
}

template <int DH, bool kDropout>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* lse, long long g, int lq, int lk,
                   const long long* seed, uint32_t thresh, float inv_keep,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(g), (lq + kThreads - 1) / kThreads);
  mha_fwd_kernel<DH, kDropout><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(k),
      reinterpret_cast<const float4*>(v), reinterpret_cast<float4*>(out), lse,
      lq, lk, 1.f / sqrtf(static_cast<float>(DH)), seed, thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// q: (g, lq, dh), k and v: (g, lk, dh), out: (g, lq, dh); contiguous fp32,
// 16-byte aligned. lse: (g, lq) fp32, or null to skip it. With dropout != 0,
// seed points to one int64 on the device (read by the kernel, so drawing it
// needs no host sync), a weight is kept when its Philox word is below
// thresh, and kept weights are scaled by inv_keep. Returns a cudaError_t:
// cudaErrorInvalidValue for a d_head this file was not built for, an empty
// shape or a missing seed, else the launch's.
extern "C" int chaorec_mha_fwd_f32(const float* q, const float* k,
                                   const float* v, float* out, float* lse,
                                   long long g, int lq, int lk, int dh,
                                   int dropout, const long long* seed,
                                   unsigned thresh, float inv_keep,
                                   void* stream) {
  if (g < 1 || g > 0x7fffffffLL || lq < 1 || lk < 1 ||
      (lq + kThreads - 1) / kThreads > 65535 || (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 4:
      return static_cast<int>(
          dropout ? launch<4, true>(q, k, v, out, lse, g, lq, lk, seed, thresh,
                                    inv_keep, s)
                  : launch<4, false>(q, k, v, out, lse, g, lq, lk, seed,
                                     thresh, inv_keep, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
