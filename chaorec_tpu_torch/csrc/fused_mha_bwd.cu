// Fused small-head attention backward for Hopper (sm_90a), fp32, with the
// forward's dropout mask drawn again in-kernel.
//
// Replaces the TPU kernel chaorec_tpu/ops/pallas_attn.py:_bwd_kernel
// (launched by _mha_bwd_raw). With s = q k^T / sqrt(DH), P = exp(s - lse)
// (lse from csrc/fused_mha.cu), D the forward's mask (1 at keep_prob 1,
// else {0, 1/keep} from csrc/philox.cuh) and delta_i = dO_i . O_i, which
// still holds under dropout because O = (P * D) V:
//
//   dV_j   = sum_i P_ij D_ij dO_i
//   dS_ij  = P_ij (D_ij dO_i . v_j - delta_i)
//   dQ_i   = scale sum_j dS_ij k_j
//   dK_j   = scale sum_i dS_ij q_i
//
// The mask is a constant of the backward, as in torch and in the TPU
// kernel's VJP.
//
// Design: two launches and no atomics.
// 1. mha_bwd_dq_kernel, shaped like the forward: one query row per thread,
//    keys streamed through shared memory in tiles. It also writes delta
//    (G, Lq), which it computes from its own row of dO and O.
// 2. mha_bwd_dkdv_kernel: one quad of four neighbouring keys per thread,
//    so one Philox call gives the four bits a query row needs; query rows
//    (scaled q, dO, lse, delta) are streamed through shared memory.
// The TPU kernel accumulates dK and dV across sequential q-blocks in a
// VMEM-resident output block; blocks of a CUDA grid run in no order, so
// here each dK/dV row is owned by one thread instead. What bounds both
// kernels is the same as the forward's: FP32 issue, one exp per score,
// and one Philox call per four scores under dropout. No tensor cores at
// d_head 4; nothing of size Lq x Lk is stored.
//
// The C entry point launches both on the caller's stream and returns the
// first cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreadsQ = 128;  // dq kernel: query rows per block
constexpr int kTileK = 512;     // dq kernel: keys staged per pass
constexpr int kChunk = 16;      // dq kernel: keys per mask draw batch
constexpr int kThreadsKV = 64;  // dk/dv kernel: key quads per block
constexpr int kTileQ = 256;     // dk/dv kernel: query rows staged per pass

static_assert(kChunk % 4 == 0 && kTileK % kChunk == 0,
              "chunks start on a multiple of 4 keys (one Philox call each)");

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

__device__ __forceinline__ void axpy4(float a, const float4& x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

template <int DH, bool kDropout>
__global__ void __launch_bounds__(kThreadsQ)
mha_bwd_dq_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
                  const float4* __restrict__ v, const float4* __restrict__ out,
                  const float4* __restrict__ dout,
                  const float* __restrict__ lse, float4* __restrict__ dq,
                  float* __restrict__ delta, int lq, int lk, float scale,
                  const long long* __restrict__ seed, uint32_t thresh,
                  float inv_keep) {
  constexpr int V4 = DH / 4;
  __shared__ float4 ks[kTileK * V4];
  __shared__ float4 vs[kTileK * V4];

  const long long g = blockIdx.x;
  const int row = blockIdx.y * kThreadsQ + threadIdx.x;
  const bool active = row < lq;
  const int qi = active ? row : 0;  // rows past Lq compute on row 0
  const long long r0 = (g * lq + qi) * V4;
  float4 qr[V4], dor[V4], acc[V4];
  float dl = 0.f;
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    qr[c] = q[r0 + c];
    qr[c].x *= scale; qr[c].y *= scale; qr[c].z *= scale; qr[c].w *= scale;
    dor[c] = dout[r0 + c];
    dl += dot4(dor[c], out[r0 + c]);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float li = lse[g * lq + qi];
  if (active) delta[g * lq + row] = dl;
  const float4* kg = k + g * lk * V4;
  const float4* vg = v + g * lk * V4;
  const uint64_t key = kDropout ? static_cast<uint64_t>(*seed) : 0;

  for (int t0 = 0; t0 < lk; t0 += kTileK) {
    const int n = min(kTileK, lk - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * V4; i += kThreadsQ) {
      ks[i] = kg[t0 * V4 + i];
      vs[i] = vg[t0 * V4 + i];
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kChunk) {
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
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        if (j < n) {
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int e = 0; e < V4; ++e) {
            s += dot4(qr[e], ks[j * V4 + e]);
            dp += dot4(dor[e], vs[j * V4 + e]);
          }
          const float p = expf(s - li);
          if (kDropout) dp = ((bits >> c) & 1u) ? dp * inv_keep : 0.f;
          const float ds = p * (dp - dl);
#pragma unroll
          for (int e = 0; e < V4; ++e) axpy4(ds, ks[j * V4 + e], acc[e]);
        }
      }
    }
  }

  if (active) {
    float4* drow = dq + (g * lq + row) * V4;
#pragma unroll
    for (int e = 0; e < V4; ++e) {
      drow[e] = make_float4(acc[e].x * scale, acc[e].y * scale,
                            acc[e].z * scale, acc[e].w * scale);
    }
  }
}

template <int DH, bool kDropout>
__global__ void __launch_bounds__(kThreadsKV)
mha_bwd_dkdv_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
                    const float4* __restrict__ v,
                    const float4* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float4* __restrict__ dk,
                    float4* __restrict__ dv, int lq, int lk, float scale,
                    const long long* __restrict__ seed, uint32_t thresh,
                    float inv_keep) {
  constexpr int V4 = DH / 4;
  __shared__ float4 qs[kTileQ * V4];  // q * scale
  __shared__ float4 dos[kTileQ * V4];
  __shared__ float ls[kTileQ];
  __shared__ float ds_[kTileQ];

  const long long g = blockIdx.x;
  const int quad = blockIdx.y * kThreadsKV + threadIdx.x;
  const int j_first = 4 * quad;
  // Keys past Lk are zero and never stored; their quad still stages rows.
  float4 kr[4][V4], vr[4][V4], dka[4][V4], dva[4][V4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j_first + c;
#pragma unroll
    for (int e = 0; e < V4; ++e) {
      const bool in = j < lk;
      kr[c][e] = in ? k[(g * lk + j) * V4 + e] : make_float4(0.f, 0.f, 0.f, 0.f);
      vr[c][e] = in ? v[(g * lk + j) * V4 + e] : make_float4(0.f, 0.f, 0.f, 0.f);
      dka[c][e] = make_float4(0.f, 0.f, 0.f, 0.f);
      dva[c][e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const float4* qg = q + g * lq * V4;
  const float4* dog = dout + g * lq * V4;
  const uint64_t key = kDropout ? static_cast<uint64_t>(*seed) : 0;

  for (int t0 = 0; t0 < lq; t0 += kTileQ) {
    const int n = min(kTileQ, lq - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * V4; i += kThreadsKV) {
      float4 t = qg[t0 * V4 + i];
      t.x *= scale; t.y *= scale; t.z *= scale; t.w *= scale;
      qs[i] = t;
      dos[i] = dog[t0 * V4 + i];
    }
    for (int i = threadIdx.x; i < n; i += kThreadsKV) {
      ls[i] = lse[g * lq + t0 + i];
      ds_[i] = delta[g * lq + t0 + i];
    }
    __syncthreads();

    for (int r = 0; r < n; ++r) {
      const unsigned bits =
          kDropout ? chaorec::keep_bits4(static_cast<uint32_t>(quad),
                                         static_cast<uint32_t>(t0 + r),
                                         static_cast<uint32_t>(g), key, thresh)
                   : 0xFu;
      const float li = ls[r], dl = ds_[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < V4; ++e) {
          s += dot4(qs[r * V4 + e], kr[c][e]);
          dp += dot4(dos[r * V4 + e], vr[c][e]);
        }
        const float p = expf(s - li);
        float pd = p;
        if (kDropout) {
          const bool kept = (bits >> c) & 1u;
          pd = kept ? p * inv_keep : 0.f;
          dp = kept ? dp * inv_keep : 0.f;
        }
        const float dsc = p * (dp - dl);
#pragma unroll
        for (int e = 0; e < V4; ++e) {
          axpy4(pd, dos[r * V4 + e], dva[c][e]);
          axpy4(dsc, qs[r * V4 + e], dka[c][e]);  // q is pre-scaled
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j_first + c;
    if (j < lk) {
#pragma unroll
      for (int e = 0; e < V4; ++e) {
        dk[(g * lk + j) * V4 + e] = dka[c][e];
        dv[(g * lk + j) * V4 + e] = dva[c][e];
      }
    }
  }
}

template <int DH, bool kDropout>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* out, const float* dout, const float* lse,
                   float* dq, float* dk, float* dv, float* delta, long long g,
                   int lq, int lk, const long long* seed, uint32_t thresh,
                   float inv_keep, cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(DH));
  const dim3 grid_q(static_cast<unsigned>(g), (lq + kThreadsQ - 1) / kThreadsQ);
  mha_bwd_dq_kernel<DH, kDropout><<<grid_q, kThreadsQ, 0, stream>>>(
      reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(k),
      reinterpret_cast<const float4*>(v), reinterpret_cast<const float4*>(out),
      reinterpret_cast<const float4*>(dout), lse, reinterpret_cast<float4*>(dq),
      delta, lq, lk, scale, seed, thresh, inv_keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int quads = (lk + 3) / 4;
  const dim3 grid_kv(static_cast<unsigned>(g), (quads + kThreadsKV - 1) / kThreadsKV);
  mha_bwd_dkdv_kernel<DH, kDropout><<<grid_kv, kThreadsKV, 0, stream>>>(
      reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(k),
      reinterpret_cast<const float4*>(v), reinterpret_cast<const float4*>(dout),
      lse, delta, reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv),
      lq, lk, scale, seed, thresh, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: (g, lq, dh); k, v, dk, dv: (g, lk, dh); lse and the
// scratch delta: (g, lq). Contiguous fp32, 16-byte aligned. dropout, seed,
// thresh and inv_keep are the forward's (csrc/fused_mha.cu). Returns a
// cudaError_t: cudaErrorInvalidValue for a d_head this file was not built
// for, an empty shape or a missing seed, else the first launch error.
extern "C" int chaorec_mha_bwd_f32(const float* q, const float* k,
                                   const float* v, const float* out,
                                   const float* dout, const float* lse,
                                   float* dq, float* dk, float* dv,
                                   float* delta, long long g, int lq, int lk,
                                   int dh, int dropout, const long long* seed,
                                   unsigned thresh, float inv_keep,
                                   void* stream) {
  if (g < 1 || g > 0x7fffffffLL || lq < 1 || lk < 1 ||
      (lq + kThreadsQ - 1) / kThreadsQ > 65535 ||
      ((lk + 3) / 4 + kThreadsKV - 1) / kThreadsKV > 65535 ||
      (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 4:
      return static_cast<int>(
          dropout ? launch<4, true>(q, k, v, out, dout, lse, dq, dk, dv, delta,
                                    g, lq, lk, seed, thresh, inv_keep, s)
                  : launch<4, false>(q, k, v, out, dout, lse, dq, dk, dv,
                                     delta, g, lq, lk, seed, thresh, inv_keep,
                                     s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
