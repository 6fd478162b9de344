// Fused small-head attention forward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel chaorec_tpu/ops/pallas_attn.py:_fwd_kernel
// (launched by _mha_fwd_raw) at keep_prob == 1.0:
//
//   out[g, i, :] = sum_j softmax_j(q[g, i] . k[g, j] / sqrt(DH)) * v[g, j, :]
//
// over all Lk keys, no key mask, for every group g = batch * heads + head.
// Lq and Lk are arbitrary and independent.
//
// What bounds it. CF_Diff's CAM_AE runs this at d_head 4 over 1034 tokens.
// Each score costs 4 FMAs for q.k, one exp and 4 FMAs to accumulate v:
// tensor cores have nothing to do at that width, and q, k, v and out are
// a few MB per launch against ~10^10 scores, so the kernel is bound by
// FP32 issue and by exp throughput (the SFU), not by HBM.
//
// Design. Grid (G, ceil(Lq / 128)), 128 threads, one query row per thread.
// The block walks the keys of its group in tiles of kTileK, staged in
// shared memory as float4 rows; every thread of a warp reads the same key
// row, so the loads are broadcasts. An online softmax (running max m,
// running sum l, a DH-wide accumulator) is rescaled once per chunk of
// kChunk keys, not once per key, so the extra exps cost 1/kChunk of the
// main ones. Nothing of size Lq x Lk is ever stored. The TPU kernel's
// blocking (256-row q tiles, the whole K/V in VMEM, q zero-padded to a
// tile multiple) is not carried over: ragged rows are masked here.
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // query rows per block, one per thread
constexpr int kTileK = 512;    // keys staged in shared memory per pass
constexpr int kChunk = 16;     // keys scored between two softmax rescales

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
               const float4* __restrict__ v, float4* __restrict__ out,
               int lq, int lk, float scale) {
  static_assert(DH % 4 == 0, "rows are read as float4");
  constexpr int V4 = DH / 4;
  __shared__ float4 ks[kTileK * V4];
  __shared__ float4 vs[kTileK * V4];

  const long long g = blockIdx.x;
  const int row = blockIdx.y * kThreads + threadIdx.x;
  const bool active = row < lq;
  // Rows past Lq compute on row 0 and store nothing; they still take part
  // in staging the key tiles.
  const float4* qrow = q + (g * lq + (active ? row : 0)) * V4;
  float4 qr[V4];
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    qr[c] = qrow[c];
    qr[c].x *= scale; qr[c].y *= scale; qr[c].z *= scale; qr[c].w *= scale;
  }
  const float4* kg = k + g * lk * V4;
  const float4* vg = v + g * lk * V4;

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
#pragma unroll
          for (int e = 0; e < V4; ++e) {
            const float4 vv = vs[j * V4 + e];
            acc[e].x = fmaf(p, vv.x, acc[e].x);
            acc[e].y = fmaf(p, vv.y, acc[e].y);
            acc[e].z = fmaf(p, vv.z, acc[e].z);
            acc[e].w = fmaf(p, vv.w, acc[e].w);
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
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   long long g, int lq, int lk, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(g), (lq + kThreads - 1) / kThreads);
  mha_fwd_kernel<DH><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(k),
      reinterpret_cast<const float4*>(v), reinterpret_cast<float4*>(out), lq,
      lk, 1.f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

}  // namespace

// q: (g, lq, dh), k and v: (g, lk, dh), out: (g, lq, dh); contiguous fp32,
// 16-byte aligned. Returns a cudaError_t: cudaErrorInvalidValue for a
// d_head this file was not built for or an empty shape, else the launch's.
extern "C" int chaorec_mha_fwd_f32(const float* q, const float* k,
                                   const float* v, float* out, long long g,
                                   int lq, int lk, int dh, void* stream) {
  if (g < 1 || g > 0x7fffffffLL || lq < 1 || lk < 1 ||
      (lq + kThreads - 1) / kThreads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 4:
      return static_cast<int>(launch<4>(q, k, v, out, g, lq, lk, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
