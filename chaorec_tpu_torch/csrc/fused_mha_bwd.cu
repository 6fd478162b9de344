// Fused small-head attention backward for Hopper (sm_90a), fp32, under the
// forward's dropout mask.
//
// Replaces the TPU kernel chaorec_tpu/ops/pallas_attn.py:_bwd_kernel
// (launched by _mha_bwd_raw). With s = q k^T / sqrt(DH), P = exp(s - lse)
// (lse, natural log, from csrc/fused_mha.cu), D the forward's mask (1 at
// keep_prob 1, else {0, 1/keep} from csrc/philox.cuh) and delta_i =
// dO_i . O_i, which still holds under dropout because O = (P * D) V:
//
//   dV_j   = sum_i P_ij D_ij dO_i
//   dS_ij  = P_ij (D_ij dO_i . v_j - delta_i)
//   dQ_i   = scale sum_j dS_ij k_j
//   dK_j   = scale sum_i dS_ij q_i
//
// The mask is a constant of the backward, as in torch and in the TPU
// kernel's VJP.
//
// What bounds it. Each score costs 4 FMAs to recompute s, 4 for dO . v,
// one exp2, 4 to accumulate dq and 8 more for dk and dv: about 10^10
// scores at CF_Diff's training batch against a few MB of rows, so, as the
// forward, it is bound by FP32 issue, not by HBM. Dropout adds one
// Philox4x32-10 call (about 40 integer instructions) per four scores.
//
// Design: two launches, no atomics, each output written by the one thread
// that owns its row, so the same bits every run.
// 1. mha_bwd_dq_kernel is shaped like the forward: R query rows a thread
//    and blocks by the forward's rule (attn_rows.cuh:pick_row_shape); the
//    group's K and V staged once, zero-padded to a kChunk-key chunk (tiles
//    beyond kMaxStaged keys), so only the last chunk masks its padded keys
//    with a -inf score; q pre-scaled by log2(e) / sqrt(DH) and lse taken to
//    log2 units once a row, so P is one ex2.approx.ftz; the Philox round
//    keys computed once a thread. Under dropout it draws each keep bit (the
//    only draw of the backward) and writes it, packed, to the scratch
//    `bits` (G, Lq, ceil(Lk / 32)) uint32: bit j % 32 of word j / 32 of row
//    i, bits past Lk zero. It also writes delta (G, Lq) from its rows of dO
//    and O. 1/keep is folded into the row's dO once.
// 2. mha_bwd_dkdv_kernel: a thread owns one quad of four neighbouring keys
//    (k, v and their dk, dv in registers), so the quad's four keep bits are
//    one 4-bit field of one word, read with a load that the warp's 32 lanes
//    share (32 quads = 4 words); no Philox. The block stages its group's
//    query rows once (q pre-scaled, dO / keep, -lse log2(e), -delta: 40 B
//    a row, 41 KB at Lq 1034, tiles beyond kMaxRows), padded to kAhead rows
//    with rows whose weight is 0, so the row loop tests no bound; the keep
//    words are loaded kAhead rows ahead. A group's warps of 32 quads are
//    spread evenly over blocks of up to kKeyWarps warps: at Lk 1034, 259
//    quads in 3 blocks of 3 warps, so 29 of 288 lanes (10%) idle, the least
//    a quad a thread allows.
// Neither kernel stores anything of size Lq x Lk but the bits (1/32 of a
// float each).
//
// The C entry point launches both on the caller's stream and returns the
// first cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "attn_rows.cuh"
#include "philox.cuh"

namespace {

constexpr int kDH = 4;            // d_head, one float4 per row
constexpr int kChunk = 16;        // dq: keys a chunk (four Philox calls, half a word)
constexpr int kMaxStaged = 4096;  // dq: keys of K and V staged at once (128 KB)
constexpr int kKeyWarps = 4;      // dk/dv: warps per block, at most
constexpr int kKeys = 4;          // dk/dv: keys a thread, a quad
constexpr int kMaxRows = 4096;    // dk/dv: query rows staged at once (160 KB)
constexpr int kAhead = 4;         // dk/dv: rows a step, and keep words loaded ahead
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2e = 1.44269504088896341f;

static_assert(kChunk == 16 && kMaxStaged % 32 == 0,
              "a chunk is four Philox calls and half a 32-bit keep word");
static_assert(kMaxRows % kAhead == 0, "row tiles hold whole steps");
static_assert(32 % kKeys == 0, "a thread's keep bits lie in one word");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a . b + c, in one chain of four FMAs
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float c) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, c))));
}

__device__ __forceinline__ void axpy4(float a, const float4& x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// The state of a dq thread's R rows.
template <int R>
struct DqRows {
  float4 q[R];     // q log2(e) / sqrt(DH)
  float4 dout[R];  // dO / keep
  float nl[R];     // -lse log2(e)
  float nd[R];     // -delta
  float4 acc[R];   // sum of dS k
  uint32_t i[R];   // row indices (clamped to Lq - 1 past the end)
  uint32_t lo[R];  // keep bits of the row's last even-numbered chunk
  uint32_t valid;  // bit r: row r lies before Lq
};

// One chunk of kChunk keys starting at staged key c0 (global key j0, a
// multiple of kChunk). With kMasked, keys from n_valid on (a staged index)
// score -inf and are not kept. Under dropout, an odd-numbered chunk writes
// its 16 keep bits and those of the chunk before as one word.
template <int R, bool kDropout, bool kMasked>
__device__ __forceinline__ void dq_chunk(DqRows<R>& st, const float4* __restrict__ ks,
                                         const float4* __restrict__ vs, int c0,
                                         uint32_t j0, int n_valid, uint32_t g,
                                         const chaorec::PhiloxKeys& keys,
                                         uint32_t thresh, uint32_t* __restrict__ bits_g,
                                         int nw) {
  uint32_t b16[R];
#pragma unroll
  for (int r = 0; r < R; ++r) b16[r] = 0;
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
      const bool in = !kMasked || c0 + c < n_valid;
      const float4 kk = ks[c0 + c];
      const float4 vv = vs[c0 + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = ex2(in ? dot4(st.q[r], kk, st.nl[r]) : -INFINITY);
        const float dd = dot4(st.dout[r], vv, st.nd[r]);  // D dO . v - delta if kept
        float ds = p * dd;
        if (kDropout) {
          const bool kept = in && word[r][u] < thresh;
          if (kept) b16[r] |= 1u << c;
          ds = p * (kept ? dd : st.nd[r]);
        }
        axpy4(ds, kk, st.acc[r]);
      }
    }
  }
  if (kDropout) {
    if ((j0 / kChunk) & 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((st.valid >> r) & 1) {
          bits_g[static_cast<size_t>(st.i[r]) * nw + j0 / 32] = st.lo[r] | (b16[r] << 16);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) st.lo[r] = b16[r];
    }
  }
}

template <int R, bool kDropout>
__global__ void __launch_bounds__(chaorec::kRowWarps * 32)
mha_bwd_dq_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
                  const float4* __restrict__ v, const float4* __restrict__ out,
                  const float4* __restrict__ dout, const float* __restrict__ lse,
                  float4* __restrict__ dq, float* __restrict__ delta,
                  uint32_t* __restrict__ bits, int lq, int lk, float qscale,
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
  DqRows<R> st;
  st.valid = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int want = row0 + r * 32 + lane;
    const int row = min(want, lq - 1);
    if (want < lq) st.valid |= 1u << r;
    st.i[r] = static_cast<uint32_t>(row);
    const long long at = g * lq + row;
    const float4 d = dout[at];
    const float dl = dot4(d, out[at], 0.f);
    if (want < lq) delta[at] = dl;
    st.q[r] = scale4(q[at], qscale);
    st.dout[r] = scale4(d, inv_keep);
    st.nl[r] = -lse[at] * kLog2e;
    st.nd[r] = -dl;
    st.acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    st.lo[r] = 0;
  }
  const chaorec::PhiloxKeys keys =
      chaorec::philox_keys(kDropout ? static_cast<uint64_t>(*seed) : 0);
  const int nw = (lk + 31) / 32;
  uint32_t* bits_g = kDropout ? bits + g * lq * nw : nullptr;
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
    const int full = n / kChunk * kChunk;
    for (int c0 = 0; c0 < full; c0 += kChunk) {
      dq_chunk<R, kDropout, false>(st, ks, vs, c0, t0 + c0, n, g, keys, thresh, bits_g, nw);
    }
    if (full < n) {
      dq_chunk<R, kDropout, true>(st, ks, vs, full, t0 + full, n, g, keys, thresh, bits_g, nw);
    }
  }

  if (!busy) return;
  if (kDropout && ((lk + kChunk - 1) / kChunk) % 2 == 1) {
    // an odd number of chunks: the last one's bits wait in lo
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((st.valid >> r) & 1) bits_g[static_cast<size_t>(st.i[r]) * nw + nw - 1] = st.lo[r];
    }
  }
  const float scale = 1.f / sqrtf(static_cast<float>(kDH));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if ((st.valid >> r) & 1) dq[g * lq + st.i[r]] = scale4(st.acc[r], scale);
  }
}

template <bool kDropout>
__global__ void __launch_bounds__(kKeyWarps * 32)
mha_bwd_dkdv_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
                    const float4* __restrict__ v, const float4* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const uint32_t* __restrict__ bits, float4* __restrict__ dk,
                    float4* __restrict__ dv, int lq, int lk, float qscale,
                    float inv_keep) {
  extern __shared__ float4 smem[];
  const int n_stage = (min(lq, kMaxRows) + kAhead - 1) / kAhead * kAhead;
  float4* qs = smem;                                      // q log2(e) / sqrt(DH)
  float4* dos = smem + n_stage;                           // dO / keep
  float2* ls = reinterpret_cast<float2*>(smem + 2 * n_stage);  // (-lse log2(e), -delta)

  const long long g = blockIdx.x;
  const int slot = blockIdx.y * blockDim.x + threadIdx.x;  // the thread's quad
  const int j_first = kKeys * slot;
  const bool busy = kKeys * (slot - threadIdx.x % 32) < lk;  // a warp wholly past Lk only stages
  // keys past Lk are zero and never stored
  float4 kr[kKeys], vr[kKeys], dka[kKeys], dva[kKeys];
#pragma unroll
  for (int c = 0; c < kKeys; ++c) {
    const bool in = j_first + c < lk;
    kr[c] = in ? k[g * lk + j_first + c] : make_float4(0.f, 0.f, 0.f, 0.f);
    vr[c] = in ? v[g * lk + j_first + c] : make_float4(0.f, 0.f, 0.f, 0.f);
    dka[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int nw = (lk + 31) / 32;
  uint32_t mask[kKeys];  // key j_first + c's bit in its keep word
#pragma unroll
  for (int c = 0; c < kKeys; ++c) mask[c] = 1u << (j_first % 32 + c);
  // the quad's column of keep words (a quad past Lk reads the last, in
  // bounds, and stores nothing), and the offset of row i in it (the C
  // entry checks that a group's words fit 32 bits)
  const uint32_t* bcol = kDropout ? bits + g * lq * nw + min(j_first / 32, nw - 1) : nullptr;
  auto at_row = [&](int i) {
    return static_cast<uint32_t>(min(i, lq - 1)) * static_cast<uint32_t>(nw);
  };

  for (int t0 = 0; t0 < lq; t0 += kMaxRows) {
    const int n = min(kMaxRows, lq - t0);
    const int n_rows = (n + kAhead - 1) / kAhead * kAhead;
    if (t0 > 0) __syncthreads();  // the previous tile is no longer read
    for (int x = threadIdx.x; x < n_rows; x += blockDim.x) {
      if (x < n) {
        const long long at = g * lq + t0 + x;
        qs[x] = scale4(q[at], qscale);
        dos[x] = scale4(dout[at], inv_keep);
        ls[x] = make_float2(-lse[at] * kLog2e, -delta[at]);
      } else {  // weight 2^-inf = 0: the row adds nothing
        qs[x] = make_float4(0.f, 0.f, 0.f, 0.f);
        dos[x] = make_float4(0.f, 0.f, 0.f, 0.f);
        ls[x] = make_float2(-INFINITY, 0.f);
      }
    }
    __syncthreads();
    if (!busy) continue;

    uint32_t next[kAhead];
    if (kDropout) {
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        next[a] = bcol[at_row(t0 + a)];
      }
    }
    for (int r0 = 0; r0 < n_rows; r0 += kAhead) {
      uint32_t word[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        if (kDropout) {  // the next step's words, loaded while this step computes
          word[a] = next[a];
          next[a] = bcol[at_row(t0 + r0 + kAhead + a)];
        }
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const float4 qq = qs[r0 + a];
        const float4 dd4 = dos[r0 + a];
        const float2 l = ls[r0 + a];
#pragma unroll
        for (int c = 0; c < kKeys; ++c) {
          const float p = ex2(dot4(qq, kr[c], l.x));
          const float dd = dot4(dd4, vr[c], l.y);  // D dO . v - delta if kept
          if (kDropout) {
            const bool kept = word[a] & mask[c];
            if (kept) axpy4(p, dd4, dva[c]);
            axpy4(p * (kept ? dd : l.y), qq, dka[c]);
          } else {
            axpy4(p, dd4, dva[c]);
            axpy4(p * dd, qq, dka[c]);
          }
        }
      }
    }
  }

  // dK = scale sum dS q = ln(2) sum dS (q log2(e) scale)
#pragma unroll
  for (int c = 0; c < kKeys; ++c) {
    if (j_first + c < lk) {
      dk[g * lk + j_first + c] = scale4(dka[c], kLn2);
      dv[g * lk + j_first + c] = dva[c];
    }
  }
}

// Dynamic shared memory above 48 KB needs the kernel's consent first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int R, bool kDropout>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* out, const float* dout, const float* lse,
                      float* dq, float* delta, uint32_t* bits, long long g, int lq,
                      int lk, const chaorec::RowShape& shape, const long long* seed,
                      uint32_t thresh, float inv_keep, cudaStream_t stream) {
  const int n_pad = (std::min(lk, kMaxStaged) + kChunk - 1) / kChunk * kChunk;
  const size_t smem = 2 * sizeof(float4) * static_cast<size_t>(n_pad);
  auto kernel = mha_bwd_dq_kernel<R, kDropout>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(g), static_cast<unsigned>(shape.blocks_per_group));
  kernel<<<grid, shape.warps * 32, smem, stream>>>(
      reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(k),
      reinterpret_cast<const float4*>(v), reinterpret_cast<const float4*>(out),
      reinterpret_cast<const float4*>(dout), lse, reinterpret_cast<float4*>(dq), delta,
      bits, lq, lk, kLog2e / sqrtf(static_cast<float>(kDH)), seed, thresh, inv_keep);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t launch_dkdv(const float* q, const float* k, const float* v,
                        const float* dout, const float* lse, const float* delta,
                        const uint32_t* bits, float* dk, float* dv, long long g,
                        int lq, int lk, int warps, int blocks, float inv_keep,
                        cudaStream_t stream) {
  const int n_stage = (std::min(lq, kMaxRows) + kAhead - 1) / kAhead * kAhead;
  const size_t smem = (2 * sizeof(float4) + sizeof(float2)) * static_cast<size_t>(n_stage);
  auto kernel = mha_bwd_dkdv_kernel<kDropout>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(g), static_cast<unsigned>(blocks));
  kernel<<<grid, warps * 32, smem, stream>>>(
      reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(k),
      reinterpret_cast<const float4*>(v), reinterpret_cast<const float4*>(dout), lse,
      delta, bits, reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv), lq, lk,
      kLog2e / sqrtf(static_cast<float>(kDH)), inv_keep);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t launch(const float* q, const float* k, const float* v, const float* out,
                   const float* dout, const float* lse, float* dq, float* dk, float* dv,
                   float* delta, uint32_t* bits, long long g, int lq, int lk,
                   const chaorec::RowShape& shape, int kv_warps, int kv_blocks,
                   const long long* seed, uint32_t thresh, float inv_keep,
                   cudaStream_t s) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (shape.rows_per_thread) {
    case 1:
      err = launch_dq<1, kDropout>(q, k, v, out, dout, lse, dq, delta, bits, g, lq, lk,
                                   shape, seed, thresh, inv_keep, s);
      break;
    case 3:
      err = launch_dq<3, kDropout>(q, k, v, out, dout, lse, dq, delta, bits, g, lq, lk,
                                   shape, seed, thresh, inv_keep, s);
      break;
  }
  if (err != cudaSuccess) return err;
  return launch_dkdv<kDropout>(q, k, v, dout, lse, delta, bits, dk, dv, g, lq, lk,
                               kv_warps, kv_blocks, inv_keep, s);
}

}  // namespace

// q, out, dout, dq: (g, lq, dh); k, v, dk, dv: (g, lk, dh); lse and the
// scratch delta: (g, lq). Contiguous fp32, 16-byte aligned. dropout, seed,
// thresh and inv_keep are the forward's (csrc/fused_mha.cu). With dropout,
// bits is the scratch (g, lq, ceil(lk / 32)) uint32 of the keep bits (the
// dq kernel writes it, the dk/dv kernel reads it); else it may be null.
// Returns a cudaError_t: cudaErrorInvalidValue for a d_head this file was
// not built for, an empty shape, a missing seed or scratch or a grid out
// of range, else the first launch error.
extern "C" int chaorec_mha_bwd_f32(const float* q, const float* k,
                                   const float* v, const float* out,
                                   const float* dout, const float* lse,
                                   float* dq, float* dk, float* dv,
                                   float* delta, unsigned* bits, long long g,
                                   int lq, int lk, int dh, int dropout,
                                   const long long* seed, unsigned thresh,
                                   float inv_keep, void* stream) {
  if (g < 1 || g > 0x7fffffffLL || lq < 1 || lk < 1 || dh != kDH ||
      1LL * lq * ((lk + 31) / 32) > 0xffffffffLL ||
      (dropout && (seed == nullptr || bits == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const chaorec::RowShape shape = chaorec::pick_row_shape(g, lq);
  // dk/dv: the group's quads in warps of 32, spread evenly over blocks of
  // up to kKeyWarps warps
  const int kv_per_group = ((lk + kKeys - 1) / kKeys + 31) / 32;
  const int kv_blocks = (kv_per_group + kKeyWarps - 1) / kKeyWarps;
  const int kv_warps = (kv_per_group + kv_blocks - 1) / kv_blocks;
  if (shape.blocks_per_group > 65535 || kv_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dropout ? launch<true>(q, k, v, out, dout, lse, dq, dk, dv, delta, bits, g, lq, lk,
                             shape, kv_warps, kv_blocks, seed, thresh, inv_keep, s)
              : launch<false>(q, k, v, out, dout, lse, dq, dk, dv, delta, nullptr, g, lq,
                              lk, shape, kv_warps, kv_blocks, seed, thresh, inv_keep, s));
}
