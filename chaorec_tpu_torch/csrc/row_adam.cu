// Row-sparse Adam for Hopper (sm_90a): one exact Adam step, in place, on an
// (N, D) table whose gradient is nonzero on a few rows only.
//
// Replaces the TPU kernel chaorec_tpu/ops/pallas_row_adam.py:_kernel
// (launched by fused_row_adam). For every element of p, m and v:
//
//   m = b1 m + [row in batch] (1 - b1) g
//   v = b2 v + [row in batch] (1 - b2) g^2
//   p = p - lr (m / bc1) / (sqrt(v / bc2) + eps)
//
// with bc1 = 1 - b1^count and bc2 = 1 - b2^count, count read from the
// device (the step count after this update), so a training loop needs no
// host sync per step. The B batch rows arrive sorted ascending and
// deduplicated, with their summed gradients g (B, D) in fp32; padding
// entries carry a sentinel row id >= N and are never visited. p, m and v
// are stored in fp32 or bf16; the math is fp32 either way, and only the
// stored values round.
//
// What bounds it. Every element of p, m and v is read and written once
// (6 N D stored elements) plus B gradient rows read: 1.5 GB for FREEDOM's
// fp32 v_feat (15207, 4096), 0.46 ms at 3.35 TB/s, against ~10 flops per
// element. It is bound by device memory bandwidth; nothing here is worth a
// tensor core or shared-memory staging.
//
// Design. Each block owns a tile of consecutive rows. Two of its threads
// binary-search the sorted row list for the tile's first and last batch
// slots (the TPU kernel does the same per grid step), then the block writes
// each batch row's slot into a small shared-memory map of the tile, so the
// sweep reads a row's slot from shared memory instead of searching. The
// sweep walks the tile's elements as one flat range of 16-byte vectors
// (4 fp32 or 8 bf16), consecutive threads on consecutive addresses, so
// narrow tables (t_feat, D = 384) keep every thread busy too. The tile
// height is chosen so a block sweeps ~2048 vectors. A table whose row
// length or base addresses do not allow 16-byte vectors takes the same
// kernel with one element per thread. None of the TPU's constraints
// remain: no 8-row groups, no per-row DMA, no D % 128, any D.
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileVectors = 2048;  // vectors one block sweeps, about
constexpr int kMaxTileRows = 512;   // size of the shared row -> slot map

// VEC stored values, aligned so that a copy is one vector load or store
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Vec {
  T x[VEC];
};

struct AdamArgs {
  float lr, b1, b2, one_minus_b1, one_minus_b2, eps;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// First index j in [0, n) with rows[j] >= target, else n.
__device__ int lower_bound(const int* __restrict__ rows, int n, long long target) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(__ldg(rows + mid)) < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// T: stored type; VEC: elements per vector (16 bytes, or 1 for the scalar
// form). d is a multiple of VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    row_adam_kernel(T* __restrict__ p, T* __restrict__ m, T* __restrict__ v,
                    const int* __restrict__ rows, const float* __restrict__ g,
                    const int* __restrict__ count, long long n, int d, int b,
                    int tile_rows, AdamArgs a) {
  __shared__ int slot_of[kMaxTileRows];
  __shared__ int range[2];

  const long long row0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows_here = static_cast<int>(min(static_cast<long long>(tile_rows), n - row0));
  for (int r = threadIdx.x; r < rows_here; r += kThreads) slot_of[r] = -1;
  if (threadIdx.x < 2) {
    range[threadIdx.x] = lower_bound(rows, b, row0 + (threadIdx.x ? rows_here : 0));
  }
  __syncthreads();
  for (int j = range[0] + threadIdx.x; j < range[1]; j += kThreads) {
    slot_of[__ldg(rows + j) - row0] = j;
  }
  __syncthreads();

  const float c = static_cast<float>(__ldg(count));
  const float bc1 = 1.f - powf(a.b1, c);
  const float bc2 = 1.f - powf(a.b2, c);

  const int vecs_per_row = d / VEC;
  const int n_vecs = rows_here * vecs_per_row;
  const long long base = row0 * d;
  for (int e = threadIdx.x; e < n_vecs; e += kThreads) {
    const int r = e / vecs_per_row;
    const int col = (e - r * vecs_per_row) * VEC;
    const long long off = base + static_cast<long long>(r) * d + col;
    const int slot = slot_of[r];

    // one 16-byte load each (or one value each in the scalar form)
    Vec<T, VEC> pp = *reinterpret_cast<const Vec<T, VEC>*>(p + off);
    Vec<T, VEC> mp = *reinterpret_cast<const Vec<T, VEC>*>(m + off);
    Vec<T, VEC> vp = *reinterpret_cast<const Vec<T, VEC>*>(v + off);
    float gv[VEC];
    if (slot >= 0) {
      const float* gr = g + static_cast<long long>(slot) * d + col;
#pragma unroll
      for (int i = 0; i < VEC; ++i) gv[i] = __ldg(gr + i);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float mi = a.b1 * to_float(mp.x[i]);
      float vi = a.b2 * to_float(vp.x[i]);
      if (slot >= 0) {
        mi += a.one_minus_b1 * gv[i];
        vi += a.one_minus_b2 * (gv[i] * gv[i]);
      }
      const float pi = to_float(pp.x[i]) - a.lr * (mi / bc1) / (sqrtf(vi / bc2) + a.eps);
      store(&pp.x[i], pi);
      store(&mp.x[i], mi);
      store(&vp.x[i], vi);
    }
    *reinterpret_cast<Vec<T, VEC>*>(p + off) = pp;
    *reinterpret_cast<Vec<T, VEC>*>(m + off) = mp;
    *reinterpret_cast<Vec<T, VEC>*>(v + off) = vp;
  }
}

template <typename T, int VEC>
cudaError_t launch(void* p, void* m, void* v, const int* rows, const float* g,
                   const int* count, long long n, int d, int b, AdamArgs a,
                   cudaStream_t stream) {
  const int vecs_per_row = d / VEC;
  int tile_rows = kTileVectors / vecs_per_row;
  tile_rows = tile_rows < 1 ? 1 : (tile_rows > kMaxTileRows ? kMaxTileRows : tile_rows);
  const long long blocks = (n + tile_rows - 1) / tile_rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  row_adam_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<T*>(m), static_cast<T*>(v), rows, g, count,
      n, d, b, tile_rows, a);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// p, m, v: (n, d) contiguous, all fp32 (bf16 == 0) or all bf16 (bf16 != 0).
// rows: (b,) int32 ascending, no duplicates, entries >= n are padding.
// g: (b, d) fp32 contiguous, the summed gradient of each row. count: one
// int32 on the device, the step count after this update (>= 1). Updates p,
// m and v in place. Returns a cudaError_t: cudaErrorInvalidValue for an
// empty or oversized shape, else the launch's.
extern "C" int chaorec_row_adam(void* p, void* m, void* v, const int* rows,
                                const float* g, const int* count, long long n,
                                int d, int b, int bf16, float lr, float b1,
                                float b2, float one_minus_b1,
                                float one_minus_b2, float eps, void* stream) {
  if (n < 1 || d < 1 || b < 1 || n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AdamArgs a{lr, b1, b2, one_minus_b1, one_minus_b2, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(p) && aligned16(m) && aligned16(v) && aligned16(g);
  if (bf16) {
    if (vec && d % 8 == 0) {
      return static_cast<int>(launch<__nv_bfloat16, 8>(p, m, v, rows, g, count, n, d, b, a, s));
    }
    return static_cast<int>(launch<__nv_bfloat16, 1>(p, m, v, rows, g, count, n, d, b, a, s));
  }
  if (vec && d % 4 == 0) {
    return static_cast<int>(launch<float, 4>(p, m, v, rows, g, count, n, d, b, a, s));
  }
  return static_cast<int>(launch<float, 1>(p, m, v, rows, g, count, n, d, b, a, s));
}
