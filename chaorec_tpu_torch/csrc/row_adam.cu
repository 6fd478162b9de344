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
// Design. Each block owns a tile of consecutive rows and sweeps it as one
// flat range of 16-byte vectors (4 fp32 or 8 bf16), consecutive threads on
// consecutive addresses, in groups of 4 fp32 vectors a thread (1 bf16
// vector: see group_size): a thread issues the p, m and v loads of its
// group before their math, so a group pays about one memory latency, not
// one a vector, in at most 85 registers (3 blocks an SM or more). Before
// the sweep, the block finds its batch rows:
// - two warps find the tile's first and last batch slots by a 64-way
//   search of the sorted row list, one warp each (two rounds of loads at
//   B 2048; a serial binary search takes 11), the TPU kernel's per-step
//   search done wide. (The sweep's first loads go out after it: issued
//   before it, they measured slower at t_feat.)
// - the block writes each batch row's slot into a small shared-memory map
//   of the tile, so the sweep reads a row's slot from shared memory;
// - a batch row's gradient is read as 16-byte vectors too.
// The tile height comes from the wrapper (ops/row_adam.py:tile_rows): the
// whole rows of about 16 KB of each of p, m and v; where that grid would
// take fewer than 4 waves of the blocks the card holds at once
// (chaorec_row_adam_blocks_per_sm), the height that fills the nearest
// whole number of waves. So a narrow table fills the card (bf16 t_feat,
// D 384: 525 blocks of 29 rows in one wave of 528) and a wide one takes a
// row or two a block. A table whose row length or base addresses do not
// allow 16-byte vectors takes the same kernel with one element a vector.
// None of the TPU's constraints remain: no 8-row groups, no per-row DMA,
// no D % 128, any D.
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 512;  // size of the shared row -> slot map

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

// First index j in [0, n) with rows[j] >= target, else n, by one warp: each
// round every lane tests two of 64 evenly spaced samples of the range left.
__device__ int warp_lower_bound(const int* __restrict__ rows, int n, long long target) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 63) / 64;
    int below = 0;  // samples lo + i step (i < 64, below hi) under the target: a prefix of them
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = lo + (2 * lane + u) * step;
      const bool under = idx < hi && static_cast<long long>(__ldg(rows + idx)) < target;
      below += __popc(__ballot_sync(0xffffffffu, under));
    }
    if (below == 0) return lo;
    const int last = lo + (below - 1) * step;  // the last sample under the target
    hi = min(hi, last + step);
    lo = last + 1;
  }
  return lo;
}

// Vectors a thread loads before their math: 4 fp32 vectors (or 4 elements
// in the scalar form), but one bf16 vector. bf16 stores half the bytes for
// the same math (three IEEE divisions and a square root an element), so
// its sweep needs warps more than bytes in flight: two bf16 vectors a
// thread took 80 registers or spilled under a cap, and measured 1.1-2x
// slower.
template <int VEC>
constexpr int group_size() {
  return VEC == 8 ? 1 : 4;
}

// The p, m and v vectors of one thread's group.
template <typename T, int VEC>
struct Group {
  static constexpr int kSize = group_size<VEC>();
  Vec<T, VEC> p[kSize], m[kSize], v[kSize];
};

// Loads vectors first + threadIdx.x + u kThreads (u < the group's size,
// below n_vecs) of the tile that starts at element base.
template <typename T, int VEC>
__device__ __forceinline__ void load_group(Group<T, VEC>& grp, const T* p, const T* m,
                                           const T* v, long long base, int first, int n_vecs) {
#pragma unroll
  for (int u = 0; u < Group<T, VEC>::kSize; ++u) {
    const int e = first + threadIdx.x + u * kThreads;
    if (e < n_vecs) {
      const long long off = base + static_cast<long long>(e) * VEC;
      grp.p[u] = *reinterpret_cast<const Vec<T, VEC>*>(p + off);
      grp.m[u] = *reinterpret_cast<const Vec<T, VEC>*>(m + off);
      grp.v[u] = *reinterpret_cast<const Vec<T, VEC>*>(v + off);
    }
  }
}

// T: stored type; VEC: elements per vector (16 bytes, or 1 for the scalar
// form). d is a multiple of VEC. At most 85 registers, so that at least 3
// blocks (768 threads) share an SM.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
    row_adam_kernel(T* __restrict__ p, T* __restrict__ m, T* __restrict__ v,
                    const int* __restrict__ rows, const float* __restrict__ g,
                    const int* __restrict__ count, long long n, int d, int b,
                    int tile_rows, AdamArgs a) {
  constexpr int kSize = Group<T, VEC>::kSize;
  __shared__ int slot_of[kMaxTileRows];
  __shared__ int range[2];

  const long long row0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows_here = static_cast<int>(min(static_cast<long long>(tile_rows), n - row0));
  const int vecs_per_row = d / VEC;
  const int n_vecs = rows_here * vecs_per_row;
  const long long base = row0 * d;  // the tile's rows are contiguous

  for (int r = threadIdx.x; r < rows_here; r += kThreads) slot_of[r] = -1;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int at = warp_lower_bound(rows, b, row0 + (warp ? rows_here : 0));
    if ((threadIdx.x & 31) == 0) range[warp] = at;
  }
  const float c = static_cast<float>(__ldg(count));
  const float bc1 = 1.f - powf(a.b1, c);
  const float bc2 = 1.f - powf(a.b2, c);
  __syncthreads();
  for (int j = range[0] + threadIdx.x; j < range[1]; j += kThreads) {
    slot_of[__ldg(rows + j) - row0] = j;
  }
  __syncthreads();

  Group<T, VEC> grp;
  load_group(grp, p, m, v, base, 0, n_vecs);
  for (int first = 0;;) {
#pragma unroll
    for (int u = 0; u < kSize; ++u) {
      const int e = first + threadIdx.x + u * kThreads;
      if (e >= n_vecs) continue;
      const int r = e / vecs_per_row;
      const int slot = slot_of[r];
      float gv[VEC];
      if (slot >= 0) {
        const float* gr = g + static_cast<long long>(slot) * d + (e - r * vecs_per_row) * VEC;
        if constexpr (VEC % 4 == 0) {
#pragma unroll
          for (int i = 0; i < VEC; i += 4) {
            const float4 g4 = __ldg(reinterpret_cast<const float4*>(gr + i));
            gv[i] = g4.x;
            gv[i + 1] = g4.y;
            gv[i + 2] = g4.z;
            gv[i + 3] = g4.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) gv[i] = __ldg(gr + i);
        }
      }
      Vec<T, VEC>& pp = grp.p[u];
      Vec<T, VEC>& mp = grp.m[u];
      Vec<T, VEC>& vp = grp.v[u];
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
      const long long off = base + static_cast<long long>(e) * VEC;
      *reinterpret_cast<Vec<T, VEC>*>(p + off) = pp;
      *reinterpret_cast<Vec<T, VEC>*>(m + off) = mp;
      *reinterpret_cast<Vec<T, VEC>*>(v + off) = vp;
    }
    first += kSize * kThreads;
    if (first >= n_vecs) break;
    load_group(grp, p, m, v, base, first, n_vecs);
  }
}

// One launch of the kernel, on the instance dispatch picks.
struct Launch {
  void *p, *m, *v;
  const int* rows;
  const float* g;
  const int* count;
  long long n;
  int d, b, tile_rows;
  AdamArgs a;
  cudaStream_t stream;

  template <typename T, int VEC>
  cudaError_t run() const {
    const long long blocks = (n + tile_rows - 1) / tile_rows;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    row_adam_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<T*>(p), static_cast<T*>(m), static_cast<T*>(v), rows, g, count, n, d, b,
        tile_rows, a);
    return cudaGetLastError();
  }
};

// The blocks of the instance dispatch picks that one SM holds at once.
struct Occupancy {
  int* blocks;

  template <typename T, int VEC>
  cudaError_t run() const {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, row_adam_kernel<T, VEC>,
                                                         kThreads, 0);
  }
};

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// f.run<T, VEC>() for the tables' instance: 16-byte vectors where d and
// every base address allow them, else one element a vector.
template <typename F>
cudaError_t dispatch(const void* p, const void* m, const void* v, const float* g, int d,
                     int bf16, const F& f) {
  const bool vec = aligned16(p) && aligned16(m) && aligned16(v) && aligned16(g);
  if (bf16) {
    return vec && d % 8 == 0 ? f.template run<__nv_bfloat16, 8>()
                             : f.template run<__nv_bfloat16, 1>();
  }
  return vec && d % 4 == 0 ? f.template run<float, 4>() : f.template run<float, 1>();
}

}  // namespace

// p, m, v: (n, d) contiguous, all fp32 (bf16 == 0) or all bf16 (bf16 != 0).
// rows: (b,) int32 ascending, no duplicates, entries >= n are padding.
// g: (b, d) fp32 contiguous, the summed gradient of each row. count: one
// int32 on the device, the step count after this update (>= 1). tile_rows:
// rows a block, 1 .. 512, with at most 2^31 - 1 vectors in a tile. Updates
// p, m and v in place. Returns a cudaError_t: cudaErrorInvalidValue for an
// empty or oversized shape or tile, else the launch's.
extern "C" int chaorec_row_adam(void* p, void* m, void* v, const int* rows,
                                const float* g, const int* count, long long n,
                                int d, int b, int bf16, int tile_rows, float lr, float b1,
                                float b2, float one_minus_b1,
                                float one_minus_b2, float eps, void* stream) {
  if (n < 1 || d < 1 || b < 1 || n > 0x7fffffffLL || tile_rows < 1 ||
      tile_rows > kMaxTileRows || static_cast<long long>(tile_rows) * d > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch launch{p, m, v, rows, g, count, n, d, b, tile_rows,
                      AdamArgs{lr, b1, b2, one_minus_b1, one_minus_b2, eps},
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(p, m, v, g, d, bf16, launch));
}

// Blocks of the instance chaorec_row_adam runs for these tables (same
// arguments) that one SM holds at once, into *blocks. Returns a cudaError_t.
extern "C" int chaorec_row_adam_blocks_per_sm(const void* p, const void* m, const void* v,
                                              const float* g, int d, int bf16, int* blocks) {
  return static_cast<int>(dispatch(p, m, v, g, d, bf16, Occupancy{blocks}));
}
