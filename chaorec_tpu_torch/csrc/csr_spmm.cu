// Weighted gather-sum over the rows of a CSR graph, for Hopper (sm_90a):
//
//   out[r, :] = sum over the edges e of row r, in the row's stored order,
//               of w[e] * x[src[e], :]
//
// fp32 out, fp32 or bf16 x, fp32 w. Each product is rounded to fp32
// (__fmul_rn) and added to a running fp32 total that starts at 0.0f
// (__fadd_rn), one edge after another: no FMA contraction, no reordering.
// An empty row gives 0.
//
// Replaces no TPU kernel: the JAX package's segment and ELL gather-sums
// (chaorec_tpu/graphs/norm_adj.py, chaorec_tpu/ops/ell.py) are XLA's. It
// replaces the port's gather plus deterministic index_add_ in the segment
// graph (graphs/norm_adj.py, forward and the gather's backward). On the card
// that scatter radix-sorts the destinations, then walks each destination's
// messages one after another, reading and writing the destination row in
// device memory once per message: thousands of dependent round trips for a
// popular item. It took 68-80% of a training step at the microlens catalog.
// The CSRs (ops/csr_spmm.build_csr) store each row's edges in the order that
// scatter adds them (a stable sort of the destinations over the message
// positions), so this kernel gives its bits.
//
// What bounds it. Bytes: every edge reads one row of x (D elements) and its
// source id and weight, every row writes D floats once. At microlens
// (417,949 edges; 46420 users, 14079 items; D = 64) that is 107 MB of
// gathered rows at fp32 (53 MB at bf16) plus 3.3 MB of ids and weights, and
// 3.6-11.9 MB out: 34 us at 3.35 TB/s (18 us at bf16). The tables (3.6 and
// 11.9 MB at fp32) sit in the 50 MB L2, so most gathered rows come from L2.
// And the order: a row's sum is one chain of dependent adds, one per edge.
// The hottest item's 5.8 k (microlens) or 16 k (electronics) edges take at
// least 4 cycles an edge, 12-33 us, however the rest is spread.
//
// Design. A task is one row and a tile of 32 * V columns, owned by one
// warp, V adjacent columns a lane (V = 2 at an even D and an x aligned to
// two elements: one 8-byte load of fp32, 4 bytes of bf16, a lane; else 1),
// so a D = 64 row is one task. Each lane keeps V independent chains, one a
// column, each in the row's order.
// The edges go in chunks of kChunk: lane j holds edge j's source id and
// weight, and broadcasts them by shuffle. The loop is software-pipelined two
// chunks deep: a chunk's row loads are issued, and the chunk after next's
// ids loaded, before the adds of the chunk before it, so one chunk's loads
// are always in flight behind the in-order adds. Tasks are laid out in a
// row order fixed at build, longest row first (the CSR is stored in that
// order), so the hot items start at once and the short rows fill the card
// around their chains; a hot row is never split over warps along its edges
// (that would change the order), only along its columns. Each output element
// is written once: no memset, no atomics, no scratch. Any D >= 1 and any row
// count; element offsets are 64-bit.
//
// Measured on an H100 (chip_smoke.py phase 80): the user side (rows of
// 5-13 edges) comes within 1.5-2x of its byte bound; the item side takes
// its hot rows' time, one warp walking a hot item's edges at 60-70 ns an
// edge, so that is where this kernel has room left (more of a hot row's
// loads in flight than two chunks' registers hold).
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;             // warps of a block, a task each
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;            // edges of a chunk; two chunks' loads in flight
constexpr unsigned kFull = 0xffffffffu;

// V adjacent elements of T, loaded at once, and widened to fp32.
template <typename T, int V>
struct Lanes;
template <>
struct Lanes<float, 1> {
  using type = float;
  __device__ static void widen(type v, float* f) { f[0] = v; }
};
template <>
struct Lanes<float, 2> {
  using type = float2;
  __device__ static void widen(type v, float* f) { f[0] = v.x; f[1] = v.y; }
};
template <>
struct Lanes<__nv_bfloat16, 1> {
  using type = __nv_bfloat16;
  __device__ static void widen(type v, float* f) { f[0] = __bfloat162float(v); }
};
template <>
struct Lanes<__nv_bfloat16, 2> {
  using type = __nv_bfloat162;
  __device__ static void widen(type v, float* f) {
    f[0] = __low2float(v);
    f[1] = __high2float(v);
  }
};

// ptr (n_rows + 1) and rows (n_rows) are in the processing order: slot t
// sums edges [ptr[t], ptr[t + 1]) of src and w into output row rows[t].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    csr_spmm_kernel(const T* __restrict__ x, const int* __restrict__ ptr,
                    const int* __restrict__ rows, const int* __restrict__ src,
                    const float* __restrict__ w, float* __restrict__ out, int n_rows, int d,
                    int col_tiles) {
  using L = typename Lanes<T, V>::type;
  const long long task = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (task >= static_cast<long long>(n_rows) * col_tiles) return;  // a whole warp leaves
  const int lane = threadIdx.x & 31;
  const int slot = static_cast<int>(task / col_tiles);
  const int col =
      (static_cast<int>(task - static_cast<long long>(slot) * col_tiles) * 32 + lane) * V;
  const bool live = col < d;  // V divides d, so a live lane's V columns are all in
  const int row = rows[slot];
  const int beg = ptr[slot];
  const int end = ptr[slot + 1];
  const L* xc = reinterpret_cast<const L*>(x + col);
  const long long ld = d / V;  // a row's stride in L
  const int mine = lane & (kChunk - 1);

  // lane j's id and weight of the chunk at base (0 past the row's end)
  auto ids = [&](int base, int& s, float& wt) {
    s = 0;
    wt = 0.f;
    if (base + mine < end) {
      s = src[base + mine];
      wt = w[base + mine];
    }
  };
  // every lane's loads of the chunk at base, ids s (lane j's, broadcast)
  auto gather = [&](int base, int s, L* v) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int sj = __shfl_sync(kFull, s, j);
      if (live && base + j < end) v[j] = xc[sj * ld];
    }
  };

  int s_cur, s_nxt;
  float w_cur, w_nxt;
  L v_cur[kChunk], v_nxt[kChunk];
  ids(beg, s_cur, w_cur);
  gather(beg, s_cur, v_cur);
  ids(beg + kChunk, s_nxt, w_nxt);
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.f;
  for (int base = beg; base < end; base += kChunk) {  // uniform over the warp
    gather(base + kChunk, s_nxt, v_nxt);
    int s_far;
    float w_far;
    ids(base + 2 * kChunk, s_far, w_far);
    const int n = min(kChunk, end - base);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float wj = __shfl_sync(kFull, w_cur, j);
      if (j < n && live) {
        float f[V];
        Lanes<T, V>::widen(v_cur[j], f);
#pragma unroll
        for (int c = 0; c < V; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(wj, f[c]));
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v_cur[j] = v_nxt[j];
    w_cur = w_nxt;
    s_nxt = s_far;
    w_nxt = w_far;
  }
  if (live) {
    float* o = out + static_cast<long long>(row) * d + col;
#pragma unroll
    for (int c = 0; c < V; ++c) o[c] = acc[c];
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const int* ptr, const int* rows, const int* src,
                   const float* w, float* out, int n_rows, int d, cudaStream_t stream) {
  const int col_tiles = (d + 32 * V - 1) / (32 * V);
  const long long blocks = (static_cast<long long>(n_rows) * col_tiles + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  csr_spmm_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), ptr, rows, src, w, out, n_rows, d, col_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const void* x, const int* ptr, const int* rows, const int* src,
                       const float* w, float* out, int n_rows, int d, cudaStream_t stream) {
  const bool pairs = d % 2 == 0 && reinterpret_cast<std::uintptr_t>(x) % (2 * sizeof(T)) == 0;
  if (pairs) return launch<T, 2>(x, ptr, rows, src, w, out, n_rows, d, stream);
  return launch<T, 1>(x, ptr, rows, src, w, out, n_rows, d, stream);
}

}  // namespace

// On CUDA device `device` (made current for the call) and `stream`:
// x: (n_src, d) contiguous, fp32 (bf16 == 0) or bf16 (bf16 != 0); ptr:
// n_rows + 1 int32, rising from 0; rows: n_rows int32 output rows, each
// once; src: int32 ids < n_src and w: fp32 weights, ptr[n_rows] of each;
// out: (n_rows_out, d) fp32 contiguous, every row named in rows. Every output
// row named in rows is written; no other is touched.
// Returns a cudaError_t: cudaErrorInvalidValue for a bad shape, else the
// launch's.
extern "C" int chaorec_csr_spmm(const void* x, int bf16, const int* ptr, const int* rows,
                                const int* src, const float* w, float* out, int n_rows, int d,
                                int device, void* stream) {
  if (n_rows < 0 || d < 1 || device < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_vec<__nv_bfloat16>(x, ptr, rows, src, w, out, n_rows, d, st)
             : launch_vec<float>(x, ptr, rows, src, w, out, n_rows, d, st);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
