// Inclusive prefix sum down the rows of an (M, D) tensor, for Hopper (sm_90a):
//
//   out[r, j] = sum_{i <= r} x[i, j]        fp32 out, fp32 or bf16 x
//
// Replaces the TPU kernel chaorec_tpu/ops/pallas_scan.py:_cumsum_kernel
// (launched by chunked_cumsum). The TPU kernel walks 512-row blocks in
// order on one core and carries the running total from block to block in
// scratch memory. Hopper's blocks run in no order, so nothing is carried
// between them: the scan is reduce, then scan the totals, then scan.
//
// What bounds it. Every element of x is read once and every element of out
// written once: at least 8 M D bytes for fp32 x (6 M D for bf16), against
// one add per element. At 3.35 TB/s that is 12.2 us for DGCF's (159101, 32)
// and 194.5 us for MGAT's (318202, 256). It is bound by device memory;
// nothing here is worth a tensor core.
//
// Design. The rows are cut into chunks (about four blocks per SM, so DGCF's
// 159k rows at D = 32 give ~528 blocks on 132 SMs). A block of 256 threads
// owns one chunk and a tile of up to 256 columns; its threads are G row
// groups of W columns (W = min(D, 256), G = 256 / W), and group g owns a
// contiguous run of the chunk's rows, so neighbouring threads read
// neighbouring addresses of a row. Three launches, three passes over the
// data (two reads of x and one write of out, 12 M D bytes for fp32 x, plus
// a small scratch of one total per group and column):
//
//   1. group_sums: each thread sums its run of rows in order, for its column;
//   2. carries:    one block per column tile replaces each group total by
//                  the sum of every total before it in row order (an
//                  exclusive scan: runs of totals in order, then a
//                  Hillis-Steele scan over the runs in shared memory);
//   3. scan:       each thread adds its run's rows in order to its carry and
//                  writes every prefix.
//
// Every sum is taken in one fixed order and there are no atomics, so two
// runs on the same input give the same bits. Any D >= 1 and any M >= 1:
// the ragged last chunk, group and column tile are bounded in the kernels,
// with no padded copies. Element offsets are 64-bit (M D passes 2^31 on the
// larger datasets).
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // block of the chunk passes, and the widest column tile
constexpr int kCarryThreads = 1024;  // block of the carry pass

struct Layout {
  long long m;           // rows
  int d;                 // columns
  int width;             // columns per tile: min(d, kThreads)
  int groups;            // row groups per block: kThreads / width
  long long chunk_rows;  // rows per block
  long long run_rows;    // rows per group: ceil(chunk_rows / groups)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// This thread's column and its run of rows [*begin, *end); false when the
// thread has no column.
__device__ __forceinline__ bool my_run(const Layout& L, int* col, long long* begin,
                                       long long* end) {
  const int g = threadIdx.x / L.width;
  *col = blockIdx.y * L.width + threadIdx.x % L.width;
  if (g >= L.groups || *col >= L.d) return false;
  const long long chunk0 = static_cast<long long>(blockIdx.x) * L.chunk_rows;
  const long long chunk1 = min(chunk0 + L.chunk_rows, L.m);
  *begin = min(chunk0 + g * L.run_rows, chunk1);
  *end = min(*begin + L.run_rows, chunk1);
  return true;
}

// The scratch slot of this thread's group: (chunk * groups + group, column).
__device__ __forceinline__ long long slot(const Layout& L, int col) {
  return (static_cast<long long>(blockIdx.x) * L.groups + threadIdx.x / L.width) * L.d + col;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_sums_kernel(const T* __restrict__ x, float* __restrict__ part, Layout L) {
  int col;
  long long r, end;
  if (!my_run(L, &col, &r, &end)) return;
  const T* p = x + r * L.d + col;
  float acc = 0.f;
#pragma unroll 4
  for (; r < end; ++r, p += L.d) acc += to_float(*p);
  part[slot(L, col)] = acc;
}

// part: (k_rows, d). Each entry becomes the sum of the entries above it in
// its column. Thread (g, c) of a block owns a run of rows of column
// blockIdx.x * width + c.
__global__ void __launch_bounds__(kCarryThreads)
    carry_kernel(float* __restrict__ part, long long k_rows, int d, int width) {
  __shared__ float run_sums[kCarryThreads];
  const int t = threadIdx.x;
  const int groups = kCarryThreads / width;
  const int g = t / width;
  const int col = blockIdx.x * width + t % width;
  const bool mine = g < groups && col < d;
  const long long per = (k_rows + groups - 1) / groups;
  const long long k0 = min(static_cast<long long>(g) * per, k_rows);
  const long long k1 = min(k0 + per, k_rows);
  float acc = 0.f;
  if (mine) {
    for (long long k = k0; k < k1; ++k) acc += part[k * d + col];
  }
  run_sums[t] = acc;
  __syncthreads();
  // inclusive scan of the runs' sums over g, per column, in a fixed order
  for (int off = 1; off < groups; off <<= 1) {
    const float v = (g < groups && g >= off) ? run_sums[t - off * width] : 0.f;
    __syncthreads();
    run_sums[t] += v;
    __syncthreads();
  }
  if (!mine) return;
  float before = g > 0 ? run_sums[t - width] : 0.f;
  for (long long k = k0; k < k1; ++k) {
    const float v = part[k * d + col];
    part[k * d + col] = before;
    before += v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ x, const float* __restrict__ carry,
                float* __restrict__ out, Layout L) {
  int col;
  long long r, end;
  if (!my_run(L, &col, &r, &end)) return;
  float acc = carry[slot(L, col)];
  const long long off = r * L.d + col;
  const T* p = x + off;
  float* o = out + off;
#pragma unroll 4
  for (; r < end; ++r, p += L.d, o += L.d) {
    acc += to_float(*p);
    *o = acc;
  }
}

template <typename T>
cudaError_t launch(const void* x, float* out, float* part, long long m, int d,
                   long long chunk_rows, int chunks, cudaStream_t stream) {
  Layout L;
  L.m = m;
  L.d = d;
  L.width = d < kThreads ? d : kThreads;
  L.groups = kThreads / L.width;
  L.chunk_rows = chunk_rows;
  L.run_rows = (chunk_rows + L.groups - 1) / L.groups;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>((d + L.width - 1) / L.width));
  const T* xt = static_cast<const T*>(x);
  group_sums_kernel<T><<<grid, kThreads, 0, stream>>>(xt, part, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = d < kCarryThreads ? d : kCarryThreads;
  carry_kernel<<<(d + width - 1) / width, kCarryThreads, 0, stream>>>(
      part, static_cast<long long>(chunks) * L.groups, d, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_kernel<T><<<grid, kThreads, 0, stream>>>(xt, part, out, L);
  return cudaGetLastError();
}

}  // namespace

// x: (m, d) contiguous, fp32 (bf16 == 0) or bf16 (bf16 != 0). out: (m, d)
// fp32 contiguous. part: chunks * (256 / min(d, 256)) * d fp32 scratch.
// chunk_rows >= 1 rows per block and chunks == ceil(m / chunk_rows).
// Returns a cudaError_t: cudaErrorInvalidValue for an empty or inconsistent
// shape, else the launches'.
extern "C" int chaorec_prefix_scan(const void* x, int bf16, float* out, float* part,
                                   long long m, int d, long long chunk_rows, int chunks,
                                   void* stream) {
  if (m < 1 || d < 1 || chunk_rows < 1 || chunks < 1 ||
      static_cast<long long>(chunks) != (m + chunk_rows - 1) / chunk_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(launch<__nv_bfloat16>(x, out, part, m, d, chunk_rows, chunks, s));
  }
  return static_cast<int>(launch<float>(x, out, part, m, d, chunk_rows, chunks, s));
}
