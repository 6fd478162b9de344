// Inclusive prefix sum down the rows of an (M, D) tensor, for Hopper (sm_90a):
//
//   out[r, j] = sum_{i <= r} x[i, j]        fp32 out, fp32 or bf16 x
//
// Replaces the TPU kernel chaorec_tpu/ops/pallas_scan.py:_cumsum_kernel
// (launched by chunked_cumsum). The TPU kernel walks 512-row blocks in
// order on one core and carries a (1, D) running total from one block to
// the next. Here the blocks run at once, one launch a call, and the carry is
// that same running total, handed from tile to tile by a look-back.
//
// What bounds it. Every element of x is read once and every element of out
// written once: 8 M D bytes for fp32 x (6 M D for bf16), against one add per
// element. At 3.35 TB/s that is 12.2 us for DGCF's (159101, 32) and 194.5 us
// for MGAT's (318202, 256): device memory bounds it. This kernel moves just
// those bytes, plus two (1, D') vectors a tile that stay in L2, and one
// memset of them a call.
//
// Layout. A unit is 4 adjacent columns, loaded as one 16-byte vector (8
// bytes for bf16), where D % 4 == 0 and x and out are aligned to it, else
// one column (the scalar path: out = cs[1:] of ops/ell.py lies 4 D bytes
// into its allocation, so D = 1, 3 or 7 is not 16-byte aligned). A tile is
// tile_rows contiguous rows by a column tile of at most kMaxUnits units.
// A tile spans every column up to D = 64; wider rows are cut into even
// column tiles, which keeps a tile tall (256-512 rows, 64 KB at fp32): the
// carry chain and the look-back's window grow with the number of tiles.
// Its 256 threads are G = 256 / units row groups; group g owns a run of at
// most kRows contiguous rows of its unit's column(s). The tile is staged in
// shared memory (cp.async, 64 KB at fp32), not in registers, so an SM
// holds three blocks and their loads at once.
//
// One tile, in one block:
//   1. thread 0 takes the tile's number from a counter (atomicAdd), so every
//      tile it may wait on belongs to a block that is already running;
//   2. each thread issues all its run's loads (cp.async into shared memory)
//      before it adds, then sums the run in order; the run totals are
//      scanned over the groups in a fixed (Hillis-Steele) order in shared
//      memory, which gives the tile's aggregate A_i;
//   3. the tile publishes A_i, looks back for the nearest predecessor in its
//      column tile whose inclusive prefix P_j is published, and sums
//      FORWARD: the carry is P_j + A_{j+1} + ... + A_{i-1}, added in that
//      order. By induction over i, P_{j+1} = P_j + A_{j+1} bit for bit, so
//      this carry equals P_{i-1}, and P_i = carry + A_i, whatever window the
//      timing gave: two runs give the same bits, and the carry is the TPU
//      kernel's serial running total (CUB's look-back adds the window
//      backwards from the nearest aggregate, whose bits depend on timing);
//   4. it publishes P_i and writes out = (carry + the groups before it) +
//      its run's prefix, summed again from shared memory in the same order.
//
// Publication. Each published 4-byte word is its own status flag, so no
// value waits for a fence and no separate flag can run ahead of its value.
// The C entry fills A, P and the tile counter with kEmpty (a NaN bit
// pattern that no published value has: they are canonicalized) by one
// cudaMemsetAsync on the caller's stream before every launch, so a call
// needs nothing remembered from an earlier one (and replays in a graph).
// A tile stores each value once with st.relaxed.gpu; a reader loads with
// ld.relaxed.gpu (L2, each 4-byte word single-copy atomic) and loads again
// while a word reads kEmpty. The look-back polls the first word of each
// predecessor's P to choose its window, then awaits every word it sums. A
// word that stays kEmpty for kMaxPolls polls traps: a protocol fault is a
// CUDA error, not a hang.
//
// Any D >= 1 and any M >= 1: the ragged last row tile, column tile and run
// are bounded in the kernel, with no padded copies. Element offsets are
// 64-bit. The only atomic is the tile counter's; no data is summed by
// atomics.
//
// The C entry point launches on the caller's stream and returns
// cudaGetLastError(), so a refused launch reaches the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // threads of a block, = groups x units of a tile
constexpr int kRows = 16;          // most rows of a thread's run (staged in shared memory)
constexpr int kMinBlocks = 3;      // blocks an SM holds (shared memory: 3 x 72 KB at fp32)
constexpr int kMaxUnits = 16;      // most units of a column tile
constexpr int kPolls = 4;          // row tiles a lane of the look-back polls per step
constexpr int kMaxPolls = 1 << 22; // polls of one value before a trap
constexpr int kWindowRegs = 4;     // look-back values a thread loads at once (even)
constexpr int kBatch = 8;          // window values the carry's adds load at once

template <int V>
struct alignas(4 * V) Vec {
  float a[V];
};

template <int V>
__device__ __forceinline__ Vec<V> zero() {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.a[i] = 0.f;
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> operator+(const Vec<V>& p, const Vec<V>& q) {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.a[i] = p.a[i] + q.a[i];
  return r;
}

// One unit of x as it is staged: its raw bytes (16, 8, 4 or 2).
template <typename T, int V>
struct alignas(sizeof(T) * V) Raw {
  T a[V];
};

// Stage a unit of x from global to shared memory: cp.async where the unit
// is 4, 8 or 16 bytes, else (one bf16) a plain copy.
template <typename T, int V>
__device__ __forceinline__ void stage(Raw<T, V>* dst, const T* src) {
  constexpr int kBytes = sizeof(Raw<T, V>);
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
  } else if constexpr (kBytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
  } else {
    *dst = *reinterpret_cast<const Raw<T, V>*>(src);
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int V>
__device__ __forceinline__ Vec<V> widen(const Raw<T, V>& r) {
  Vec<V> v;
#pragma unroll
  for (int i = 0; i < V; ++i) v.a[i] = widen(r.a[i]);
  return v;
}

// Scratch values. Each 4-byte word is its own flag: the C entry fills the
// scratch with kEmpty before the launch, a tile stores each value once
// (relaxed, single-copy atomic per word), and a reader that loads kEmpty
// loads again. No sum gives kEmpty: published values are canonicalized.
constexpr unsigned kEmpty = 0xffffffffu;  // a NaN; CUDA's own NaN is 0x7fffffff

__device__ __forceinline__ float canonical(float v) {
  return isnan(v) ? __uint_as_float(0x7fffffffu) : v;
}
template <int V>
__device__ __forceinline__ void publish(float* p, const Vec<V>& v) {
  if constexpr (V == 4) {
    asm volatile("st.relaxed.gpu.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "f"(canonical(v.a[0])), "f"(canonical(v.a[1])), "f"(canonical(v.a[2])),
                 "f"(canonical(v.a[3]))
                 : "memory");
  } else {
    asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" ::"l"(p), "f"(canonical(v.a[0]))
                 : "memory");
  }
}
template <int V>
__device__ __forceinline__ Vec<V> peek(const float* p) {
  Vec<V> v;
  if constexpr (V == 4) {
    asm volatile("ld.relaxed.gpu.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.a[0]), "=f"(v.a[1]), "=f"(v.a[2]), "=f"(v.a[3])
                 : "l"(p)
                 : "memory");
  } else {
    asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v.a[0]) : "l"(p) : "memory");
  }
  return v;
}
template <int V>
__device__ __forceinline__ bool empty(const Vec<V>& v) {
  bool e = false;
#pragma unroll
  for (int i = 0; i < V; ++i) e |= __float_as_uint(v.a[i]) == kEmpty;
  return e;
}

// A value another tile publishes, once it is there; a trap if it never comes.
template <int V>
__device__ __forceinline__ Vec<V> await(const float* p, Vec<V> v) {
  for (int polls = 0; empty<V>(v); ++polls) {
    if (polls > kMaxPolls) __trap();
    __nanosleep(32);
    v = peek<V>(p);
  }
  return v;
}

template <int V>
__device__ __forceinline__ void store_out(float* p, const Vec<V>& v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v.a[0], v.a[1], v.a[2], v.a[3]);
  } else {
    *p = v.a[0];
  }
}

struct Layout {
  long long m;          // rows
  int d;                // columns
  int units;            // units of a row: d / 4 (vector path) or d
  int tile_units;       // units of a full column tile
  int col_tiles;        // column tiles: ceil(units / tile_units)
  int groups;           // row groups of a block: kThreads / tile_units
  int run_rows;         // rows of a group's run: ceil(tile_rows / groups) <= kRows
  long long tile_rows;  // rows of a tile
  long long row_tiles;  // ceil(m / tile_rows)
};

template <typename T, int V>
constexpr int stage_bytes() {
  return kRows * kThreads * static_cast<int>(sizeof(Raw<T, V>));
}

// scratch: agg (row_tiles, d) and inc (row_tiles, d) fp32, then the tile
// counter, all filled with kEmpty before the launch. Dynamic shared
// memory: the staged tile, unit k of thread t at [k][t].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    lookback_scan_kernel(const T* __restrict__ x, float* __restrict__ out,
                         float* __restrict__ scratch, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  Raw<T, V>* staged = reinterpret_cast<Raw<T, V>*>(smem);
  // the groups' scan (two buffers), then the look-back's window (both)
  __shared__ Vec<V> part[2 * kThreads];
  __shared__ Vec<V> carry_sh[kMaxUnits];
  __shared__ long long tile_sh, base_sh;

  float* agg = scratch;
  float* inc = scratch + L.row_tiles * L.d;
  unsigned* counter = reinterpret_cast<unsigned*>(scratch + 2 * L.row_tiles * L.d);

  const int tid = threadIdx.x;
  if (tid == 0) tile_sh = atomicAdd(counter, 1u) + 1u;  // the counter starts at kEmpty
  __syncthreads();
  const long long tile = tile_sh;
  const long long rt = tile / L.col_tiles;
  const int ct = static_cast<int>(tile % L.col_tiles);

  const int g = tid / L.tile_units;
  const int u = tid % L.tile_units;
  const int unit = ct * L.tile_units + u;
  const bool mine = g < L.groups && unit < L.units;  // this thread owns a column unit
  const int col = unit * V;
  const long long tile0 = rt * L.tile_rows;
  const long long tile1 = min(tile0 + L.tile_rows, L.m);
  const long long r0 = min(tile0 + static_cast<long long>(g) * L.run_rows, tile1);
  const int n = mine ? static_cast<int>(min(r0 + L.run_rows, tile1) - r0) : 0;

  // 2. all the run's loads first (each thread reads back only its own
  // units, so waiting for its own copies is enough), then its sum in order
  const T* px = x + r0 * L.d + col;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k < n) stage<T, V>(staged + k * kThreads + tid, px + k * static_cast<long long>(L.d));
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  Vec<V> run = zero<V>();
  for (int k = 0; k < n; ++k) {
    const Vec<V> xk = widen(staged[k * kThreads + tid]);
    run = k == 0 ? xk : run + xk;
  }

  // the run totals, inclusive over the groups, in a fixed order (one
  // barrier a step: each step reads one buffer and writes the other)
  const bool in_grid = g < L.groups;
  Vec<V>* cur = part;
  Vec<V>* next = part + kThreads;
  cur[tid] = run;
  __syncthreads();
  for (int off = 1; off < L.groups; off <<= 1) {
    Vec<V> p = cur[tid];
    if (in_grid && g >= off) p = p + cur[tid - off * L.tile_units];
    next[tid] = p;
    Vec<V>* t = cur;
    cur = next;
    next = t;
    __syncthreads();
  }
  const Vec<V> before = g > 0 && in_grid ? cur[tid - L.tile_units] : zero<V>();
  const Vec<V> aggregate = cur[(L.groups - 1) * L.tile_units + u];
  const bool lead = g == 0 && mine;  // publishes this unit's values
  float* my_inc = inc + rt * L.d + col;

  Vec<V> carry = zero<V>();
  if (rt == 0) {
    if (lead) publish<V>(my_inc, aggregate);  // P_0 = A_0
  } else {
    // 3. publish A_i, then find the nearest row tile whose P_j is out: lane
    // l of step q looks at the first word of row tile j - 32 q - l
    if (lead) publish<V>(agg + rt * L.d + col, aggregate);
    if (tid < 32) {
      const float* first = inc + ct * L.tile_units * V;
      long long j = rt - 1;
      int polls = 0;
      for (;;) {
        bool out_now[kPolls];
#pragma unroll
        for (int q = 0; q < kPolls; ++q) {
          const long long t = j - 32 * q - tid;
          out_now[q] = t >= 0 && !empty<1>(peek<1>(first + t * L.d));
        }
        long long found = -1;
#pragma unroll
        for (int q = kPolls - 1; q >= 0; --q) {
          const unsigned seen = __ballot_sync(0xffffffffu, out_now[q]);
          if (seen) found = j - 32 * q - (__ffs(seen) - 1);
        }
        if (found >= 0) {
          if (tid == 0) base_sh = found;
          break;
        }
        j -= 32 * kPolls;
        if (j < 0) {  // none out yet, down to row tile 0: look again from the nearest
          if (++polls > kMaxPolls) __trap();
          __nanosleep(32);
          j = rt - 1;
        }
      }
    }
    __syncthreads();  // also: every thread has read `before` and `aggregate`
    // the carry, summed forward: P_base, then A_{base+1} ... A_{rt-1}. Each
    // thread loads up to kWindowRegs of them at once (window position g + k
    // G for unit u), then they pass through `part`, 2 G a unit at a time, to
    // the lead thread, which adds them in order.
    const long long base = base_sh;
    const long long count = rt - base;  // values to add: P_base and count - 1 aggregates
    const long long batch = static_cast<long long>(kWindowRegs) * L.groups;
    Vec<V>* window = part;
    for (long long b0 = 0; b0 < count; b0 += batch) {
      Vec<V> got[kWindowRegs];
#pragma unroll
      for (int k = 0; k < kWindowRegs; ++k) {
        const long long w = b0 + g + k * L.groups;
        if (mine && w < count) got[k] = peek<V>((w == 0 ? inc : agg) + (base + w) * L.d + col);
      }
#pragma unroll
      for (int k0 = 0; k0 < kWindowRegs; k0 += 2) {
        const long long w0 = b0 + static_cast<long long>(k0) * L.groups;
        if (w0 >= count) break;
#pragma unroll
        for (int k = k0; k < k0 + 2; ++k) {
          const long long w = b0 + g + k * L.groups;
          if (mine && w < count) {
            window[(g + (k - k0) * L.groups) * L.tile_units + u] =
                await<V>((w == 0 ? inc : agg) + (base + w) * L.d + col, got[k]);
          }
        }
        __syncthreads();
        if (lead) {
          const int stop = static_cast<int>(min(2LL * L.groups, count - w0));
          int w = 0;
          for (; w + kBatch <= stop; w += kBatch) {
            Vec<V> b[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) b[k] = window[(w + k) * L.tile_units + u];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) carry = carry + b[k];
          }
          for (; w < stop; ++w) carry = carry + window[w * L.tile_units + u];
        }
        __syncthreads();
      }
    }
    // 4. publish P_i = carry + A_i
    if (lead) {
      publish<V>(my_inc, carry + aggregate);
      carry_sh[u] = carry;
    }
    __syncthreads();
    if (mine) carry = carry_sh[u];
  }

  // 4. out = (carry + the groups before) + the run's prefix, in pass 1's order
  const Vec<V> pre = carry + before;
  float* po = out + r0 * L.d + col;
  run = zero<V>();
  for (int k = 0; k < n; ++k) {
    const Vec<V> xk = widen(staged[k * kThreads + tid]);
    run = k == 0 ? xk : run + xk;
    store_out<V>(po + k * static_cast<long long>(L.d), pre + run);
  }
}

constexpr int kMaxDevices = 64;

template <typename T, int V>
cudaError_t launch(const void* x, float* out, float* scratch, const Layout& L, int device,
                   cudaStream_t stream) {
  static bool sized[kMaxDevices] = {};  // the dynamic shared memory is allowed, per device
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!sized[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        lookback_scan_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        stage_bytes<T, V>());
    if (err != cudaSuccess) return err;
    sized[device] = true;
  }
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0xff, (2 * L.row_tiles * L.d + 1) * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  lookback_scan_kernel<T, V><<<static_cast<unsigned>(L.row_tiles * L.col_tiles), kThreads,
                               stage_bytes<T, V>(), stream>>>(static_cast<const T*>(x), out,
                                                              scratch, L);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_on(const void* x, float* out, float* scratch, const Layout& L, int device,
                      cudaStream_t stream) {
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) {
    return err != cudaSuccess ? err : launch<T, V>(x, out, scratch, L, device, stream);
  }
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = launch<T, V>(x, out, scratch, L, device, stream);
  const cudaError_t back = cudaSetDevice(current);
  return err != cudaSuccess ? err : back;
}

}  // namespace

// On CUDA device `device` (made current for the call) and `stream`:
// x: (m, d) contiguous, fp32 (bf16 == 0) or bf16 (bf16 != 0). out: (m, d)
// fp32 contiguous. vec != 0 takes 4-column units, and needs d % 4 == 0, out
// 16-byte aligned and x 16-byte (fp32) or 8-byte (bf16) aligned. The tiles:
// col_tiles == ceil(units / kMaxUnits) column tiles (units = d / 4 or d),
// tile_rows rows a tile, at most (256 / ceil(units / col_tiles)) x kRows,
// and row_tiles == ceil(m / tile_rows). scratch: scratch_words >= 2
// row_tiles d + 1 four-byte words, 16-byte aligned.
// Returns a cudaError_t: cudaErrorInvalidValue for an empty or inconsistent
// shape, cudaErrorMisalignedAddress for a misaligned vector path, else the
// memset's or the launch's.
extern "C" int chaorec_prefix_scan(const void* x, int bf16, float* out, void* scratch,
                                   long long scratch_words, long long m, int d, int vec,
                                   int col_tiles, long long tile_rows, long long row_tiles,
                                   int device, void* stream) {
  if (m < 1 || d < 1 || tile_rows < 1 || col_tiles < 1 || device < 0 || (vec && d % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layout L;
  L.m = m;
  L.d = d;
  L.units = vec ? d / 4 : d;
  L.col_tiles = col_tiles;
  L.tile_units = (L.units + col_tiles - 1) / col_tiles;
  L.groups = L.tile_units <= kThreads ? kThreads / L.tile_units : 0;
  L.tile_rows = tile_rows;
  L.row_tiles = row_tiles;
  if (col_tiles != (L.units + kMaxUnits - 1) / kMaxUnits || L.groups < 1 ||
      tile_rows > static_cast<long long>(L.groups) * kRows ||
      row_tiles != (m + tile_rows - 1) / tile_rows || scratch_words < 2 * row_tiles * d + 1 ||
      row_tiles * col_tiles > 0xffffffffLL || reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  L.run_rows = static_cast<int>((tile_rows + L.groups - 1) / L.groups);
  if (vec && (reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(x) % (bf16 ? 8 : 16) != 0)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  float* s = static_cast<float*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(vec ? launch_on<__nv_bfloat16, 4>(x, out, s, L, device, st)
                                : launch_on<__nv_bfloat16, 1>(x, out, s, L, device, st));
  }
  return static_cast<int>(vec ? launch_on<float, 4>(x, out, s, L, device, st)
                              : launch_on<float, 1>(x, out, s, L, device, st));
}
