// How many query rows a thread owns, and how a group's rows are laid out
// in blocks, for the two kernels that walk query rows: the attention
// forward (csrc/fused_mha.cu) and the backward's dq kernel
// (csrc/fused_mha_bwd.cu). Both then launch G x blocks_per_group blocks of
// `warps` warps, a warp owning 32 R consecutive rows.

#pragma once

#include <cuda_runtime.h>

namespace chaorec {

constexpr int kRowWarps = 4;  // warps per block, at most

struct RowShape {
  int rows_per_thread, warps, blocks_per_group;
};

// R and the block size for G groups of Lq rows: R = 3 when its warps of 96
// rows compute at most 5% more rows than Lq and still give every SM
// kWarpsPerSm warps, else R = 1; then blocks of up to kRowWarps warps, the
// group's warps spread evenly over them.
inline RowShape pick_row_shape(long long g, int lq) {
  constexpr int kWarpsPerSm = 8;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long w3 = (lq + 95LL) / 96;
  const int rr = (w3 * 96 * 20 <= 21LL * lq && g * w3 >= 1LL * kWarpsPerSm * sms) ? 3 : 1;
  const long long per_group = (lq + 32LL * rr - 1) / (32LL * rr);
  const long long blocks = (per_group + kRowWarps - 1) / kRowWarps;
  const long long wb = (per_group + blocks - 1) / blocks;  // spread the warps evenly
  return {rr, static_cast<int>(wb), static_cast<int>(blocks)};
}

}  // namespace chaorec
