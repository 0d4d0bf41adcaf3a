// Simultaneous clear of full rows, columns and regions, for one board held
// in shared memory by one warp.  The clear epilogue of the apply kernel
// (collision.cu) and the body of the general clear kernel (clear.cu).
//
// Lines come as a table: line l owns line_len[l] flat cell indices at
// line_cells[l * max_len ...].  A line is full iff the sum of its cells'
// bytes equals its length (the TPU kernel's `occ == sizes` test).  Every
// full line is found on the un-cleared board first and only then cleared,
// so a cell on two full lines is counted in both and cleared once.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Warps a block of the general clear and apply kernels, one env each, with
// `hw + num_lines` bytes of shared memory a warp (the board, then a flag a
// line): four, or the most that fit the 227 KB a block may opt in to;
// 0 where one warp's do not (the entry refuses the launch).  Kept equal to
// kernels/clear.py `general_warps`.
inline int general_warps(int hw, int num_lines) {
  const long long per_warp = static_cast<long long>(hw) + num_lines;
  const long long fit = 227LL * 1024 / per_warp;
  return static_cast<int>(fit < 4 ? fit : 4);
}

// `kernel`'s launch for n envs at `warps` warps a block (`general_warps`),
// opted in above the 48 KB a launch gets without asking; the error code.
template <typename Kernel, typename... Args>
int launch_general(Kernel kernel, int n, int warps, int hw, int num_lines,
                   cudaStream_t stream, Args... args) {
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = warps * (hw + num_lines);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(n + warps - 1) / warps, warps * 32, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// `cells`: the warp's HW board bytes in shared memory, cleared in place.
// `full`: num_lines bytes of shared scratch.  All 32 lanes must call it.
// Returns the number of full lines k, the same on every lane.
__device__ __forceinline__ int clear_full_lines(
    uint8_t* cells, uint8_t* full, const int32_t* __restrict__ line_cells,
    const int32_t* __restrict__ line_len, int num_lines, int max_len,
    int lane) {
  int k = 0;
  for (int l = lane; l < num_lines; l += 32) {
    const int32_t* idx = line_cells + l * max_len;
    const int len = line_len[l];
    int occ = 0;
    for (int j = 0; j < len; ++j) occ += cells[idx[j]];
    full[l] = occ == len;
    k += occ == len;
  }
  __syncwarp();  // every line is judged on the board before any clear
  for (int l = lane; l < num_lines; l += 32) {
    if (!full[l]) continue;
    const int32_t* idx = line_cells + l * max_len;
    for (int j = 0; j < line_len[l]; ++j) cells[idx[j]] = 0;
  }
  __syncwarp();
  for (int offset = 16; offset > 0; offset >>= 1)
    k += __shfl_xor_sync(0xffffffffu, k, offset);
  return k;
}
