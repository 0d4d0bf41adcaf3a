// Simultaneous line clear: the CUDA port of the TPU kernel `_clear_kernel`
// (blockpuzzle_tpu/kernels/clear.py, launched by `_clear_pallas_call` from
// `ClearScanKernel.__call__`).
//
// What it computes, per env: every full row, column and region of the
// board is found, then all of them are cleared at once, and k is their
// number.  Unlike the apply kernel there is no legality gate: a line that
// is full on the input is cleared and counted.  The TPU formulation -- two
// line-mask matmuls in bf16 -- exists for Mosaic's layout rules and is not
// carried over.
//
// Design: one warp per env, four envs per block, any N (a warp past the
// last env exits as a whole, before any warp collective).  Lanes stride the
// HW cells, so the load and the store are coalesced; the board sits in
// shared memory while `clear_full_lines` (clear_lines.cuh, shared with the
// apply kernel) judges the L lines, one lane per line, and clears them.
//
// Bound on the H100: device memory.  Per env it reads HW board bytes and
// writes HW board bytes and a 4-byte k: 204 B on the default preset
// (HW = 100), 10.0 MB at N = 49152, ~3 us at 3.35 TB/s.  The line table
// (<= 32 lines of <= 16 int32 on the shipped presets) stays in L1.

#include <cstdint>
#include <cuda_runtime.h>

#include "clear_lines.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void clear_kernel(const uint8_t* __restrict__ board,
                             const int32_t* __restrict__ line_cells,
                             const int32_t* __restrict__ line_len,
                             uint8_t* __restrict__ board_out,
                             int32_t* __restrict__ k_out, int n, int hw,
                             int num_lines, int max_len) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long env = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (env >= n) return;
  uint8_t* cells = smem + warp * (hw + num_lines);
  uint8_t* full = cells + hw;
  const uint8_t* b = board + env * hw;
  for (int j = lane; j < hw; j += 32) cells[j] = b[j];
  __syncwarp();
  const int k = clear_full_lines(cells, full, line_cells, line_len, num_lines,
                                 max_len, lane);
  uint8_t* o = board_out + env * hw;
  for (int j = lane; j < hw; j += 32) o[j] = cells[j];
  if (lane == 0) k_out[env] = k;
}

}  // namespace

// board (N, HW) u8; line_cells (L, max_len) i32 and line_len (L,) i32;
// outputs board_out (N, HW) u8 and k (N,) i32.
extern "C" int bp_clear(const void* board, const void* line_cells,
                        const void* line_len, void* board_out, void* k_out,
                        int n, int hw, int num_lines, int max_len,
                        void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    const size_t smem = static_cast<size_t>(kWarps) * (hw + num_lines);
    clear_kernel<<<blocks, kWarps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(board),
        static_cast<const int32_t*>(line_cells),
        static_cast<const int32_t*>(line_len),
        static_cast<uint8_t*>(board_out), static_cast<int32_t*>(k_out), n, hw,
        num_lines, max_len);
  }
  return static_cast<int>(cudaGetLastError());
}
