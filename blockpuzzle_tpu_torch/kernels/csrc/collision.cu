// Chosen-action apply: the CUDA port of the TPU kernel `_apply_kernel`
// (blockpuzzle_tpu/kernels/collision.py, launched by `_apply_pallas_call`
// from `ApplyKernel.__call__`).
//
// What it computes, per env: the action is legal iff `valid` and the
// footprint `cover` overlaps no occupied cell.  A legal action places the
// footprint, finds every full row, column and region on the placed board,
// clears them all at once and reports k = their number.  An illegal action
// is a strict no-op with k = 0, even on a board that already holds a full
// line.  The TPU formulation -- line-mask matmuls in bf16 and ones-matrix
// products that spread per-row scalars across lanes -- exists for Mosaic's
// layout rules and is not carried over.
//
// Design: one warp per env, four envs per block, any N (a warp past the
// last env exits as a whole).  Lanes stride the HW cells, so the board and
// cover loads and the board store are coalesced; the overlap test is one
// warp vote; the placed board sits in shared memory while
// `clear_full_lines` (clear_lines.cuh) scans the L lines, one lane per
// line.
//
// Bound on the H100: device memory.  Per env it reads HW board bytes, HW
// cover bytes and 1 valid byte and writes HW board bytes, a 4-byte k and a
// 1-byte legal flag: 306 B on the default preset (HW = 100), 15.0 MB at
// N = 49152, ~4.5 us at 3.35 TB/s.  The line table (<= 32 lines of <= 16
// int32 on the shipped presets) is read by every warp and stays in L1.

#include <cstdint>
#include <cuda_runtime.h>

#include "clear_lines.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void apply_kernel(const uint8_t* __restrict__ board,
                             const uint8_t* __restrict__ cover,
                             const uint8_t* __restrict__ valid,
                             const int32_t* __restrict__ line_cells,
                             const int32_t* __restrict__ line_len,
                             uint8_t* __restrict__ board_out,
                             int32_t* __restrict__ k_out,
                             uint8_t* __restrict__ legal_out, int n, int hw,
                             int num_lines, int max_len) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long env = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (env >= n) return;
  uint8_t* cells = smem + warp * (hw + num_lines);
  uint8_t* full = cells + hw;
  const uint8_t* b = board + env * hw;
  const uint8_t* cv = cover + env * hw;

  bool overlap = false;
  for (int j = lane; j < hw; j += 32) {
    const uint8_t x = b[j];
    const uint8_t y = cv[j];
    overlap |= (x & y) != 0;
    cells[j] = x | y;
  }
  overlap = __any_sync(0xffffffffu, overlap);
  const bool legal = valid[env] != 0 && !overlap;  // uniform across the warp
  int k = 0;
  if (legal) {
    __syncwarp();
    k = clear_full_lines(cells, full, line_cells, line_len, num_lines,
                         max_len, lane);
  }
  uint8_t* o = board_out + env * hw;
  for (int j = lane; j < hw; j += 32) o[j] = legal ? cells[j] : b[j];
  if (lane == 0) {
    k_out[env] = k;
    legal_out[env] = legal;
  }
}

}  // namespace

// board, cover (N, HW) u8; valid (N,) bool; line_cells (L, max_len) i32 and
// line_len (L,) i32; outputs board_out (N, HW) u8, k (N,) i32, legal (N,)
// bool.
extern "C" int bp_apply(const void* board, const void* cover,
                        const void* valid, const void* line_cells,
                        const void* line_len, void* board_out, void* k_out,
                        void* legal_out, int n, int hw, int num_lines,
                        int max_len, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    const size_t smem = static_cast<size_t>(kWarps) * (hw + num_lines);
    apply_kernel<<<blocks, kWarps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(board), static_cast<const uint8_t*>(cover),
        static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(line_cells),
        static_cast<const int32_t*>(line_len),
        static_cast<uint8_t*>(board_out), static_cast<int32_t*>(k_out),
        static_cast<uint8_t*>(legal_out), n, hw, num_lines, max_len);
  }
  return static_cast<int>(cudaGetLastError());
}
