// Simultaneous line clear: the CUDA port of the TPU kernel `_clear_kernel`
// (blockpuzzle_tpu/kernels/clear.py:79, launched by `_clear_pallas_call`,
// clear.py:93, from `ClearScanKernel.__call__`).  Two kernels: the bit-row
// kernel (`clear_rows_kernel`, entry `bp_clear_rows`) for boards with
// H <= 32 and W <= 32, every shipped preset, and the general kernel
// (`clear_kernel`, entry `bp_clear`) for any other board.  The wrapper
// (kernels/clear.py) picks one by shape.
//
// What both compute, per env: every full row, column and region of the
// board is found, then all of them are cleared at once, and k is their
// number; a cell on two full lines counts in both and is cleared once.
// Unlike the apply kernel there is no legality gate: a line that is full on
// the input is cleared and counted.  The TPU formulation -- two line-mask
// matmuls in bf16 -- exists for Mosaic's layout rules and is not carried
// over.
//
// Bound on the H100: device memory.  Per env it reads HW board bytes and
// writes HW board bytes and a 4-byte k: 204 B on the default preset
// (HW = 100), 10.0 MB at N = 49152, 3.0 us at 3.35 TB/s.
//
// The bit-row kernel holds the engine's boards to their invariant: every
// cell is 0 or 1 (env/state.py).  The TPU kernel's test is `occ == sizes`,
// a sum of bytes; on 0/1 cells it is "every cell of the line is set", the
// test here on row words (bit c = byte != 0), and the output cells are the
// bits of the cleared words, 0 or 1.  The general kernel keeps the byte sum
// and writes the input bytes back.  The design carries the clear half of B1
// (packed_apply.cu) to u8 boards:
//   - one segment of H lanes per env, lane r holding row r as a word, P =
//     32 / H segments a warp (3 at H = 10), instead of a warp per env whose
//     lanes walked each line's cells through a global index table one
//     dependent load after another (20 of 32 lanes busy on default);
//   - full rows by `word == 2^W - 1` (a ballot), full columns by one
//     `__reduce_and_sync` over the segment, regions (woodoku) by ANDing each
//     band's rows by shuffles from explicit source lanes and testing its
//     region_size-bit fields; k by popcounts and `__reduce_add_sync`
//     (`clear_segment`, bit_rows.cuh, shared with the apply kernel);
//   - a block of `warps` warps covers E = warps * P envs, the fewest warps
//     (at least 4) for which E*H*W is a multiple of 16 (`mask_block_warps`):
//     its input and output are 16-byte-aligned spans, loaded into shared
//     memory with 16-byte loads (`stage_bytes`, any start address works) and
//     stored from the cleared words staged in shared memory as 16-byte
//     vectors of 0/1 bytes (`store_rows`).
// Every lane runs every ballot, shuffle, reduction and barrier; the
// reductions name the caller's segment (the 32 - P*H left-over lanes form
// one), so the masks hold on the ragged tail too.
//
// The general kernel: one warp per env, four envs per block, any N (a warp
// past the last env exits as a whole, before any warp collective).  Lanes
// stride the HW cells, so the load and the store are coalesced; the board
// sits in shared memory while `clear_full_lines` (clear_lines.cuh, shared
// with the apply kernel) judges the L lines, one lane per line, and clears
// them.  The line table (<= 32 lines of <= 16 int32 on the shipped presets)
// stays in L1.

#include <cstdint>
#include <cuda_runtime.h>

#include "bit_rows.cuh"
#include "clear_lines.cuh"

namespace {

constexpr int kWarps = 4;
using bit_rows::kAll;

__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    clear_rows_kernel(const uint8_t* __restrict__ board,
                      uint8_t* __restrict__ board_out,
                      int32_t* __restrict__ k_out, int n, int height,
                      int width, int region_size, int per_warp) {
  extern __shared__ __align__(16) uint8_t rows_smem[];
  const int per_block = blockDim.x / 32 * per_warp;
  uint32_t* rows = reinterpret_cast<uint32_t*>(rows_smem);  // E*H cleared words
  uint8_t* span = bit_rows::staged_span(rows_smem, per_block * height);
  const int hw = height * width;
  const int first = blockIdx.x * per_block;          // first env
  const int count = min(per_block, n - first);       // envs here
  const long long lo = static_cast<long long>(first) * hw;
  const int d = bit_rows::stage_bytes(board, lo, lo + static_cast<long long>(count) * hw, span);

  const bit_rows::Seat t = bit_rows::seat(height, per_warp);
  const bool active = t.s < per_warp && t.seg < count;
  __syncthreads();
  uint32_t x = kAll;  // no env: the identity of the AND
  if (active) x = bit_rows::pack_row(span, d + t.seg * hw + t.lane * width, width);
  int k;
  const uint32_t cleared = bit_rows::clear_segment(x, active, t, height, width, region_size, k);
  if (active) {
    rows[t.seg * height + t.lane] = cleared;
    if (t.lane == 0) k_out[first + t.seg] = k;
  }
  __syncthreads();
  bit_rows::store_rows(rows, board_out + lo, count * hw, width);
}

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

// board (N, HW) u8 of 0/1 cells; outputs board_out (N, HW) u8 (16-byte
// aligned) and k (N,) i32.  region_size 0 means no region clear.  per_warp
// = 32 / H envs a warp, warps a block such that warps * per_warp * H * W is
// a multiple of 16; H <= 32, W <= 32.
extern "C" int bp_clear_rows(const void* board, void* board_out, void* k_out,
                             int n, int height, int width, int region_size,
                             int per_warp, int warps, void* stream) {
  if (height < 1 || height > 32 || per_warp != 32 / height || width < 1 ||
      width > 32 || region_size < 0 || region_size > 32 || warps < 1 ||
      warps > bit_rows::kMaxWarps || (warps * per_warp * height * width) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(board_out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int per_block = warps * per_warp;
    const int blocks = (n + per_block - 1) / per_block;
    const int smem = bit_rows::smem_bytes(
        per_block * height, static_cast<long long>(per_block) * height * width);
    clear_rows_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(board), static_cast<uint8_t*>(board_out),
        static_cast<int32_t*>(k_out), n, height, width, region_size, per_warp);
  }
  return static_cast<int>(cudaGetLastError());
}

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
