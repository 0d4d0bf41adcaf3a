// Chosen-action apply: the CUDA port of the TPU kernel `_apply_kernel`
// (blockpuzzle_tpu/kernels/collision.py:120, launched by
// `_apply_pallas_call`, collision.py:164, from `ApplyKernel.__call__`).  Two
// kernels here: the bit-row kernel (`apply_rows_kernel`, entry
// `bp_apply_rows`) for boards with H <= 32 and W <= 32, every shipped
// preset, and the general kernel (`apply_kernel`, entry `bp_apply`) for rows
// of more than 4096 cells and deep or xwide boards one warp cannot
// stage.  The boards between
// take the apply instances of the clear's wide, tall, deep and xwide
// kernels (clear.cu: `bp_apply_wide`, `bp_apply_tall`, `bp_apply_deep`,
// `bp_apply_xwide`).
// The wrapper (kernels/collision.py) picks one by shape.
//
// What both compute, per env: the action is legal iff `valid` and the
// footprint `cover` overlaps no occupied cell.  A legal action places the
// footprint, finds every full row, column and region on the placed board,
// clears them all at once and reports k = their number.  An illegal action
// is a strict no-op with k = 0, even on a board that already holds a full
// line.  The TPU formulation -- line-mask matmuls in bf16 and ones-matrix
// products that spread per-row scalars across lanes -- exists for Mosaic's
// layout rules and is not carried over.
//
// Bound on the H100: device memory.  Per env it reads HW board bytes, HW
// cover bytes and 1 valid byte and writes HW board bytes, a 4-byte k and a
// 1-byte legal flag: 306 B on the default preset (HW = 100), 15.0 MB at
// N = 49152, ~4.5 us at 3.35 TB/s.
//
// The bit-row kernel holds boards and covers to the engine's invariant:
// every cell is 0 or 1 (env/state.py; rules.tables_for(cfg).cover).  The TPU
// kernel tests `board & cover` byte by byte and sums bytes along a line; on
// 0/1 cells these are the tests here on row words (bit c = byte != 0), and
// the output cells are the bits of the output words.  (With a cover byte of
// 2 over a board byte of 1, `board & cover` is 0 for the TPU kernel and an
// overlap here.)  The general kernel keeps the bytes.  The design carries
// the bit-row clear (clear.cu) and B1 (packed_apply.cu) to u8 boards:
//   - one segment of H lanes per env, lane r holding row r of the board and
//     of the cover as words, 32 / H segments a warp, instead of a warp per
//     env making four passes of byte loads over board and cover and walking
//     each line's cells through a global index table;
//   - a block of `warps` warps covers E envs with E*H*W a multiple of 16
//     (`mask_block_warps`): it stages both spans, the boards' and the
//     covers', in shared memory with 16-byte loads (`stage_bytes`; each span
//     keeps its own offset from a 16-byte boundary, so any two start
//     addresses work), and each lane packs one word from each (`pack_row`);
//   - overlap by a ballot of `(x & y) != 0` over the segment, `valid` one
//     byte per env read by the segment's lanes: legal is uniform over the
//     segment;
//   - the placed word `x | y` goes through `clear_segment` (bit_rows.cuh,
//     shared with the clear kernel); a legal env keeps the cleared word and
//     k, an illegal one its input word `x` and k = 0;
//   - the output words, staged in shared memory, leave as 16-byte vectors of
//     0/1 bytes (`store_rows`); k and legal by lane 0 of each segment.
// Every lane runs every ballot, shuffle, reduction and barrier, on the
// ragged tail and in the left-over lanes too.
//
// The general kernel: one warp per env, four envs per block, any N (a warp
// past the last env exits as a whole), opted in above 48 KB of shared
// memory; fewer warps where four warps' hw + L bytes pass what a block may
// opt in to (`general_warps`, clear_lines.cuh, as the general clear).
// Lanes stride the HW cells, so the board and cover loads and the board
// store are coalesced; the overlap test
// is one warp vote; the placed board sits in shared memory while
// `clear_full_lines` (clear_lines.cuh) scans the L lines, one lane per
// line.  The line table (<= 32 lines of <= 16 int32 on the shipped presets)
// is read by every warp and stays in L1.

#include <cstdint>
#include <cuda_runtime.h>

#include "bit_rows.cuh"
#include "clear_lines.cuh"

namespace {

using bit_rows::kAll;

__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    apply_rows_kernel(const uint8_t* __restrict__ board,
                      const uint8_t* __restrict__ cover,
                      const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ board_out,
                      int32_t* __restrict__ k_out,
                      uint8_t* __restrict__ legal_out, int n, int height,
                      int width, int region_size, int per_warp) {
  extern __shared__ __align__(16) uint8_t rows_smem[];
  const int per_block = blockDim.x / 32 * per_warp;
  const int hw = height * width;
  uint32_t* rows = reinterpret_cast<uint32_t*>(rows_smem);  // E*H output words
  uint8_t* boards = bit_rows::staged_span(rows_smem, per_block * height);
  uint8_t* covers = boards + bit_rows::span_stride(static_cast<long long>(per_block) * hw);
  const int first = blockIdx.x * per_block;          // first env
  const int count = min(per_block, n - first);       // envs here
  const long long lo = static_cast<long long>(first) * hw;
  const long long hi = lo + static_cast<long long>(count) * hw;
  const int db = bit_rows::stage_bytes(board, lo, hi, boards);
  const int dc = bit_rows::stage_bytes(cover, lo, hi, covers);

  const bit_rows::Seat t = bit_rows::seat(height, per_warp);
  const bool active = t.s < per_warp && t.seg < count;
  const bool ok = active && valid[first + t.seg] != 0;
  __syncthreads();
  uint32_t x = 0, y = 0;
  if (active) {
    const int at = t.seg * hw + t.lane * width;
    x = bit_rows::pack_row(boards, db + at, width);
    y = bit_rows::pack_row(covers, dc + at, width);
  }
  const unsigned overlap = __ballot_sync(kAll, (x & y) != 0) & t.mask;
  const bool legal = ok && overlap == 0;             // uniform over the segment
  int k;
  // no env: the identity of the AND
  const uint32_t cleared = bit_rows::clear_segment(active ? x | y : kAll, active, t, height,
                                                   width, region_size, k);
  if (active) {
    rows[t.seg * height + t.lane] = legal ? cleared : x;
    if (t.lane == 0) {
      k_out[first + t.seg] = legal ? k : 0;
      legal_out[first + t.seg] = legal;
    }
  }
  __syncthreads();
  bit_rows::store_rows(rows, board_out + lo, count * hw, width);
}

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
  const long long env = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp;
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

// board, cover (N, HW) u8 of 0/1 cells; valid (N,) bool; outputs board_out
// (N, HW) u8 (16-byte aligned), k (N,) i32, legal (N,) bool.  region_size 0
// means no region clear.  per_warp = 32 / H envs a warp, warps a block such
// that warps * per_warp * H * W is a multiple of 16; H <= 32, W <= 32.
extern "C" int bp_apply_rows(const void* board, const void* cover,
                             const void* valid, void* board_out, void* k_out,
                             void* legal_out, int n, int height, int width,
                             int region_size, int per_warp, int warps,
                             void* stream) {
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
        per_block * height, static_cast<long long>(per_block) * height * width, 2);
    apply_rows_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(board), static_cast<const uint8_t*>(cover),
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(board_out),
        static_cast<int32_t*>(k_out), static_cast<uint8_t*>(legal_out), n, height,
        width, region_size, per_warp);
  }
  return static_cast<int>(cudaGetLastError());
}

// board, cover (N, HW) u8; valid (N,) bool; line_cells (L, max_len) i32 and
// line_len (L,) i32; outputs board_out (N, HW) u8, k (N,) i32, legal (N,)
// bool.  Refused where one warp's hw + L bytes pass what a block may opt in
// to.
extern "C" int bp_apply(const void* board, const void* cover,
                        const void* valid, const void* line_cells,
                        const void* line_len, void* board_out, void* k_out,
                        void* legal_out, int n, int hw, int num_lines,
                        int max_len, void* stream) {
  const int warps = general_warps(hw, num_lines);
  if (n <= 0) return static_cast<int>(warps < 1 ? cudaErrorInvalidValue : cudaGetLastError());
  return launch_general(apply_kernel, n, warps, hw, num_lines,
                        static_cast<cudaStream_t>(stream),
                        static_cast<const uint8_t*>(board), static_cast<const uint8_t*>(cover),
                        static_cast<const uint8_t*>(valid),
                        static_cast<const int32_t*>(line_cells),
                        static_cast<const int32_t*>(line_len),
                        static_cast<uint8_t*>(board_out), static_cast<int32_t*>(k_out),
                        static_cast<uint8_t*>(legal_out), n, hw, num_lines, max_len);
}
