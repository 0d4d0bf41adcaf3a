// Simultaneous line clear: the CUDA port of the TPU kernel `_clear_kernel`
// (blockpuzzle_tpu/kernels/clear.py:79, launched by `_clear_pallas_call`,
// clear.py:93, from `ClearScanKernel.__call__`).  Five kernels: the
// bit-row kernel (`clear_rows_kernel`, entry `bp_clear_rows`) for boards
// with H <= 32 and W <= 32, every shipped preset; the wide kernel
// (`clear_wide_kernel`, entry `bp_clear_wide`), the bit-row kernel on rows
// of NW = 2..4 words, for H <= 32 and 32 < W <= 128; the tall kernel
// (`clear_tall_kernel`, entry `bp_clear_tall`), a warp an env, for
// 32 < H <= 128 and W <= 128; the deep kernel (`clear_deep_kernel`, entry
// `bp_clear_deep`), a warp an env walking the board in windows of 32 rows,
// for H > 128 and W <= 128 wherever a block of one warp fits the shared
// memory a block may opt in to; and the general kernel (`clear_kernel`,
// entry `bp_clear`) for what is left: rows of more than 128 cells, or a
// deep board too large for one warp.  The wrapper (kernels/clear.py) picks
// one by shape.
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
// The wide kernel takes the same 0/1 boards and is the same on a row held
// as NW 32-bit words, NW a template parameter: NW packs a row
// (`pack_row`), a row full when every word equals its column mask (one
// ballot), columns by one `__reduce_and_sync` a word, regions by band
// shuffles a word and fields read from funnel-shifted word pairs, where a
// field may straddle two words (`clear_words`, bit_rows.cuh); cleared rows
// staged as NW words and stored as 16-byte vectors (`store_words`).  It
// answers what bounded the general kernel on such boards: a warp an env
// loading its bytes one a lane, one lane a line walking the line's cells
// through the global table, two dependent loads a cell (48 lines of up to
// 40 cells in two rounds on 8x40, 16 lanes idle in the second), and a
// byte-by-byte clear and store.  A block that needs more than 48 KB of
// shared memory opts in to it.
//
// The tall kernel takes the same 0/1 boards of 33 to 128 rows: one warp an
// env, lane l holding rows l + 32 j in slot j < NR = ceil(H / 32) as NW
// words each (NR, NW template parameters), rows past the bottom all ones
// (`bit_rows::clear_tall`): full rows by a ballot a slot, columns by
// ANDing a lane's slots and one `__reduce_and_sync` a word, regions by
// ANDing each row with the rs - 1 rows below it (`rows_below`, across the
// seam from slot j + 1), a band's first row testing its fields and every
// row taking them back from its first row, r % rs rows up; cleared rows
// staged and stored from the block's byte offset (`store_tall`).  It
// answers what bounded the general kernel there: a lane a line walking the
// line's cells through the global table (75 lines of up to 33 cells on
// 33x9), byte loads and stores.
//
// The deep kernel carries the tall kernel to boards of more than 128 rows,
// where its register slots run out: one warp an env walks the board in
// windows of 32 rows, or of 32 - 32 mod rs with regions of size rs, so that
// every window starts on a multiple of rs and no region band crosses a
// window (the bands start at multiples of rs; only whole ones count), lane
// l holding row w0 + l of the window as NW words (NW a template parameter)
// and lanes from the window's size on holding none.  Pass 1, per window:
// full rows by one ballot, each band's AND by rs shuffles from its lanes
// and its fields tested by every row of it (`bit_rows::full_fields`), the
// full tiles counted by the band's first row, every row staged in shared
// memory with its full row and tiles cleared, and the row ANDed into a
// lane's column words; after the last window one `__reduce_and_sync` a word
// gives the full columns (rows past the bottom are the AND's identity) and
// k.  Pass 2 clears the full columns from the staged rows, and the block
// stores them from its byte offset (`store_tall`).  The block's boards are
// staged whole, as in the tall kernel, and its warps and turns are the deep
// mask's (`kernels/packed.py` `deep_launch_shape`, whose shared memory is
// at least this kernel's); a block above 48 KB opts in.  It answers what
// bounded the general kernel on such boards: a lane a line walking the
// line's cells through the global table (138 lines, the 8 columns of 130
// cells, on 130x8), two dependent loads a cell, byte loads and stores.
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
constexpr long long kSmemOptIn = 227 * 1024;  // shared memory a block may opt in to
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

template <int NW>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    clear_wide_kernel(const uint8_t* __restrict__ board,
                      uint8_t* __restrict__ board_out,
                      int32_t* __restrict__ k_out, int n, int height,
                      int width, int region_size, int per_warp) {
  extern __shared__ __align__(16) uint8_t rows_smem[];
  const int per_block = blockDim.x / 32 * per_warp;
  uint32_t* rows = reinterpret_cast<uint32_t*>(rows_smem);  // E*H cleared rows of NW words
  uint8_t* span = bit_rows::staged_span(rows_smem, per_block * height * NW);
  const int hw = height * width;
  const int first = blockIdx.x * per_block;          // first env
  const int count = min(per_block, n - first);       // envs here
  const long long lo = static_cast<long long>(first) * hw;
  const int d = bit_rows::stage_bytes(board, lo, lo + static_cast<long long>(count) * hw, span);

  const bit_rows::Seat t = bit_rows::seat(height, per_warp);
  const bool active = t.s < per_warp && t.seg < count;
  __syncthreads();
  uint32_t x[NW];  // no env: the identity of the AND
#pragma unroll
  for (int i = 0; i < NW; ++i) x[i] = kAll;
  if (active) {
    const int at = d + t.seg * hw + t.lane * width;
#pragma unroll
    for (int i = 0; i + 1 < NW; ++i) x[i] = bit_rows::pack_row(span, at + 32 * i, 32);
    x[NW - 1] = bit_rows::pack_row(span, at + 32 * (NW - 1), width - 32 * (NW - 1));
  }
  int k;
  bit_rows::clear_words<NW>(x, active, t, height, width, region_size, k);
  if (active) {
#pragma unroll
    for (int i = 0; i < NW; ++i) rows[(t.seg * height + t.lane) * NW + i] = x[i];
    if (t.lane == 0) k_out[first + t.seg] = k;
  }
  __syncthreads();
  bit_rows::store_words<NW>(rows, board_out + lo, count * hw, width);
}

template <int NW>
int launch_clear_wide(const void* board, void* board_out, void* k_out, int n, int height,
                      int width, int region_size, int per_warp, int warps,
                      cudaStream_t stream) {
  const int per_block = warps * per_warp;
  const int blocks = (n + per_block - 1) / per_block;
  const int smem = bit_rows::smem_bytes(per_block * height * NW,
                                        static_cast<long long>(per_block) * height * width);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        clear_wide_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  clear_wide_kernel<NW><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const uint8_t*>(board), static_cast<uint8_t*>(board_out),
      static_cast<int32_t*>(k_out), n, height, width, region_size, per_warp);
  return static_cast<int>(cudaGetLastError());
}

template <int NR, int NW>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    clear_tall_kernel(const uint8_t* __restrict__ board,
                      uint8_t* __restrict__ board_out,
                      int32_t* __restrict__ k_out, int n, int height,
                      int width, int region_size, int per_warp) {
  extern __shared__ __align__(16) uint8_t rows_smem[];
  const int warps = blockDim.x / 32;
  const int per_block = warps * per_warp;            // envs: per_warp a warp
  uint32_t* rows = reinterpret_cast<uint32_t*>(rows_smem);  // E*H cleared rows of NW words
  uint8_t* span = bit_rows::staged_span(rows_smem, per_block * height * NW);
  const int hw = height * width;
  const int first = blockIdx.x * per_block;          // first env
  const int count = min(per_block, n - first);       // envs here
  const long long lo = static_cast<long long>(first) * hw;
  const int d = bit_rows::stage_bytes(board, lo, lo + static_cast<long long>(count) * hw, span);

  const int l = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  __syncthreads();
  for (int it = 0; it < per_warp; ++it) {
    const int seg = it * warps + warp;               // env in the block
    const bool active = seg < count;
    uint32_t x[NR][NW];  // slot j: row l + 32 j; no row: the identity of the AND
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int r = l + 32 * j;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        x[j][i] = active && r < height
                      ? bit_rows::pack_row(span, d + seg * hw + r * width + 32 * i,
                                           min(32, width - 32 * i))
                      : kAll;
      }
    }
    int k;
    bit_rows::clear_tall<NR, NW>(x, active, height, width, region_size, k);
    if (active) {
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int r = l + 32 * j;
        if (r < height) {
#pragma unroll
          for (int i = 0; i < NW; ++i) rows[(seg * height + r) * NW + i] = x[j][i];
        }
      }
      if (l == 0) k_out[first + seg] = k;
    }
  }
  __syncthreads();
  bit_rows::store_tall<NW>(rows, board_out, lo, count * hw, width);
}

template <int NR, int NW>
int launch_clear_tall(const void* board, void* board_out, void* k_out, int n, int height,
                      int width, int region_size, int per_warp, int warps,
                      cudaStream_t stream) {
  const int per_block = warps * per_warp;
  const int blocks = (n + per_block - 1) / per_block;
  const int smem = bit_rows::smem_bytes(per_block * height * NW,
                                        static_cast<long long>(per_block) * height * width);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        clear_tall_kernel<NR, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  clear_tall_kernel<NR, NW><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const uint8_t*>(board), static_cast<uint8_t*>(board_out),
      static_cast<int32_t*>(k_out), n, height, width, region_size, per_warp);
  return static_cast<int>(cudaGetLastError());
}

template <int NR>
int launch_clear_tall_rows(const void* board, void* board_out, void* k_out, int n,
                           int height, int width, int region_size, int per_warp,
                           int warps, cudaStream_t stream) {
  switch ((width + 31) / 32) {
    case 1:
      return launch_clear_tall<NR, 1>(board, board_out, k_out, n, height, width, region_size,
                                      per_warp, warps, stream);
    case 2:
      return launch_clear_tall<NR, 2>(board, board_out, k_out, n, height, width, region_size,
                                      per_warp, warps, stream);
    case 3:
      return launch_clear_tall<NR, 3>(board, board_out, k_out, n, height, width, region_size,
                                      per_warp, warps, stream);
    default:
      return launch_clear_tall<NR, 4>(board, board_out, k_out, n, height, width, region_size,
                                      per_warp, warps, stream);
  }
}

template <int NW>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    clear_deep_kernel(const uint8_t* __restrict__ board,
                      uint8_t* __restrict__ board_out,
                      int32_t* __restrict__ k_out, int n, int height,
                      int width, int region_size, int per_warp) {
  extern __shared__ __align__(16) uint8_t rows_smem[];
  const int warps = blockDim.x / 32;
  const int per_block = warps * per_warp;            // envs: per_warp a warp
  uint32_t* rows = reinterpret_cast<uint32_t*>(rows_smem);  // E*H cleared rows of NW words
  uint8_t* span = bit_rows::staged_span(rows_smem, per_block * height * NW);
  const int hw = height * width;
  const int first = blockIdx.x * per_block;          // first env
  const int count = min(per_block, n - first);       // envs here
  const long long lo = static_cast<long long>(first) * hw;
  const int d = bit_rows::stage_bytes(board, lo, lo + static_cast<long long>(count) * hw, span);

  const int l = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tail = width - 32 * (NW - 1);            // columns of the top word: 1..32
  const uint32_t top = tail < 32 ? (1u << tail) - 1u : kAll;
  // rows a window: a whole number of region bands; lanes from win on hold none
  const int win = region_size > 0 ? 32 - 32 % region_size : 32;
  const int e = region_size > 0 ? l % region_size : 0;  // row - its band's first row
  __syncthreads();
  for (int it = 0; it < per_warp; ++it) {
    const int seg = it * warps + warp;               // env in the block
    if (seg >= count) break;                         // the whole warp
    const int at = d + seg * hw;                     // the board's first byte in the span
    uint32_t* cleared = rows + seg * height * NW;
    // pass 1: full rows, bands and their tiles a window, each row staged
    // with them cleared; the column AND a lane
    uint32_t cols[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) cols[i] = kAll;
    int k = 0, tiles = 0;
    for (int w0 = 0; w0 < height; w0 += win) {
      const int r = w0 + l;
      const bool in = l < win && r < height;
      uint32_t x[NW];  // no row: the identity of the AND
      bool full = true;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        x[i] = in ? bit_rows::pack_row(span, at + r * width + 32 * i, min(32, width - 32 * i))
                  : kAll;
        full &= x[i] == (i + 1 < NW ? kAll : top);
        cols[i] &= x[i];
      }
      k += __popc(__ballot_sync(kAll, in && full));
      uint32_t reg[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) reg[i] = 0;
      if (region_size > 0) {
        uint32_t band[NW];  // rows r - e .. r - e + rs - 1, all in this window
#pragma unroll
        for (int i = 0; i < NW; ++i) band[i] = kAll;
        for (int t = 0; t < region_size; ++t) {
          const int src = in ? l - e + t : l;
#pragma unroll
          for (int i = 0; i < NW; ++i) band[i] &= __shfl_sync(kAll, x[i], src);
        }
        if (in && r - e + region_size <= height) {  // a whole band on the board
          const int got = bit_rows::full_fields<NW>(band, width, region_size, reg);
          tiles += e == 0 ? got : 0;
        }
      }
      if (in) {
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          cleared[r * NW + i] = x[i] & ~((full ? (i + 1 < NW ? kAll : top) : 0u) | reg[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      cols[i] = __reduce_and_sync(kAll, cols[i]);
      k += __popc(cols[i]);
    }
    k += __reduce_add_sync(kAll, tiles);
    if (l == 0) k_out[first + seg] = k;
    // pass 2: the full columns, cleared from the staged rows
    __syncwarp();
    for (int r = l; r < height; r += 32) {
#pragma unroll
      for (int i = 0; i < NW; ++i) cleared[r * NW + i] &= ~cols[i];
    }
  }
  __syncthreads();
  bit_rows::store_tall<NW>(rows, board_out, lo, count * hw, width);
}

// The deep kernel's launch: a block of `warps` warps taking `per_warp`
// envs each, its boards staged whole; refused where its shared memory
// passes what a block may opt in to.
template <int NW>
int launch_clear_deep(const void* board, void* board_out, void* k_out, int n, int height,
                      int width, int region_size, int per_warp, int warps,
                      cudaStream_t stream) {
  const int per_block = warps * per_warp;
  const int blocks = (n + per_block - 1) / per_block;
  const long long smem = (4LL * per_block * height * NW + 15) / 16 * 16 +
                         static_cast<long long>(per_block) * height * width + 32;
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        clear_deep_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  clear_deep_kernel<NW><<<blocks, warps * 32, static_cast<int>(smem), stream>>>(
      static_cast<const uint8_t*>(board), static_cast<uint8_t*>(board_out),
      static_cast<int32_t*>(k_out), n, height, width, region_size, per_warp);
  return static_cast<int>(cudaGetLastError());
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

// As bp_clear_rows, for 32 < W <= 128: rows of NW = ceil(W / 32) words.
extern "C" int bp_clear_wide(const void* board, void* board_out, void* k_out,
                             int n, int height, int width, int region_size,
                             int per_warp, int warps, void* stream) {
  if (height < 1 || height > 32 || per_warp != 32 / height || width <= 32 ||
      width > 128 || region_size < 0 || region_size > 32 || warps < 1 ||
      warps > bit_rows::kMaxWarps || (warps * per_warp * height * width) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(board_out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((width + 31) / 32) {
    case 2:
      return launch_clear_wide<2>(board, board_out, k_out, n, height, width, region_size,
                                  per_warp, warps, st);
    case 3:
      return launch_clear_wide<3>(board, board_out, k_out, n, height, width, region_size,
                                  per_warp, warps, st);
    default:
      return launch_clear_wide<4>(board, board_out, k_out, n, height, width, region_size,
                                  per_warp, warps, st);
  }
}

// As bp_clear_rows, for 32 < H <= 128 and W <= 128: one env a warp at a
// time, lane l holding rows l + 32 j (j < NR = ceil(H / 32)) of NW =
// ceil(W / 32) words; per_warp (1 to 4) envs a warp in turn, from the one
// staged span of the block's warps * per_warp envs; any count of warps from
// 1 to 16.
extern "C" int bp_clear_tall(const void* board, void* board_out, void* k_out,
                             int n, int height, int width, int region_size,
                             int per_warp, int warps, void* stream) {
  if (height <= 32 || height > 128 || width < 1 || width > 128 || region_size < 0 ||
      region_size > 32 || warps < 1 || warps > bit_rows::kMaxWarps || per_warp < 1 ||
      per_warp > 4 ||
      (reinterpret_cast<uintptr_t>(board_out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((height + 31) / 32) {
    case 2:
      return launch_clear_tall_rows<2>(board, board_out, k_out, n, height, width,
                                       region_size, per_warp, warps, st);
    case 3:
      return launch_clear_tall_rows<3>(board, board_out, k_out, n, height, width,
                                       region_size, per_warp, warps, st);
    default:
      return launch_clear_tall_rows<4>(board, board_out, k_out, n, height, width,
                                       region_size, per_warp, warps, st);
  }
}

// As bp_clear_tall, for H > 128 and W <= 128: one env a warp at a time,
// walking its board in windows of 32 rows (32 - 32 mod rs with regions of
// size rs), lane l holding row w0 + l of the window as NW = ceil(W / 32)
// words; per_warp (1 to 4) envs a warp in turn, warps 1 to 16; refused
// where the block's shared memory (its cleared rows and its staged boards)
// passes what a block may opt in to.
extern "C" int bp_clear_deep(const void* board, void* board_out, void* k_out,
                             int n, int height, int width, int region_size,
                             int per_warp, int warps, void* stream) {
  if (height <= 128 || width < 1 || width > 128 || region_size < 0 || region_size > 32 ||
      warps < 1 || warps > bit_rows::kMaxWarps || per_warp < 1 || per_warp > 4 ||
      (reinterpret_cast<uintptr_t>(board_out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((width + 31) / 32) {
    case 1:
      return launch_clear_deep<1>(board, board_out, k_out, n, height, width, region_size,
                                  per_warp, warps, st);
    case 2:
      return launch_clear_deep<2>(board, board_out, k_out, n, height, width, region_size,
                                  per_warp, warps, st);
    case 3:
      return launch_clear_deep<3>(board, board_out, k_out, n, height, width, region_size,
                                  per_warp, warps, st);
    default:
      return launch_clear_deep<4>(board, board_out, k_out, n, height, width, region_size,
                                  per_warp, warps, st);
  }
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
