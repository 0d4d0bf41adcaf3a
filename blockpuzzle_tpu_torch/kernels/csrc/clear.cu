// Simultaneous line clear: the CUDA port of the TPU kernel `_clear_kernel`
// (blockpuzzle_tpu/kernels/clear.py:79, launched by `_clear_pallas_call`,
// clear.py:93, from `ClearScanKernel.__call__`).  Six kernels: the
// bit-row kernel (`clear_rows_kernel`, entry `bp_clear_rows`) for boards
// with H <= 32 and W <= 32, every shipped preset; the wide kernel
// (`clear_wide_kernel`, entry `bp_clear_wide`), the bit-row kernel on rows
// of NW = 2..4 words, for H <= 32 and 32 < W <= 128; the tall kernel
// (`clear_tall_kernel`, entry `bp_clear_tall`), a warp an env, for
// 32 < H <= 128 and W <= 128; the deep kernel (`clear_deep_kernel`, entry
// `bp_clear_deep`), a warp an env walking the board in windows of 32 rows,
// for H > 128 and W <= 128 wherever a block of one warp fits the shared
// memory a block may opt in to; the xwide kernel (`clear_xwide_kernel`,
// entry `bp_clear_xwide`), a segment of lanes an env and a lane a word of
// every row, for 128 < W <= 1024 and any height wherever a block of one
// warp fits, and on rows of 1025 to 4096 cells one env a warp, lane l
// holding words l + 32 j; and the general kernel (`clear_kernel`, entry
// `bp_clear`) for what is left: rows of more than 4096 cells, or a deep or
// xwide board too large for one warp.  The wrapper (kernels/clear.py)
// picks one by shape.  The wide, tall, deep and xwide kernels are also the
// apply (K2, the TPU kernel `_apply_kernel`,
// blockpuzzle_tpu/kernels/collision.py:120) on those boards: a second instance of each (`kApply`, entries
// `bp_apply_wide`, `bp_apply_tall`, `bp_apply_deep`, `bp_apply_xwide`; the
// wrapper kernels/collision.py `ApplyKernel`), described above the kernels.
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
// The xwide kernel takes the same 0/1 boards of 129 to 1024 cells a row
// and any height, where a row's words no longer fit a lane: a segment of
// NW = ceil(W / 32) lanes an env (6 segments a warp on 8x136), lane w
// holding word w of every row, loaded by the block as 16-byte vectors
// straight into row words in shared memory (`bit_rows::stage_words`, no
// staged copy of the bytes).  Pass 1 is lane-local: the AND of the lane's
// rows is its word of the full columns.  Pass 2 walks the board in windows
// of 32 rows, or of 32 - 32 mod rs with regions of size rs, so that no
// region band crosses a window (the deep kernel's windows): bit i of a
// lane's word marks row w0 + i's word full (the top word's bits past W
// count as set), and one `__reduce_and_sync` over the segment gives the
// window's full rows (a board of one window, at most 32 rows, marks them
// in pass 1 and takes one pass 2 over its rows: the kWindows form below).
// In each window
// it walks the rows a band of rs at a time (a row at a time without
// regions): the band's AND, lane-local; its full rs-bit fields read from the
// funnel-shifted pair (this word, the next lane's, one `__shfl_down_sync`),
// since a field may straddle two words (rs = 3: columns 30..32, 63..65),
// the part of a full field past this word handed up by one
// `__shfl_up_sync`; then each row cleared in place (all of it if full,
// else its full columns and fields).  k = the full rows of every window +
// one `__reduce_add_sync` of each word's full columns and of the fields
// that start in it; lane 0 writes it.  The block stores as the mask's xwide
// kernel (`store_words_n`).  It answers what bounded the general kernel
// there: a warp an env whose lanes walk the 144 lines of 8x136 through the
// global table, a dependent index load a cell, the 8 row lanes 136 cells
// each and the column lanes 8, and a byte store a cell.
//
// Rows of 1025 to 4096 cells (NW = 33 to 128 words) pass a warp's 32
// lanes: the same kernel with NJ = ceil(NW / 32) slots a lane (a template
// parameter; NJ = 1 is the segment form above), one env a warp, lane l
// holding words l + 32 j of every row in slot j.  The words are strided,
// not NJ consecutive words a lane, so that every lane works: 33 words take
// all 32 lanes and only the last slot is ragged (a slot past NW holds no
// word: the identity of the full-row AND, no full column, no field),
// where consecutive pairs would take 17 lanes and leave 15 idle.  A lane's
// full-row bit is the AND over its slots (the top word's pad bits belong to
// word NW - 1, whichever lane holds it), one `__reduce_and_sync` over the
// warp still gives the rows, and k adds the popcounts of the slots' full
// columns in the one `__reduce_add_sync`.  The next word of slot j's word
// is the next lane's slot j, but lane 0's slot j + 1 for lane 31
// (`band_fields`).  It answers what bounded the general kernel there, as
// on 8x136: a lane a line walking the line's cells through the global
// table (1058 lines on 2x1056), byte loads and stores.
//
// The apply instances take the same 0/1 boards and 0/1 covers.  Bound on
// the H100: device memory; per env they read HW board bytes, HW cover
// bytes and a valid byte and write HW board bytes, a 4-byte k and a legal
// byte, 3 HW + 6 bytes: 47.5 MB on 8x40, 44.1 MB on 33x9, 153.6 MB on
// 130x8, 160.7 MB on 8x136 and 802.5 MB on 40x136 at N = 49152 (14.2,
// 13.2, 45.9, 48.0 and 239.5 us at 3.35 TB/s).  The wide, tall and deep
// instances' block holds its output rows and two staged spans, so its
// launch shape is its own (kernels/packed.py `apply_launch_shape`: the
// clear's where both spans fit, fewer turns or warps where not); the xwide
// instance's holds two arrays of row words (board and cover) on a board of
// one window and the placed rows and a word an env above, and takes one
// warp a block there (`xwide_apply_smem_bytes`, `apply_launch_shape`).
// Each lane packs a cover word beside each board word (an xwide lane packs
// none: its block loads the covers as it loads the boards, or ORs them
// over the boards); the deep instance's first pass
// stages the placed rows and its pass 1 reads them back instead of
// packing.  They answer what bounded the general apply on such boards: the
// clear's line walk through the global table (a lane a line, two dependent
// loads a cell; 144 lines on 8x136) after byte loads of both boards and
// before a byte store.
//
// The general kernel: one warp per env, four envs per block, any N (a warp
// past the last env exits as a whole, before any warp collective), opted
// in above 48 KB of shared memory; fewer warps where four warps' boards
// and line flags (hw + L bytes each) pass what a block may opt in to,
// refused only where one warp's do (`general_warps`, clear_lines.cuh).  Lanes
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

// The wide, tall and deep kernels have two instances each: the clear
// (kApply false: `cover`, `valid` and `legal_out` unused) and the apply
// (kApply true), whose block stages its envs' cover span beside their
// board span, each at its own offset from a 16-byte boundary, places each
// row's cover word on its board word and runs the same clear on the placed
// rows.  The apply's env is legal when `valid` is set and no word of it
// overlaps: one ballot over its lanes (wide: the segment; tall: every
// slot; deep: a first pass over its rows that stages the placed rows, so
// that legality is known before pass 1).  A legal env keeps the cleared
// rows and k, an illegal one its input rows and k = 0: a strict no-op, even
// over a board holding a full line.  The wide instance keeps each lane's
// input words beside the placed ones (the segments of a warp differ in
// legality, and every lane runs the clear); in the tall and deep instances,
// whose warp holds one env at a time, an illegal env's warp skips the clear
// (the deep one packs its input rows again: its first pass staged the
// placed ones).
template <int NW, bool kApply>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    clear_wide_kernel(const uint8_t* __restrict__ board, const uint8_t* __restrict__ cover,
                      const uint8_t* __restrict__ valid, uint8_t* __restrict__ board_out,
                      int32_t* __restrict__ k_out, uint8_t* __restrict__ legal_out, int n,
                      int height, int width, int region_size, int per_warp) {
  extern __shared__ __align__(16) uint8_t rows_smem[];
  const int per_block = blockDim.x / 32 * per_warp;
  const int hw = height * width;
  uint32_t* rows = reinterpret_cast<uint32_t*>(rows_smem);  // E*H output rows of NW words
  uint8_t* span = bit_rows::staged_span(rows_smem, per_block * height * NW);
  uint8_t* covers = span + bit_rows::span_stride(static_cast<long long>(per_block) * hw);
  const int first = blockIdx.x * per_block;          // first env
  const int count = min(per_block, n - first);       // envs here
  const long long lo = static_cast<long long>(first) * hw;
  const long long hi = lo + static_cast<long long>(count) * hw;
  const int d = bit_rows::stage_bytes(board, lo, hi, span);
  const int dc = kApply ? bit_rows::stage_bytes(cover, lo, hi, covers) : 0;

  const bit_rows::Seat t = bit_rows::seat(height, per_warp);
  const bool active = t.s < per_warp && t.seg < count;
  const bool ok = !kApply || (active && valid[first + t.seg] != 0);
  const int at = t.seg * hw + t.lane * width;        // the row's first byte in a span
  __syncthreads();
  uint32_t x[NW];  // the input row; no env: the identity of the AND
#pragma unroll
  for (int i = 0; i < NW; ++i) x[i] = kAll;
  if (active) bit_rows::pack_words<NW>(span, d + at, width, x);
  uint32_t p[NW];  // the row the clear takes: the input, or the apply's placed row
#pragma unroll
  for (int i = 0; i < NW; ++i) p[i] = x[i];
  bool legal = true;
  if constexpr (kApply) {  // the placed row x | y
    uint32_t y[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) y[i] = 0;
    if (active) bit_rows::pack_words<NW>(covers, dc + at, width, y);
    bool hit = false;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      hit |= (x[i] & y[i]) != 0;
      p[i] |= y[i];
    }
    const unsigned overlap = __ballot_sync(kAll, hit) & t.mask;  // every lane votes
    legal = ok && overlap == 0;                      // uniform over the segment
  }
  int k;
  bit_rows::clear_words<NW>(p, active, t, height, width, region_size, k);
  if (active) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {  // an illegal env keeps its input
      rows[(t.seg * height + t.lane) * NW + i] = legal ? p[i] : x[i];
    }
    if (t.lane == 0) {
      k_out[first + t.seg] = legal ? k : 0;
      if constexpr (kApply) legal_out[first + t.seg] = legal;
    }
  }
  __syncthreads();
  bit_rows::store_words<NW>(rows, board_out + lo, count * hw, width);
}

template <int NR, int NW, bool kApply>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    clear_tall_kernel(const uint8_t* __restrict__ board, const uint8_t* __restrict__ cover,
                      const uint8_t* __restrict__ valid, uint8_t* __restrict__ board_out,
                      int32_t* __restrict__ k_out, uint8_t* __restrict__ legal_out, int n,
                      int height, int width, int region_size, int per_warp) {
  extern __shared__ __align__(16) uint8_t rows_smem[];
  const int warps = blockDim.x / 32;
  const int per_block = warps * per_warp;            // envs: per_warp a warp
  const int hw = height * width;
  uint32_t* rows = reinterpret_cast<uint32_t*>(rows_smem);  // E*H output rows of NW words
  uint8_t* span = bit_rows::staged_span(rows_smem, per_block * height * NW);
  uint8_t* covers = span + bit_rows::span_stride(static_cast<long long>(per_block) * hw);
  const int first = blockIdx.x * per_block;          // first env
  const int count = min(per_block, n - first);       // envs here
  const long long lo = static_cast<long long>(first) * hw;
  const long long hi = lo + static_cast<long long>(count) * hw;
  const int d = bit_rows::stage_bytes(board, lo, hi, span);
  const int dc = kApply ? bit_rows::stage_bytes(cover, lo, hi, covers) : 0;

  const int l = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  __syncthreads();
  for (int it = 0; it < per_warp; ++it) {
    const int seg = it * warps + warp;               // env in the block
    const bool active = seg < count;
    uint32_t x[NR][NW];  // slot j: row l + 32 j; no row: the identity of the AND
    uint32_t y[NR][NW];  // the apply's cover words
    bool hit = false;    // a cover word meets a board word
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int r = l + 32 * j;
      const bool in = active && r < height;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const int at = seg * hw + r * width + 32 * i;
        const int cells = min(32, width - 32 * i);
        x[j][i] = in ? bit_rows::pack_row(span, d + at, cells) : kAll;
        if constexpr (kApply) {
          y[j][i] = in ? bit_rows::pack_row(covers, dc + at, cells) : 0u;
          hit |= (x[j][i] & y[j][i]) != 0;
        }
      }
    }
    bool legal = true;
    if constexpr (kApply) {  // uniform over the warp
      const bool overlap = __any_sync(kAll, hit);
      legal = active && !overlap && valid[first + seg] != 0;
    }
    int k = 0;
    if (legal) {  // the whole warp; an illegal env keeps its input rows, k = 0
      if constexpr (kApply) {
#pragma unroll
        for (int j = 0; j < NR; ++j) {
#pragma unroll
          for (int i = 0; i < NW; ++i) x[j][i] |= y[j][i];
        }
      }
      bit_rows::clear_tall<NR, NW>(x, active, height, width, region_size, k);
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int r = l + 32 * j;
        if (r < height) {
#pragma unroll
          for (int i = 0; i < NW; ++i) rows[(seg * height + r) * NW + i] = x[j][i];
        }
      }
      if (l == 0) {
        k_out[first + seg] = k;
        if constexpr (kApply) legal_out[first + seg] = legal;
      }
    }
  }
  __syncthreads();
  bit_rows::store_tall<NW>(rows, board_out, lo, count * hw, width);
}

template <int NW, bool kApply>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    clear_deep_kernel(const uint8_t* __restrict__ board, const uint8_t* __restrict__ cover,
                      const uint8_t* __restrict__ valid, uint8_t* __restrict__ board_out,
                      int32_t* __restrict__ k_out, uint8_t* __restrict__ legal_out, int n,
                      int height, int width, int region_size, int per_warp) {
  extern __shared__ __align__(16) uint8_t rows_smem[];
  const int warps = blockDim.x / 32;
  const int per_block = warps * per_warp;            // envs: per_warp a warp
  const int hw = height * width;
  uint32_t* rows = reinterpret_cast<uint32_t*>(rows_smem);  // E*H output rows of NW words
  uint8_t* span = bit_rows::staged_span(rows_smem, per_block * height * NW);
  uint8_t* covers = span + bit_rows::span_stride(static_cast<long long>(per_block) * hw);
  const int first = blockIdx.x * per_block;          // first env
  const int count = min(per_block, n - first);       // envs here
  const long long lo = static_cast<long long>(first) * hw;
  const long long hi = lo + static_cast<long long>(count) * hw;
  const int d = bit_rows::stage_bytes(board, lo, hi, span);
  const int dc = kApply ? bit_rows::stage_bytes(cover, lo, hi, covers) : 0;

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
    if constexpr (kApply) {
      // pass 0: the placed rows x | y staged, a row a lane; the overlap
      bool hit = false;
      for (int r = l; r < height; r += 32) {
        uint32_t x[NW], y[NW];
        bit_rows::pack_words<NW>(span, at + r * width, width, x);
        bit_rows::pack_words<NW>(covers, dc + seg * hw + r * width, width, y);
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          hit |= (x[i] & y[i]) != 0;
          cleared[r * NW + i] = x[i] | y[i];
        }
      }
      const bool overlap = __any_sync(kAll, hit);   // uniform over the warp
      if (overlap || valid[first + seg] == 0) {     // a strict no-op: the input again
        for (int r = l; r < height; r += 32) {
          uint32_t x[NW];
          bit_rows::pack_words<NW>(span, at + r * width, width, x);
#pragma unroll
          for (int i = 0; i < NW; ++i) cleared[r * NW + i] = x[i];
        }
        if (l == 0) {
          k_out[first + seg] = 0;
          legal_out[first + seg] = false;
        }
        continue;
      }
      __syncwarp();  // pass 1 reads rows that other lanes staged
    }
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
        x[i] = !in     ? kAll
               : kApply ? cleared[r * NW + i]
                        : bit_rows::pack_row(span, at + r * width + 32 * i,
                                             min(32, width - 32 * i));
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
    if (l == 0) {
      k_out[first + seg] = k;
      if constexpr (kApply) legal_out[first + seg] = true;
    }
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

// The xwide clear's band of `rows` rows from row r0 (region_size rows,
// or fewer at the board's bottom): in reg[j], the bits of this lane's slot
// j, word w = lane + 32 j, that lie in a full rs-bit field of a whole band
// (fields that start in word w, and the part of one from word w - 1 that
// straddles into it), and `got` counts the fields that start in this
// lane's words.  A field may straddle word w and w + 1 (rs = 3: columns
// 30..32), read from the funnel-shifted pair (word w, word w + 1) and its
// part in w + 1 handed up.  Both go by shuffles, not by shared memory:
// with NJ = 1 word w + 1 is the next lane's (one `__shfl_down_sync`, one
// `__shfl_up_sync`, as before the slots); with NJ > 1 (one env a warp) it
// is the next lane's slot j, but lane 0's slot j + 1 for lane 31, so each
// slot's band goes round the warp by one `__shfl_sync` from lane l + 1
// mod 32 and lane 31 takes its slot j + 1's, and the spill likewise from
// lane l - 1 mod 32, lane 0 taking slot j - 1's (a shuffle a slot each way,
// against a band's rows of shared-memory reads for a neighbour word).
// `has[j]`: slot j holds a word (w < NW); an empty slot's band and fields
// are none.  Every lane of the warp calls it.
template <int NJ>
__device__ __forceinline__ void band_fields(const uint32_t* x, int nw, int r0, int rows,
                                            const bit_rows::Seat& t, int width,
                                            int region_size, const int (&c1)[NJ],
                                            uint32_t tile0, const bool (&has)[NJ], int& got,
                                            uint32_t (&reg)[NJ]) {
  uint32_t band[NJ], next[NJ], spill[NJ];            // spill: word w + 1's part of a field
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    band[j] = kAll;
    if (has[j]) {
      for (int i = 0; i < rows; ++i) band[j] &= x[(r0 + i) * nw + 32 * j];
    }
  }
  if constexpr (NJ == 1) {
    next[0] = __shfl_down_sync(kAll, band[0], 1);
  } else {
    uint32_t rot[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) rot[j] = __shfl_sync(kAll, band[j], (t.l + 1) & 31);
#pragma unroll
    for (int j = 0; j < NJ; ++j) next[j] = t.l < 31 ? rot[j] : j + 1 < NJ ? rot[j + 1] : 0u;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int w = t.lane + 32 * j;
    const uint32_t hi_word = w + 1 < nw ? next[j] : 0u;
    reg[j] = spill[j] = 0u;
    if (rows == region_size) {                       // a whole band on the board
      for (int c0 = c1[j]; c0 < 32 * (w + 1) && c0 + region_size <= width; c0 += region_size) {
        const int b = c0 - 32 * w;
        if ((__funnelshift_r(band[j], hi_word, b) & tile0) == tile0) {
          reg[j] |= tile0 << b;
          if (b + region_size > 32) spill[j] |= tile0 >> (32 - b);
          ++got;
        }
      }
    }
  }
  if constexpr (NJ == 1) {
    const uint32_t from_below = __shfl_up_sync(kAll, spill[0], 1);
    reg[0] |= t.lane > 0 ? from_below : 0u;
  } else {
    uint32_t rot[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) rot[j] = __shfl_sync(kAll, spill[j], (t.l + 31) & 31);
#pragma unroll
    for (int j = 0; j < NJ; ++j) reg[j] |= t.l > 0 ? rot[j] : j > 0 ? rot[j - 1] : 0u;
  }
}

// The xwide apply's store: `store_words_n` of the block's placed and
// cleared rows, but an env marked in `keep` (illegal: invalid or
// overlapping) gets its input bytes back, read from `src` at the same
// offsets (its row words hold board | cover, not its board).  A vector of
// 16 output bytes wholly in kept envs is one uint4 copy where `src` and
// `out` share their offset from a 16-byte boundary, a vector wholly in
// others is `store_words_n`'s, and a vector across a kept env's border, or
// a copy at another offset, goes byte by byte, as do the head and the
// ragged tail.  Threads t = 0 .. nt - 1 of the block share the work, after
// the barrier that follows the last write to `rows` and `keep`; bytes <
// 2^21.
__device__ __forceinline__ void store_apply_words(const uint32_t* rows, const uint32_t* keep,
                                                  const uint8_t* __restrict__ src, uint8_t* out,
                                                  long long at, int bytes, int width, int nw,
                                                  int height, int t, int nt) {
  uint8_t* o = out + at;
  const uint8_t* in = src + at;
  const bool same = ((reinterpret_cast<uintptr_t>(in) ^ reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  const int head = min(static_cast<int>((16 - (at & 15)) & 15), bytes);
  const int nvec = (bytes - head) / 16;
  const float inv_w = __frcp_rn(static_cast<float>(width));
  const float inv_h = __frcp_rn(static_cast<float>(height));
  for (int v = t; v < nvec; v += nt) {
    const int q = head + 16 * v;
    const int row = bit_rows::small_div(q, inv_w);
    const int c = q - row * width;
    const bool k0 = keep[bit_rows::small_div(row, inv_h)] != 0;
    const bool k1 = keep[bit_rows::small_div(bit_rows::small_div(q + 15, inv_w), inv_h)] != 0;
    if (k0 && k1 && same) {
      *reinterpret_cast<uint4*>(o + q) = *reinterpret_cast<const uint4*>(in + q);
      continue;
    }
    const uint32_t* r = rows + row * nw;
    const int w = c >> 5;
    uint32_t bits = __funnelshift_r(r[w], w + 1 < nw ? r[w + 1] : 0u, c & 31);
    if (width - c < 16) bits |= r[nw] << (width - c);
    if (!k0 && !k1) {
      *reinterpret_cast<uint4*>(o + q) =
          make_uint4(bit_rows::spread4(bits), bit_rows::spread4(bits >> 4),
                     bit_rows::spread4(bits >> 8), bit_rows::spread4(bits >> 12));
      continue;
    }
    for (int j = 0; j < 16; ++j) {
      const int e = bit_rows::small_div(bit_rows::small_div(q + j, inv_w), inv_h);
      o[q + j] = keep[e] ? in[q + j] : static_cast<uint8_t>((bits >> j) & 1u);
    }
  }
  for (int j = t; j < bytes - 16 * nvec; j += nt) {
    const int q = j < head ? j : j + 16 * nvec;
    const int row = bit_rows::small_div(q, inv_w);
    const int c = q - row * width;
    o[q] = keep[bit_rows::small_div(row, inv_h)]
               ? in[q]
               : static_cast<uint8_t>((rows[row * nw + (c >> 5)] >> (c & 31)) & 1u);
  }
}

// The xwide kernel's two instances likewise: the clear (kApply false) and
// the apply (kApply true).  Each has two forms: kWindows false takes a
// board whose rows (and region bands) fit one 32-bit word of row bits, a
// board of at most 32 rows (30 with 3x3 regions) in one pass 2 over its
// rows; kWindows true walks pass 2 in windows of 32 rows (32 - 32 mod rs),
// a full-row word and one reduction a window, reading each row once more
// (the entry picks by height: a single pass 2 with a window's loop around
// it took 4-22% longer on boards of at most 32 rows, in turns on an H100).
// The apply's two forms also hold the covers differently:
//   - one window (kCovers): the block loads its envs' covers as row words
//     beside their boards (two arrays, each zeroed by `stage_words` before
//     its barrier); the overlap is lane-local (the OR over the lane's rows
//     of board & cover), one `__reduce_or_sync` over the segment gives the
//     env's; a legal env places its cover in its board words in place and
//     runs the clear's passes on them, an illegal one runs them on its
//     input words but writes none back (the segments of a warp differ in
//     legality, and every lane runs every shuffle and reduction), so it
//     stores its input: a strict no-op with k = 0;
//   - windows (kPlaced): one array of row words, as the clear's: the block
//     loads its envs' boards, then ORs their covers over them
//     (`stage_words<true>`), so that each env's rows are placed before the
//     passes, and a cover bit whose atomic OR finds its board's bit set
//     marks the env in `keep` (a word an env after the rows), the overlap.
//     A valid, unmarked env is legal and clears its placed rows in place;
//     an illegal one runs the passes on its placed words but writes none
//     back, is marked by its lane 0, and the store (`store_apply_words`)
//     writes its input bytes, read again from `board`.
// On 40x136 the second array took twice the shared memory a block (38,400
// bytes for 4 warps against 19,296) and 1.14x the time, 1.31x on 66x130;
// on boards of at most 32 rows the placed form took 1.07-1.50x the two
// arrays' time (copying back the input of an illegal env, 80% of the
// timing inputs, and a barrier more), in turns on an H100.
template <bool kApply, bool kWindows, int NJ>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    clear_xwide_kernel(const uint8_t* __restrict__ board, const uint8_t* __restrict__ cover,
                       const uint8_t* __restrict__ valid, uint8_t* __restrict__ board_out,
                       int32_t* __restrict__ k_out, uint8_t* __restrict__ legal_out, int n,
                       int height, int width, int region_size, int per_warp) {
  extern __shared__ __align__(16) uint8_t rows_smem[];
  const int nw = (width + 31) / 32;
  const int per_block = blockDim.x / 32 * per_warp;
  const int hw = height * width;
  constexpr bool kCovers = kApply && !kWindows;      // the covers beside the boards
  constexpr bool kPlaced = kApply && kWindows;       // the covers ORed over them
  uint32_t* words = reinterpret_cast<uint32_t*>(rows_smem);  // E*H rows, cleared in place
  uint32_t* covers = words + per_block * height * nw;        // kCovers: E*H cover rows
  uint32_t* keep = covers;                                   // kPlaced: E illegal marks
  const int first = blockIdx.x * per_block;          // first env
  const int count = min(per_block, n - first);       // envs here
  const long long lo = static_cast<long long>(first) * hw;
  const long long hi = lo + static_cast<long long>(count) * hw;
  if constexpr (kPlaced) {
    for (int i = threadIdx.x; i < per_block; i += blockDim.x) keep[i] = 0u;
  }
  bit_rows::stage_words(board, lo, hi, width, nw, words);
  if constexpr (kCovers) bit_rows::stage_words(cover, lo, hi, width, nw, covers);
  if constexpr (kPlaced) {
    __syncthreads();
    bit_rows::stage_words<true>(cover, lo, hi, width, nw, words, keep, height);
  }

  // t.lane: the word of slot 0; NJ > 1 takes one env a warp (per_warp 1)
  const bit_rows::Seat t = bit_rows::seat(NJ == 1 ? nw : 32, NJ == 1 ? per_warp : 1);
  const bool active = t.s < per_warp && t.seg < count;
  bool has[NJ];                                      // slot j holds word lane + 32 j < NW
#pragma unroll
  for (int j = 0; j < NJ; ++j) has[j] = NJ == 1 || j + 1 < NJ || t.lane + 32 * j < nw;
  __syncthreads();
  // row r's word of slot j: x[r * nw + 32 j]; a lane of no env reads env 0's
  // and writes nothing
  const int at = (active ? t.seg : 0) * height * nw + t.lane;
  uint32_t* x = words + at;
  bool write = active;                               // this lane's env keeps what the clear gives
  if constexpr (kCovers) {
    const uint32_t* y = covers + at;
    uint32_t hit = 0;
    for (int r = 0; r < height; ++r) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (has[j]) hit |= x[r * nw + 32 * j] & y[r * nw + 32 * j];
      }
    }
    const unsigned overlap = __reduce_or_sync(t.mask, hit != 0 ? 1u : 0u);  // every lane
    write = active && valid[first + t.seg] != 0 && overlap == 0;
    if (write) {
      for (int r = 0; r < height; ++r) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (has[j]) x[r * nw + 32 * j] |= y[r * nw + 32 * j];  // placed in place
        }
      }
    }
  }
  if constexpr (kPlaced) write = active && valid[first + t.seg] != 0 && keep[t.seg] == 0;
  const int tail = width - 32 * (nw - 1);            // columns of the top word: 1..32
  const int g = region_size > 0 ? region_size : 1;  // rows a band
  const uint32_t tile0 = region_size < 32 ? (1u << region_size) - 1u : kAll;
  uint32_t pad[NJ];                                  // past W: full (word NW - 1's)
  int c1[NJ];                                        // the first field that starts in a word
  uint32_t cols[NJ];                                 // pass 1: the full columns of a word
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int w = t.lane + 32 * j;
    pad[j] = w + 1 == nw && tail < 32 ? kAll << tail : 0u;
    // columns c0 = 0, rs, 2 rs, ...
    c1[j] = region_size > 0 ? (32 * w + region_size - 1) / region_size * region_size : 0;
    cols[j] = has[j] ? kAll : 0u;                    // a slot of no word: no full column
  }
  int k;
  if constexpr (!kWindows) {
    // pass 1, lane-local: the full columns of each word (the AND of its
    // rows) and bit r set where row r's words are all full
    uint32_t full = 0;
    for (int r = 0; r < height; ++r) {
      bool f = true;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (has[j]) {
          const uint32_t v = x[r * nw + 32 * j];
          cols[j] &= v;
          f &= (v | pad[j]) == kAll;
        }
      }
      full |= (f ? 1u : 0u) << r;
    }
    const uint32_t rows_full = __reduce_and_sync(t.mask, full);  // the env's full rows
    int got = 0;                                     // this lane's full columns, then tiles
#pragma unroll
    for (int j = 0; j < NJ; ++j) got += __popc(cols[j]);
    // pass 2, a band of region_size rows (a row without regions) at a time:
    // the band's full fields, then its rows cleared in place
    for (int r0 = 0; r0 < height; r0 += g) {
      const int rows_here = min(g, height - r0);
      uint32_t reg[NJ] = {};
      if (region_size > 0) {
        band_fields<NJ>(x, nw, r0, rows_here, t, width, region_size, c1, tile0, has, got, reg);
      }
      for (int i = 0; i < rows_here; ++i) {
        const int r = r0 + i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t* v = x + r * nw + 32 * j;
          if (write && has[j]) *v = (rows_full >> r & 1u) ? 0u : *v & ~(cols[j] | reg[j]);
        }
      }
    }
    k = __popc(rows_full) + __reduce_add_sync(t.mask, got);
  } else {
    // pass 1, lane-local: the full columns of each word
    for (int r = 0; r < height; ++r) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (has[j]) cols[j] &= x[r * nw + 32 * j];
      }
    }
    int got = 0;                                     // this lane's full columns, then tiles
#pragma unroll
    for (int j = 0; j < NJ; ++j) got += __popc(cols[j]);
    k = 0;                                           // full rows
    // pass 2, a window of rows at a time (a whole number of bands): its
    // full rows, then its bands as above
    const int win = region_size > 0 ? 32 - 32 % region_size : 32;
    for (int w0 = 0; w0 < height; w0 += win) {
      const int w1 = min(w0 + win, height);
      uint32_t full = 0;                             // bit i: row w0 + i's words all full
      for (int r = w0; r < w1; ++r) {
        bool f = true;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (has[j]) f &= (x[r * nw + 32 * j] | pad[j]) == kAll;
        }
        full |= (f ? 1u : 0u) << (r - w0);
      }
      const uint32_t rows_full = __reduce_and_sync(t.mask, full);  // the window's full rows
      k += __popc(rows_full);
      for (int r0 = w0; r0 < w1; r0 += g) {
        const int rows_here = min(g, w1 - r0);
        uint32_t reg[NJ] = {};
        if (region_size > 0) {
          band_fields<NJ>(x, nw, r0, rows_here, t, width, region_size, c1, tile0, has, got,
                          reg);
        }
        for (int i = 0; i < rows_here; ++i) {
          const int r = r0 + i;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            uint32_t* v = x + r * nw + 32 * j;
            if (write && has[j]) {
              *v = (rows_full >> (r - w0) & 1u) ? 0u : *v & ~(cols[j] | reg[j]);
            }
          }
        }
      }
    }
    k += __reduce_add_sync(t.mask, got);
  }
  if (active && t.lane == 0) {
    k_out[first + t.seg] = write ? k : 0;
    if constexpr (kApply) legal_out[first + t.seg] = write;
    if constexpr (kPlaced) {
      if (!write) keep[t.seg] = 1u;                  // its lanes read it before the reduction
    }
  }
  __syncthreads();
  if constexpr (kPlaced) {
    store_apply_words(words, keep, board, board_out, lo, count * hw, width, nw, height,
                      threadIdx.x, blockDim.x);
  } else {
    bit_rows::store_words_n(words, board_out, lo, count * hw, width, nw, threadIdx.x,
                            blockDim.x);
  }
}

// A launch of the wide, tall, deep and xwide kernels: the clear's arguments and
// the apply's cover, valid and legal_out (null for the clear), a block of
// `warps` warps taking `per_warp` envs each.
struct Io {
  const void* board;
  const void* cover;
  const void* valid;
  void* board_out;
  void* k_out;
  void* legal_out;
  int n, height, width, region_size, per_warp, warps;
  cudaStream_t stream;
};

using Kernel = void (*)(const uint8_t*, const uint8_t*, const uint8_t*, uint8_t*, int32_t*,
                        uint8_t*, int, int, int, int, int);

// `kernel`'s launch on `io` with `smem` bytes of shared memory a block:
// refused where that passes what a block may opt in to, opted in to above
// 48 KB.
int launch_smem(Kernel kernel, const Io& io, long long smem) {
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = io.warps * io.per_warp;
  kernel<<<(io.n + per_block - 1) / per_block, io.warps * 32, static_cast<int>(smem),
           io.stream>>>(
      static_cast<const uint8_t*>(io.board), static_cast<const uint8_t*>(io.cover),
      static_cast<const uint8_t*>(io.valid), static_cast<uint8_t*>(io.board_out),
      static_cast<int32_t*>(io.k_out), static_cast<uint8_t*>(io.legal_out), io.n, io.height,
      io.width, io.region_size, io.per_warp);
  return static_cast<int>(cudaGetLastError());
}

// The wide, tall and deep kernels' launch, their rows of NW words: the
// block's shared memory holds its output rows, then its staged board span
// and, for the apply, its cover span (`bit_rows::smem_bytes`).
template <int NW, bool kApply>
int launch(Kernel kernel, const Io& io) {
  const int per_block = io.warps * io.per_warp;
  const long long span = static_cast<long long>(per_block) * io.height * io.width;
  return launch_smem(kernel, io,
                     (4LL * per_block * io.height * NW + 15) / 16 * 16 +
                         (kApply ? (span + 32 + 15) / 16 * 16 : 0) + span + 32);
}

template <bool kApply>
int run_wide(const Io& io) {
  switch ((io.width + 31) / 32) {
    case 2: return launch<2, kApply>(clear_wide_kernel<2, kApply>, io);
    case 3: return launch<3, kApply>(clear_wide_kernel<3, kApply>, io);
    default: return launch<4, kApply>(clear_wide_kernel<4, kApply>, io);
  }
}

template <int NR, bool kApply>
int run_tall_rows(const Io& io) {
  switch ((io.width + 31) / 32) {
    case 1: return launch<1, kApply>(clear_tall_kernel<NR, 1, kApply>, io);
    case 2: return launch<2, kApply>(clear_tall_kernel<NR, 2, kApply>, io);
    case 3: return launch<3, kApply>(clear_tall_kernel<NR, 3, kApply>, io);
    default: return launch<4, kApply>(clear_tall_kernel<NR, 4, kApply>, io);
  }
}

template <bool kApply>
int run_tall(const Io& io) {
  switch ((io.height + 31) / 32) {
    case 2: return run_tall_rows<2, kApply>(io);
    case 3: return run_tall_rows<3, kApply>(io);
    default: return run_tall_rows<4, kApply>(io);
  }
}

template <bool kApply>
int run_deep(const Io& io) {
  switch ((io.width + 31) / 32) {
    case 1: return launch<1, kApply>(clear_deep_kernel<1, kApply>, io);
    case 2: return launch<2, kApply>(clear_deep_kernel<2, kApply>, io);
    case 3: return launch<3, kApply>(clear_deep_kernel<3, kApply>, io);
    default: return launch<4, kApply>(clear_deep_kernel<4, kApply>, io);
  }
}

bool region_ok(const Io& io) { return io.region_size >= 0 && io.region_size <= 32; }

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// H <= 32 and 32 < W <= 128: per_warp = 32 / H, warps such that the block's
// output, warps * per_warp * H * W bytes, is a multiple of 16
int wide(const Io& io, bool apply) {
  if (io.height < 1 || io.height > 32 || io.per_warp != 32 / io.height || io.width <= 32 ||
      io.width > 128 || !region_ok(io) || io.warps < 1 || io.warps > bit_rows::kMaxWarps ||
      (io.warps * io.per_warp * io.height * io.width) % 16 != 0 || !aligned(io.board_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (io.n <= 0) return static_cast<int>(cudaGetLastError());
  return apply ? run_wide<true>(io) : run_wide<false>(io);
}

// 32 < H <= 128 (tall) or H > 128 (deep), W <= 128: per_warp 1 to 4,
// warps 1 to 16
int tall(const Io& io, bool apply, bool deep) {
  if (io.height <= 32 || (io.height > 128) != deep || io.width < 1 || io.width > 128 ||
      !region_ok(io) || io.warps < 1 || io.warps > bit_rows::kMaxWarps || io.per_warp < 1 ||
      io.per_warp > 4 || !aligned(io.board_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (io.n <= 0) return static_cast<int>(cudaGetLastError());
  if (deep) return apply ? run_deep<true>(io) : run_deep<false>(io);
  return apply ? run_tall<true>(io) : run_tall<false>(io);
}

// The xwide kernel of NJ slots a lane, its four forms.
template <int NJ>
Kernel xwide_kernel(bool apply, bool windows) {
  return apply ? (windows ? clear_xwide_kernel<true, true, NJ>
                          : clear_xwide_kernel<true, false, NJ>)
               : (windows ? clear_xwide_kernel<false, true, NJ>
                          : clear_xwide_kernel<false, false, NJ>);
}

// 128 < W <= 4096, any height: per_warp = 32 / NW where W <= 1024 (NW
// lanes an env), 1 above (NJ = ceil(NW / 32) words a lane, one env a
// warp); warps 1 to 16; the block's shared memory is its envs' rows of NW
// words, and the apply's as many cover rows beside them on a board of one
// window, or a word an env (`keep`) on a taller one; refused where a block
// stages 2^21 bytes or more (`small_div`)
int xwide(const Io& io, bool apply) {
  const int nw = (io.width + 31) / 32;
  const int nj = (nw + 31) / 32;
  if (io.height < 1 || io.width <= 128 || io.width > 4096 ||
      io.per_warp != (nj == 1 ? 32 / nw : 1) || !region_ok(io) || io.warps < 1 ||
      io.warps > bit_rows::kMaxWarps || !aligned(io.board_out) ||
      static_cast<long long>(io.warps) * io.per_warp * io.height * io.width >= (1LL << 21)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (io.n <= 0) return static_cast<int>(cudaGetLastError());
  // windows where a region band or a row's bit would pass one 32-bit word
  const bool windows = io.height > (io.region_size > 0 ? 32 - 32 % io.region_size : 32);
  const Kernel kernel = nj == 1 ? xwide_kernel<1>(apply, windows)
                        : nj == 2 ? xwide_kernel<2>(apply, windows)
                        : nj == 3 ? xwide_kernel<3>(apply, windows)
                                  : xwide_kernel<4>(apply, windows);
  const long long rows = static_cast<long long>(io.warps) * io.per_warp * io.height * nw;
  return launch_smem(kernel, io,
                     4 * (!apply ? rows : windows ? rows + io.warps * io.per_warp : 2 * rows));
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
  const long long env = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp;
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
  return wide({board, nullptr, nullptr, board_out, k_out, nullptr, n, height, width,
               region_size, per_warp, warps, static_cast<cudaStream_t>(stream)}, false);
}

// As bp_clear_rows, for 32 < H <= 128 and W <= 128: one env a warp at a
// time, lane l holding rows l + 32 j (j < NR = ceil(H / 32)) of NW =
// ceil(W / 32) words; per_warp (1 to 4) envs a warp in turn, from the one
// staged span of the block's warps * per_warp envs; any count of warps from
// 1 to 16.
extern "C" int bp_clear_tall(const void* board, void* board_out, void* k_out,
                             int n, int height, int width, int region_size,
                             int per_warp, int warps, void* stream) {
  return tall({board, nullptr, nullptr, board_out, k_out, nullptr, n, height, width,
               region_size, per_warp, warps, static_cast<cudaStream_t>(stream)}, false,
              false);
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
  return tall({board, nullptr, nullptr, board_out, k_out, nullptr, n, height, width,
               region_size, per_warp, warps, static_cast<cudaStream_t>(stream)}, false,
              true);
}

// As bp_clear_rows, for 128 < W <= 4096 and any height: a segment of NW =
// ceil(W / 32) lanes an env, lane w holding word w of every row, the rows
// in windows of 32 (32 - 32 mod rs with regions of size rs); per_warp =
// 32 / NW segments a warp where W <= 1024, and above one env a warp, lane l
// holding words l + 32 j (per_warp = 1); warps 1 to 16 (the block's output
// span may start off a 16-byte boundary); refused where the block's shared
// memory (its envs' rows of NW words) passes what a block may opt in to, or
// where it stages 2^21 bytes or more.
extern "C" int bp_clear_xwide(const void* board, void* board_out, void* k_out,
                              int n, int height, int width, int region_size,
                              int per_warp, int warps, void* stream) {
  return xwide({board, nullptr, nullptr, board_out, k_out, nullptr, n, height, width,
                region_size, per_warp, warps, static_cast<cudaStream_t>(stream)}, false);
}

// The apply (K2) on the clear's kernels: bp_apply_rows's arguments and
// launch shape rules, for the boards bp_clear_wide, bp_clear_tall,
// bp_clear_deep and bp_clear_xwide take.  board, cover (N, HW) u8 of 0/1
// cells, each at any address; valid (N,) bool; outputs board_out (N, HW)
// u8 (16-byte aligned), k (N,) i32, legal (N,) bool.  Each is refused where its block's
// shared memory (output rows and two staged spans; the xwide one's board
// and cover rows of words, or above one window its placed rows and a word
// an env) passes what a block may opt in to.
extern "C" int bp_apply_wide(const void* board, const void* cover, const void* valid,
                             void* board_out, void* k_out, void* legal_out, int n,
                             int height, int width, int region_size, int per_warp,
                             int warps, void* stream) {
  return wide({board, cover, valid, board_out, k_out, legal_out, n, height, width,
               region_size, per_warp, warps, static_cast<cudaStream_t>(stream)}, true);
}

extern "C" int bp_apply_tall(const void* board, const void* cover, const void* valid,
                             void* board_out, void* k_out, void* legal_out, int n,
                             int height, int width, int region_size, int per_warp,
                             int warps, void* stream) {
  return tall({board, cover, valid, board_out, k_out, legal_out, n, height, width,
               region_size, per_warp, warps, static_cast<cudaStream_t>(stream)}, true,
              false);
}

extern "C" int bp_apply_deep(const void* board, const void* cover, const void* valid,
                             void* board_out, void* k_out, void* legal_out, int n,
                             int height, int width, int region_size, int per_warp,
                             int warps, void* stream) {
  return tall({board, cover, valid, board_out, k_out, legal_out, n, height, width,
               region_size, per_warp, warps, static_cast<cudaStream_t>(stream)}, true,
              true);
}

extern "C" int bp_apply_xwide(const void* board, const void* cover, const void* valid,
                              void* board_out, void* k_out, void* legal_out, int n,
                              int height, int width, int region_size, int per_warp,
                              int warps, void* stream) {
  return xwide({board, cover, valid, board_out, k_out, legal_out, n, height, width,
                region_size, per_warp, warps, static_cast<cudaStream_t>(stream)}, true);
}

// board (N, HW) u8; line_cells (L, max_len) i32 and line_len (L,) i32;
// outputs board_out (N, HW) u8 and k (N,) i32.  Refused where one warp's
// hw + L bytes pass what a block may opt in to.
extern "C" int bp_clear(const void* board, const void* line_cells,
                        const void* line_len, void* board_out, void* k_out,
                        int n, int hw, int num_lines, int max_len,
                        void* stream) {
  const int warps = general_warps(hw, num_lines);
  if (n <= 0) return static_cast<int>(warps < 1 ? cudaErrorInvalidValue : cudaGetLastError());
  return launch_general(clear_kernel, n, warps, hw, num_lines,
                        static_cast<cudaStream_t>(stream),
                        static_cast<const uint8_t*>(board),
                        static_cast<const int32_t*>(line_cells),
                        static_cast<const int32_t*>(line_len),
                        static_cast<uint8_t*>(board_out), static_cast<int32_t*>(k_out), n, hw,
                        num_lines, max_len);
}
