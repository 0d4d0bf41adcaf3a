// The packed kernels for boards of more than 32 rows: the chosen-action
// apply (B1, packed_apply.cu), the hand mask (B7) and its words entry (B7w,
// packed_mask.cu), which take one row a lane and so at most 32 rows.  No
// Pallas source: the JAX package runs all three in jnp, as the packed block
// of `VecBlockPuzzle.step` with `_cover_words` and `_clear_scan_packed`
// (blockpuzzle_tpu/env/core.py:962,674,696), as `_bitboard_legal_slots` with
// `_bitboard_mask_from_words` (:489,541) and as `legal_words`
// (blockpuzzle_tpu/env/words.py:78), on any number of rows: the JAX
// engine's default state is packed on every board of at most 32 columns.
// The plain versions are `packed_apply_plain`, `packed_mask_plain` and
// `packed_legal_words_plain` (kernels/packed.py).  What each computes is
// written there and in packed_apply.cu and packed_mask.cu.
//
// Bound on the H100: device memory, as the H <= 32 kernels.  Per env the
// apply reads H int64 words, 11 int32 attrs, r, c and valid and writes H
// int64 words, k and legal: 586 B on 33x9, 28.8 MB at N = 49152, 8.6 us at
// 3.35 TB/s.  The mask reads H words and S ids and writes S*H*W bools (565
// B on 33x9, S = 1); the words entry writes S*H int64 words (532 B).
//
// The tall apply (33 <= H <= 128) carries the H <= 32 kernel's
// lane-a-row design to one warp an env: lane l holds rows l + 32 j in slot
// j < NR = ceil(H / 32), NR a template parameter.  A row below row r,
// r + d (d < 32, below the region size in the clear), comes by
// `__shfl_sync` from lane (l + d) mod 32, in slot j or, across the seam
// (l + d >= 32), slot j + 1 (`bit_rows::rows_below`).  Overlap by one
// `__any_sync`; the clear is `bit_rows::clear_tall` on one-word rows: full
// rows by a ballot a slot, columns by ANDing a lane's slots and one
// `__reduce_and_sync`, regions by band ANDs that may cross the seam.  A
// warp's loads and stores of a slot are contiguous, 8 bytes a lane.
//
// The tall mask and its words entry (`packed_anchor_kernel`, below) take a
// segment of C = ceil(H / K) threads an env-slot, thread c holding anchor
// rows c + C j (j < K = 8 in the mask, 4 in the words entry), and a block
// of E whole env-slots, so that at most K - 1 of an env-slot's K C slots
// hold no row (a warp an env-slot left 31 of its 64 lane-slots without a
// row on 33 rows) and a block's output is one contiguous span.  The block
// stages the boards of the envs its env-slots read in shared
// memory, one contiguous read, each followed by full rows as far as a
// footprint reaches past its bottom; a row below an anchor row is a
// shared-memory read, where a warp an env-slot rebuilt each footprint
// word's board words by shuffles (`rows_below`, nwords * fpw calls: 12
// shuffles an env-slot on 33x9) before its first cell test.  Where C
// divides 32 (57-64 and 121-128 rows in the mask, 61-64 and 125-128 in
// the words entry), each warp stages and stores its own env-slots
// (`kWarp`) and no block barrier runs.  The words entry also serves boards
// of 16 to 32 rows and of 9 and 11-13 (kernels/packed.py
// `words_kernel_kind`), where a warp of the bit-row words kernel carries
// one or two env-slots or leaves 5 or more lanes idle (16 rows: C = 4, a
// warp 8 env-slots, `kWarp`).

// The general apply (H > 128, and any H >= 1 it is given): one warp an env
// walking the board in windows of `cr` rows, one row a lane, so that
// registers do not grow with H.  Without regions cr = 32; with regions of
// size rs, cr = 32 - 32 mod rs, so that every window starts on a multiple
// of rs and no region band crosses a window (JAX's bands start at
// multiples of rs; only whole ones, a < H // rs, count).  Pass 1 reads
// each window coalesced, 8 bytes a lane, ORs in the footprint (`Cover`,
// the attrs row read once), gathers the overlap by `__any_sync` and ANDs
// the placed rows' columns into a lane value, reduced once at the end by
// `__reduce_and_sync`; it keeps the placed rows in shared memory, H words
// a warp (`kStaged`), or pass 2 reads the input rows again (an L2 hit) and
// ORs the footprint in again.  The entry stages them wherever a warp's
// 4 H bytes fit a block (on the H100 the staged pass 2 is as fast on 130
// rows and 9% faster on 512, `chip_measure.py --parts deep`), else reads
// again; `bp_packed_apply_general_pass` takes either.  Pass 2 clears each
// window: full rows by a
// ballot, the region bands inside the window by rs shuffles from the
// band's lanes, each full tile counted by the band's first row only, and
// stores 8 bytes a lane, coalesced; k = the full rows' popcounts + the
// columns' popcount + the tiles, summed over the windows.  Lanes past the
// last row of the last window (31 of 32 on 129 rows) run every shuffle and
// ballot and store nothing; rows past the bottom count as the column AND's
// identity.  An illegal action writes its input back.  It answers what
// bounded the thread-an-env kernel it replaced: 12 warps an SM whose
// neighbouring lanes read rows H * 8 bytes apart, 32 sectors a warp-wide
// load, and three serial passes of dependent loads, few bytes in flight.
//
// The general mask (H > 128, and any H >= 1 it is given): one warp an
// env-slot walking the board in windows of 32 anchor rows, two board rows a
// lane as the deep u8 mask holds them (mask.cu `mask_deep_kernel`): rows
// 32 j + l and 32 (j + 1) + l, each read as the lane's int64, so that a
// warp-wide load is one coalesced 256-byte read, rows past the bottom full.
// A footprint reaches nwords * fpw - 1 <= 31 rows below an anchor row, all
// in the pair.  Lane t first takes the columns of piece row t from the
// footprint words (field t % fpw of word t / fpw); per window the pair goes
// to shared memory and each lane ORs, for every piece row t and each of
// its cells' columns dc (one shuffle of row t's columns), row l + t
// shifted right by dc into its blocked bits: the same test as the tall
// mask's (`packed_anchor_kernel`), without footprint words a window.
// Then the second row moves up and the row of the window after next,
// loaded at the window's start, comes in.  Each window's 32 legal rows are
// staged in shared memory, and every two windows the warp stores their 64 W
// output bytes as 16-byte vectors from their byte offset, any offset, the
// ragged edges byte by byte (`store_tall`), so the shared memory a warp
// needs does not grow with H.  It answers what bounded the
// thread-an-anchor-row kernel it replaced (`packed_mask_rows_general_kernel`:
// 6.4 M threads on 130x8 at N = 49152, each with two 64-bit divisions, its
// table loads, and W byte stores 8 bytes apart between neighbouring lanes),
// which the entry keeps only for footprints of more than 32 rows
// (nwords * fpw > 32: no shipped piece set), picked by shape as
// `bp_packed_apply_general` picks its pass 2; `bp_packed_mask_general_pick`
// takes either.  The words entry is a second instance of the windowed
// kernel (`kWords`): the same legality a window, each lane's legal row
// stored as one int64 (lane l: row w0 + l), a coalesced 256-byte store a
// window and no rows staged.  It answers what bounded its thread-an-anchor-
// row kernel (`packed_words_general_kernel`, `legal_row_general`: every
// thread re-reading nwords * fpw board rows from device memory, 36.8% of its
// bound on 130x8), which stays for footprints of more than 32 rows;
// `bp_packed_words_general_pick` takes either.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bit_rows.cuh"

namespace {

constexpr int kWarps = 8;        // warps a block of the apply and the general mask
constexpr int kMaxAnchorThreads = 1024;  // threads a block of the tall mask and words
constexpr int kLoads = 4;        // board rows a thread of those loads at once
constexpr int kThreads = 256;    // threads a block of the general kernels
constexpr int kMaxRows = 128;    // rows of the tallest board the tall kernels take
constexpr long long kSmemOptIn = 227 * 1024;  // shared memory a block may opt in to
using bit_rows::kAll;

// anchor rows a thread of the tall mask (8) and of its words entry (4)
__host__ __device__ constexpr int anchor_rows(bool words) { return words ? 4 : 8; }

__device__ __forceinline__ uint32_t shl32(uint32_t x, int s) {
  return s < 32 ? x << s : 0u;
}

// Footprint word of board row `row` for the chosen action: the union of the
// attrs row's <= 2 rectangles, each a shifted 2^rw - 1 row mask on its rows.
__device__ __forceinline__ uint32_t cover_row(const int32_t* a, int r, int c, int row) {
  uint32_t cover = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row0 = r + a[3 + 4 * j];
    if (row >= row0 && row < row0 + a[5 + 4 * j]) {
      cover |= shl32(shl32(1u, a[6 + 4 * j]) - 1u, c + a[4 + 4 * j]);
    }
  }
  return cover;
}

template <int NR>
__global__ void __launch_bounds__(kWarps * 32)
    packed_apply_tall_kernel(const long long* __restrict__ words,
                             const int32_t* __restrict__ attrs,
                             const int32_t* __restrict__ r_in,
                             const int32_t* __restrict__ c_in,
                             const uint8_t* __restrict__ valid,
                             long long* __restrict__ words_out,
                             int32_t* __restrict__ k_out,
                             uint8_t* __restrict__ legal_out, int n, int height,
                             int width, int region_size) {
  const int l = threadIdx.x % 32;
  const long long env = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (env >= n) return;  // the whole warp: no collective is left behind
  const int32_t* a = attrs + env * 11;
  const int r = r_in[env];
  const int c = c_in[env];
  const bool ok = valid[env] != 0;
  const long long* x64 = words + env * height;
  uint32_t w[NR][1];  // the placed rows; no row: the identity of the AND
  bool overlap = false;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int row = l + 32 * j;
    w[j][0] = kAll;
    if (row < height) {
      const uint32_t x = static_cast<uint32_t>(x64[row]);
      const uint32_t cover = cover_row(a, r, c, row);
      overlap |= (x & cover) != 0;
      w[j][0] = x | cover;
    }
  }
  const bool legal = ok && !__any_sync(kAll, overlap);
  int k;
  bit_rows::clear_tall<NR, 1>(w, true, height, width, region_size, k);
  // an illegal action writes its input back, read again (a cache hit)
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int row = l + 32 * j;
    if (row < height) {
      words_out[env * height + row] = legal ? static_cast<long long>(w[j][0]) : x64[row];
    }
  }
  if (l == 0) {
    k_out[env] = legal ? k : 0;
    legal_out[env] = legal;
  }
}

// A launch's shape of the tall mask and words, computed once on the host
// (`launch_anchor`), so that no thread divides a launch constant or takes
// its reciprocal.
struct AnchorShape {
  int envs;         // env-slots a block
  int seg;          // C threads an env-slot
  int per;          // env-slots a group: the block, or (kWarp) a warp
  int stride;       // a staged board: its H rows, then `pad` full rows
  int pad;
  int region;       // the most boards a group stages, 32-bit words
  int group_words;  // the group's shared memory: boards, then the mask's legal rows
  float inv_seg, inv_height, inv_pad, inv_slots;  // as __frcp_rn gives them
  uint32_t slot_magic;                            // bit_rows::wide_magic(S), S > 1
};

// The tall mask and its words entry (`kWords`): a segment of C =
// ceil(H / K) threads an env-slot, thread c holding its anchor rows c + C j,
// j < K = `anchor_rows`: 8 for the mask, 4 for the words entry (at most K -
// 1 of the K C slots pass row H - 1; on the H100 K = 8 took the mask 2.6-
// 13% below K = 4 on every board and the words up to 8% above, K = 2 was
// 1.4-1.7x slower, `chip_measure.py --parts packed_tall`), and a block of
// E whole env-slots, so that its output is one contiguous span: bytes es0
// * HW .. (es0 + E) * HW - 1 of the mask, int64 words es0 * H .. (es0 + E)
// * H - 1 of the words entry (es0 = b * E).  The rows below an anchor row
// come from shared memory, not from shuffles, so segments need not be
// warps: the group first stages the boards of the envs its env-slots read,
// the boards' rows as one contiguous read of words (the repeats of S > 1
// staged once; kLoads loads in flight a thread), then after each board, with
// no loads, full rows as far as a footprint reaches from its last slot's
// rows, so that row + t >= H (past the bottom) reads full with no test.
// Where C divides 32 and E is a multiple of 32 / C (the mask on 57-64 rows,
// C = 8, and 121-128, C = 16; the words on 61-64, C = 16, and 125-128, C =
// 32), each warp holds whole segments and stages, syncs and stores its own
// env-slots (`kWarp`: __syncwarp, no block barrier).  Each thread then takes
// its env-slot's piece id and, for each piece row t (field t % fpw of
// footprint word t / fpw), ORs its K rows' row + t shifted right by each
// of that row's cell columns into their blocked bits: the same test as
// packed_mask.cu's `legal_row_bits`, each cell's loop step shared by the K
// rows.  A warp spans a few env-slots, so it runs their pieces' cell loops
// predicated: the warp takes the longest loop, not the sum.  The mask
// stages each row's legal bits as one word, passes one more barrier and
// stores the span as 16-byte vectors (`store_tall<1>`: 4 bits spread into
// 4 bytes by one multiply; the wrapper picks E so that E * HW is a
// multiple of 16 and every block's span starts on a 16-byte boundary), the
// ragged tail byte by byte.  The words entry stores its int64s straight and
// stages no legal bits.  Near its issue bound on 128 rows (~820 issue
// slots a warp at the warp-an-env-slot kernel's time there), it keeps a
// thread's integer work small: every index 32-bit, the launch's constants
// and reciprocals computed once on the host (`AnchorShape`), es0 / S by
// one multiply-high and every other quotient by `small_div` (computed in
// each thread, two 64-bit divisions and four reciprocals had cost the mask
// 8% and the words 3% on 128x10).
template <bool kWords, bool kWarp>
__global__ void __launch_bounds__(kMaxAnchorThreads)
    packed_anchor_kernel(const long long* __restrict__ words,
                         const int32_t* __restrict__ queue,
                         const uint32_t* __restrict__ prow,
                         const int32_t* __restrict__ piece_w, void* __restrict__ out,
                         int total, int height, int width, int slots, int num_pieces,
                         int nwords, int fpw, const AnchorShape sh) {
  extern __shared__ uint32_t smem[];
  constexpr int K = anchor_rows(kWords);
  const int seg = sh.seg;
  const int group = kWarp ? threadIdx.x / 32 : 0;
  const int gt = threadIdx.x - 32 * group;
  const int gn = kWarp ? 32 : blockDim.x;
  const int es0 = blockIdx.x * sh.envs + group * sh.per;  // < total + envs <= 2^31 - 1
  if (kWarp && es0 >= total) return;  // the whole warp: no block barrier follows
  const int count = min(sh.per, total - es0);
  const int e = bit_rows::small_div(gt, sh.inv_seg);
  const int c = gt - e * seg;
  const bool live = e < count;
  const int es = es0 + e;
  // the envs the group's env-slots read: env0 = es0 / S by one multiply-high
  // (`wide_div`: es0 < 2^31, S <= 32), then the rest by `small_div`
  const int env0 = bit_rows::wide_div(es0, slots, sh.slot_magic);
  const int s0 = es0 - env0 * slots;
  const int nenv = bit_rows::small_div(s0 + count - 1, sh.inv_slots) + 1;
  const int pad = sh.pad;
  uint32_t* board = smem + group * sh.group_words;
  uint32_t* legal = board + sh.region;  // the mask's per * H legal rows
  const uint32_t full = shl32(1u, width) - 1u;
  // the boards' rows, one contiguous read, kLoads loads in flight a thread
  // before their stores wait on them: row j of the span is row j - v H of
  // board v, staged at j + v pad
  const long long* from = words + static_cast<long long>(env0) * height;
  const int rows = nenv * height;
  for (int j0 = gt; j0 < rows; j0 += kLoads * gn) {
    uint32_t x[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u * gn;
      x[u] = j < rows ? static_cast<uint32_t>(from[j]) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u * gn;
      if (j < rows) board[j + bit_rows::small_div(j, sh.inv_height) * pad] = x[u];
    }
  }
  // then the full rows past each bottom, no loads: full row j - v pad of
  // board v, staged at j + (v + 1) H
  for (int j = gt; j < nenv * pad; j += gn) {
    board[j + (bit_rows::small_div(j, sh.inv_pad) + 1) * height] = full;
  }
  const int pid = live ? queue[es] : -1;
  const int pw = pid >= 0 && pid < num_pieces ? piece_w[pid] : width + 1;  // none: no anchor
  // this env-slot's board: env (es0 + e) / S, the e-th past env0
  const uint32_t* b = board + bit_rows::small_div(s0 + e, sh.inv_slots) * sh.stride + c;
  if (kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  uint32_t blocked[K];  // bit c: a cell of anchor (row, c) meets the board
#pragma unroll
  for (int j = 0; j < K; ++j) blocked[j] = 0;
  if (live && pw <= width) {
    for (int w = 0; w < nwords; ++w) {
      const uint32_t m = prow[pid * nwords + w];
      for (int f = 0; f < fpw; ++f) {
        const int t = w * fpw + f;
        uint32_t cells = (m >> (f * width)) & full;
        if (cells == 0) continue;
        uint32_t y[K];
#pragma unroll
        for (int j = 0; j < K; ++j) y[j] = b[seg * j + t];
        for (; cells != 0; cells &= cells - 1) {
          const int p = __ffs(cells) - 1;
#pragma unroll
          for (int j = 0; j < K; ++j) blocked[j] |= y[j] >> p;
        }
      }
    }
  }
  const uint32_t anchors = pw <= width ? shl32(1u, width - pw + 1) - 1u : 0u;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int row = c + seg * j;
    if (live && row < height) {
      if constexpr (kWords) {
        static_cast<long long*>(out)[static_cast<long long>(es) * height + row] =
            ~blocked[j] & anchors;
      } else {
        legal[e * height + row] = ~blocked[j] & anchors;
      }
    }
  }
  if constexpr (!kWords) {
    if (kWarp) {
      __syncwarp();
    } else {
      __syncthreads();
    }
    bit_rows::store_tall<1>(legal, static_cast<uint8_t*>(out),
                            static_cast<long long>(es0) * height * width,
                            count * height * width, width, gt, gn);
  }
}

// The chosen action's footprint a row at a time, as `cover_row`, with the
// attrs row's two rectangles read once: rows [row0, end) of each take its
// shifted 2^rw - 1 row mask.
struct Cover {
  int row0[2], end[2];
  uint32_t mask[2];
  __device__ __forceinline__ Cover(const int32_t* a, int r, int c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      row0[j] = r + a[3 + 4 * j];
      end[j] = row0[j] + a[5 + 4 * j];
      mask[j] = shl32(shl32(1u, a[6 + 4 * j]) - 1u, c + a[4 + 4 * j]);
    }
  }
  __device__ __forceinline__ uint32_t operator()(int row) const {
    return (row >= row0[0] && row < end[0] ? mask[0] : 0u) |
           (row >= row0[1] && row < end[1] ? mask[1] : 0u);
  }
};

template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32)
    packed_apply_general_kernel(const long long* __restrict__ words,
                                const int32_t* __restrict__ attrs,
                                const int32_t* __restrict__ r_in,
                                const int32_t* __restrict__ c_in,
                                const uint8_t* __restrict__ valid,
                                long long* __restrict__ words_out,
                                int32_t* __restrict__ k_out,
                                uint8_t* __restrict__ legal_out, int n, int height,
                                int width, int region_size) {
  extern __shared__ uint32_t staged[];  // kStaged: H placed rows a warp
  const int l = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long env = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (env >= n) return;  // the whole warp: no collective is left behind
  const Cover cover(attrs + env * 11, r_in[env], c_in[env]);
  const long long* x64 = words + env * height;
  long long* o = words_out + env * height;
  uint32_t* placed = staged + warp * height;
  // rows a window: a whole number of region bands; lanes from cr on hold none
  const int cr = region_size > 0 ? 32 - 32 % region_size : 32;
  const bool lane = l < cr;
  bool overlap = false;
  uint32_t cols = kAll;  // the placed rows' column AND, this lane's rows
#pragma unroll 4
  for (int w0 = 0; w0 < height; w0 += cr) {
    const int row = w0 + l;
    if (lane && row < height) {
      const uint32_t x = static_cast<uint32_t>(x64[row]);
      const uint32_t cv = cover(row);
      overlap |= (x & cv) != 0;
      cols &= x | cv;
      if (kStaged) placed[row] = x | cv;
    }
  }
  const bool legal = valid[env] != 0 && !__any_sync(kAll, overlap);
  if (!legal) {  // the input written back, read again (a cache hit)
    for (int row = l; row < height; row += 32) o[row] = x64[row];
    if (l == 0) {
      k_out[env] = 0;
      legal_out[env] = false;
    }
    return;
  }
  cols = __reduce_and_sync(kAll, cols);
  const uint32_t full = shl32(1u, width) - 1u;
  const uint32_t tile0 = shl32(1u, region_size) - 1u;
  const int e = region_size > 0 ? l % region_size : 0;  // row - the band's first row
  int k = __popc(cols);
  int tiles = 0;  // full tiles of the bands whose first row is this lane's
  for (int w0 = 0; w0 < height; w0 += cr) {
    const int row = w0 + l;
    const bool in = lane && row < height;
    uint32_t p = kAll;  // the placed row; no row: the identity of the AND
    if (in) p = kStaged ? placed[row] : static_cast<uint32_t>(x64[row]) | cover(row);
    k += __popc(__ballot_sync(kAll, in && p == full));
    uint32_t reg = 0;  // the band's full tiles
    if (region_size > 0) {
      uint32_t band = kAll;  // rows row - e .. row - e + rs - 1, all in this window
      for (int t = 0; t < region_size; ++t) band &= __shfl_sync(kAll, p, l - e + t);
      if (in && row - e + region_size <= height) {  // a whole band on the board
        for (int i = 0; i + region_size <= width; i += region_size) {
          const uint32_t tile = tile0 << i;
          if ((band & tile) == tile) {
            reg |= tile;
            tiles += e == 0;
          }
        }
      }
    }
    if (in) o[row] = p & ~((p == full ? full : 0u) | cols | reg);
  }
  k += __reduce_add_sync(kAll, tiles);
  if (l == 0) {
    k_out[env] = k;
    legal_out[env] = true;
  }
}

// The legal bits of anchor row `row` of env-slot `es`, read straight from
// device memory: `legal_row_bits` of packed_mask.cu for one thread.
__device__ __forceinline__ uint32_t legal_row_general(
    const long long* __restrict__ words, const int32_t* __restrict__ queue,
    const uint32_t* __restrict__ prow, const int32_t* __restrict__ piece_w, long long es,
    int row, int height, int width, int slots, int num_pieces, int nwords, int fpw) {
  const int pid = queue[es];
  if (pid < 0 || pid >= num_pieces || piece_w[pid] > width) return 0u;
  const int pw = piece_w[pid];
  const uint32_t full = shl32(1u, width) - 1u;
  const long long* x = words + (es / slots) * height;
  uint32_t blocked = 0;
  for (int k = 0; k < nwords; ++k) {
    uint32_t wk = 0;
    for (int f = 0; f < fpw; ++f) {
      const int t = row + k * fpw + f;
      wk |= (t < height ? static_cast<uint32_t>(x[t]) : full) << (f * width);
    }
    for (uint32_t m = prow[pid * nwords + k]; m != 0; m &= m - 1) {
      blocked |= wk >> (__ffs(m) - 1);
    }
  }
  return ~blocked & (shl32(1u, width - pw + 1) - 1u);
}

__global__ void packed_mask_rows_general_kernel(const long long* __restrict__ words,
                                                const int32_t* __restrict__ queue,
                                                const uint32_t* __restrict__ prow,
                                                const int32_t* __restrict__ piece_w,
                                                uint8_t* __restrict__ out,
                                                long long total_rows, int height, int width,
                                                int slots, int num_pieces, int nwords,
                                                int fpw) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total_rows) return;
  const long long es = i / height;
  const int row = static_cast<int>(i - es * height);
  const uint32_t bits = legal_row_general(words, queue, prow, piece_w, es, row, height,
                                          width, slots, num_pieces, nwords, fpw);
  uint8_t* o = out + i * width;
  for (int c = 0; c < width; ++c) o[c] = (bits >> c) & 1u;
}

// The general mask and its words entry (`kWords`): a warp an env-slot
// walking its board in windows of 32 anchor rows.  Lane t first takes the
// columns of piece row t (field t % fpw of footprint word t / fpw: the bits
// of the footprint words, nwords * fpw <= 32 rows), so that every window
// tests each piece row's cells by one shuffle of that mask, not by
// rebuilding footprint words.  A window's board rows and the next window's
// (rows w0 .. w0 + 63, full past the bottom, two a lane in registers, the
// row after next loaded at the window's start) are put in shared memory,
// where lane l reads row l + t for piece row t.  The mask stages the
// window's legal rows beside the previous window's, and every second window
// (or the last) the warp stores the 64 rows' bytes as 16-byte vectors from
// their byte offset `out_at` + es * HW + w * W of `out` (16-byte aligned),
// the ragged edges byte by byte (`store_tall<1>`).  The words entry stores
// lane l's legal row w0 + l as the int64 out[es * H + w0 + l]: one
// coalesced 256-byte store a window, nothing staged.  Two __syncwarp a
// window order the shared rows.
template <bool kWords>
__global__ void __launch_bounds__(kWarps * 32)
    packed_mask_general_kernel(const long long* __restrict__ words,
                               const int32_t* __restrict__ queue,
                               const uint32_t* __restrict__ prow,
                               const int32_t* __restrict__ piece_w,
                               void* __restrict__ out, long long out_at, int total,
                               int height, int width, int slots, int num_pieces,
                               int nwords, int fpw) {
  __shared__ uint32_t board[kWarps][64];  // the window's rows and the next window's
  __shared__ uint32_t legal[kWarps][64];  // two windows' legal rows (the mask's)
  const int l = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int es = blockIdx.x * kWarps + warp;
  if (es >= total) return;  // the whole warp
  const int pid = queue[es];
  const int pw = pid >= 0 && pid < num_pieces ? piece_w[pid] : width + 1;  // none: no anchor
  const uint32_t full = shl32(1u, width) - 1u;
  uint32_t cells = 0;  // lane t: the columns of piece row t
  if (pw <= width && l < nwords * fpw) {
    const int k = bit_rows::small_div(l, __frcp_rn(static_cast<float>(fpw)));
    cells = (prow[pid * nwords + k] >> ((l - k * fpw) * width)) & full;
  }
  const int rows_of_piece = 32 - __clz(__ballot_sync(kAll, cells != 0));
  const uint32_t anchors = pw <= width ? shl32(1u, width - pw + 1) - 1u : 0u;
  const long long* x64 = words + static_cast<long long>(es / slots) * height;
  const long long at = out_at + static_cast<long long>(es) * height * width;
  long long* out64 = static_cast<long long*>(out) + static_cast<long long>(es) * height;
  uint32_t* rows = board[warp];
  uint32_t* staged = legal[warp];
  uint32_t x0 = l < height ? static_cast<uint32_t>(x64[l]) : full;
  uint32_t x1 = 32 + l < height ? static_cast<uint32_t>(x64[32 + l]) : full;
  for (int w0 = 0; w0 < height; w0 += 32) {
    const int r = w0 + 64 + l;  // the row after next, loaded before it is needed
    const uint32_t next = r < height ? static_cast<uint32_t>(x64[r]) : full;
    rows[l] = x0;
    rows[32 + l] = x1;
    __syncwarp();
    uint32_t blocked = 0;  // bit c: a cell of anchor (w0 + l, c) meets the board
    for (int t = 0; t < rows_of_piece; ++t) {
      const uint32_t y = rows[l + t];
      for (uint32_t m = __shfl_sync(kAll, cells, t); m != 0; m &= m - 1) {
        blocked |= y >> (__ffs(m) - 1);
      }
    }
    if constexpr (kWords) {
      if (w0 + l < height) out64[w0 + l] = ~blocked & anchors;
      __syncwarp();  // every lane has read the rows before the next window's
    } else {
      const int half = (w0 >> 5) & 1;
      staged[32 * half + l] = ~blocked & anchors;
      __syncwarp();
      if (half == 1 || w0 + 32 >= height) {  // the pair's rows from w0 & ~63
        const int first = w0 & ~63;
        bit_rows::store_tall<1>(staged, static_cast<uint8_t*>(out),
                                at + static_cast<long long>(first) * width,
                                min(64, height - first) * width, width, l, 32);
      }
    }
    x0 = x1;
    x1 = next;
  }
}

__global__ void packed_words_general_kernel(const long long* __restrict__ words,
                                            const int32_t* __restrict__ queue,
                                            const uint32_t* __restrict__ prow,
                                            const int32_t* __restrict__ piece_w,
                                            long long* __restrict__ out,
                                            long long total_rows, int height, int width,
                                            int slots, int num_pieces, int nwords, int fpw) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total_rows) return;
  const long long es = i / height;
  out[i] = legal_row_general(words, queue, prow, piece_w, es,
                             static_cast<int>(i - es * height), height, width, slots,
                             num_pieces, nwords, fpw);
}

bool tall_args_ok(int height, int width) {
  return height > 32 && height <= kMaxRows && width >= 1 && width <= 32;
}

// The general apply's launch: eight warps a block, an env each; staged,
// as many as the shared memory a block may opt in to holds (H words a warp),
// refused where one warp's rows pass it.
int launch_apply_general(bool staged, const void* words, const void* attrs, const void* r,
                         const void* c, const void* valid, void* words_out, void* k_out,
                         void* legal_out, int n, int height, int width, int region_size,
                         cudaStream_t stream) {
  if (height < 1 || width < 1 || width > 32 || region_size < 0 || region_size > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long row_bytes = 4LL * height;
  const long long fit = kSmemOptIn / row_bytes;  // staged warps that fit
  const int warps = !staged ? kWarps : fit < kWarps ? static_cast<int>(fit) : kWarps;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = staged ? static_cast<int>(warps * row_bytes) : 0;
  const auto kernel = staged ? packed_apply_general_kernel<true>
                             : packed_apply_general_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(n + warps - 1) / warps, warps * 32, smem, stream>>>(
      static_cast<const long long*>(words), static_cast<const int32_t*>(attrs),
      static_cast<const int32_t*>(r), static_cast<const int32_t*>(c),
      static_cast<const uint8_t*>(valid), static_cast<long long*>(words_out),
      static_cast<int32_t*>(k_out), static_cast<uint8_t*>(legal_out), n, height, width,
      region_size);
  return static_cast<int>(cudaGetLastError());
}


// The general mask's launch (`words_out`: its words entry's): the windowed
// kernel eight warps a block, an env-slot each, or the thread-an-anchor-row
// kernel.  The mask's `out` may have any address: the windowed kernel's
// stores take the 16-byte aligned address at or below it and the byte
// offset from there.
int launch_mask_general(bool windowed, bool words_out, const void* words, const void* queue,
                        const void* prow, const void* piece_w, void* out, int n, int height,
                        int width, int slots, int num_pieces, int nwords, int fpw,
                        cudaStream_t stream) {
  if (height < 1 || width < 1 || width > 32 || (windowed && nwords * fpw > 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(n) * slots;
  if (windowed && total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const auto* w = static_cast<const long long*>(words);
  const auto* q = static_cast<const int32_t*>(queue);
  const auto* p = static_cast<const uint32_t*>(prow);
  const auto* pw = static_cast<const int32_t*>(piece_w);
  const long long rows = total * height;
  const auto blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  if (windowed) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(out);
    const uintptr_t base = words_out ? addr : addr & ~static_cast<uintptr_t>(15);
    const auto kernel = words_out ? packed_mask_general_kernel<true>
                                  : packed_mask_general_kernel<false>;
    kernel<<<static_cast<unsigned>((total + kWarps - 1) / kWarps), kWarps * 32, 0, stream>>>(
        w, q, p, pw, reinterpret_cast<void*>(base), static_cast<long long>(addr - base),
        static_cast<int>(total), height, width, slots, num_pieces, nwords, fpw);
  } else if (words_out) {
    packed_words_general_kernel<<<blocks, kThreads, 0, stream>>>(
        w, q, p, pw, static_cast<long long*>(out), rows, height, width, slots, num_pieces,
        nwords, fpw);
  } else {
    packed_mask_rows_general_kernel<<<blocks, kThreads, 0, stream>>>(
        w, q, p, pw, static_cast<uint8_t*>(out), rows, height, width, slots, num_pieces,
        nwords, fpw);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tall mask (`words_out` zero) or its words entry: E = `envs`
// env-slots a block, E * ceil(H / anchor_rows) threads at most
// kMaxAnchorThreads (the mask's span starts on a 16-byte boundary where E *
// HW is a multiple of 16, and the store takes any offset); the mask's out
// 16-byte aligned; 1 <= H <= 128 (the mask: 32 < H), W <= 32, 1 <= S <= 32,
// N*S + E < 2^31,
// nwords * fpw <= 32 and the block's shared memory at most 48 KB.
int launch_anchor(bool words_out, const void* words, const void* queue, const void* prow,
                  const void* piece_w, void* out, int n, int height, int width, int slots,
                  int num_pieces, int nwords, int fpw, int envs, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * slots;
  const int rows = anchor_rows(words_out);
  const int seg = (height + rows - 1) / rows;
  const long long threads = (static_cast<long long>(envs) * seg + 31) / 32 * 32;
  if (height < 1 || height > kMaxRows || width < 1 || width > 32 || envs < 1 ||
      threads > kMaxAnchorThreads ||
      total > INT_MAX - envs || slots < 1 || slots > 32 || nwords < 1 || fpw < 1 ||
      nwords * fpw > 32 ||
      (!words_out && (reinterpret_cast<uintptr_t>(out) & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return static_cast<int>(cudaGetLastError());
  // segments whole in a warp: each warp stages and stores its own
  const bool warp = 32 % seg == 0 && envs % (32 / seg) == 0;
  AnchorShape sh;
  sh.envs = envs;
  sh.seg = seg;
  sh.per = warp ? 32 / seg : envs;
  sh.stride = nwords * fpw - 1 + rows * seg;  // a board and its full rows
  sh.pad = sh.stride - height;
  sh.region = ((sh.per + slots - 2) / slots + 1) * sh.stride;
  sh.group_words = sh.region + (words_out ? 0 : sh.per * height);
  // IEEE division rounds 1 / d as __frcp_rn does (pad 0: no full rows, unread)
  sh.inv_seg = 1.0f / static_cast<float>(seg);
  sh.inv_height = 1.0f / static_cast<float>(height);
  sh.inv_pad = sh.pad > 0 ? 1.0f / static_cast<float>(sh.pad) : 0.0f;
  sh.inv_slots = 1.0f / static_cast<float>(slots);
  sh.slot_magic = 0xffffffffu / static_cast<uint32_t>(slots) + 1u;
  const long long smem = 4LL * (threads / (warp ? 32 : threads)) * sh.group_words;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = words_out ? (warp ? packed_anchor_kernel<true, true>
                                        : packed_anchor_kernel<true, false>)
                                : (warp ? packed_anchor_kernel<false, true>
                                        : packed_anchor_kernel<false, false>);
  kernel<<<static_cast<unsigned>((total + envs - 1) / envs), static_cast<unsigned>(threads),
           static_cast<size_t>(smem), stream>>>(
      static_cast<const long long*>(words), static_cast<const int32_t*>(queue),
      static_cast<const uint32_t*>(prow), static_cast<const int32_t*>(piece_w), out,
      static_cast<int>(total), height, width, slots, num_pieces, nwords, fpw, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tall apply: bp_packed_apply's arguments without per_warp; 32 < H <=
// 128, W <= 32.  One env a warp, eight a block.
extern "C" int bp_packed_apply_tall(const void* words, const void* attrs, const void* r,
                                    const void* c, const void* valid, void* words_out,
                                    void* k_out, void* legal_out, int n, int height,
                                    int width, int region_size, void* stream) {
  if (!tall_args_ok(height, width) || region_size < 0 || region_size > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n + kWarps - 1) / kWarps;
  const auto st = static_cast<cudaStream_t>(stream);
#define BP_APPLY_TALL(NR)                                                                 \
  packed_apply_tall_kernel<NR><<<blocks, kWarps * 32, 0, st>>>(                           \
      static_cast<const long long*>(words), static_cast<const int32_t*>(attrs),          \
      static_cast<const int32_t*>(r), static_cast<const int32_t*>(c),                    \
      static_cast<const uint8_t*>(valid), static_cast<long long*>(words_out),            \
      static_cast<int32_t*>(k_out), static_cast<uint8_t*>(legal_out), n, height, width,  \
      region_size)
  switch ((height + 31) / 32) {
    case 2: BP_APPLY_TALL(2); break;
    case 3: BP_APPLY_TALL(3); break;
    default: BP_APPLY_TALL(4); break;
  }
#undef BP_APPLY_TALL
  return static_cast<int>(cudaGetLastError());
}

// The tall mask: bp_packed_mask's arguments, `envs` env-slots a block
// (kernels/packed.py `anchor_launch_shape`) in place of per_warp and warps;
// out 16-byte aligned; 32 < H <= 128, W <= 32, N*S < 2^31 and the
// footprint words' fields nwords * fpw <= 32.
extern "C" int bp_packed_mask_tall(const void* words, const void* queue, const void* prow,
                                   const void* piece_w, void* out, int n, int height,
                                   int width, int slots, int num_pieces, int nwords,
                                   int fpw, int envs, void* stream) {
  if (!tall_args_ok(height, width)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_anchor(false, words, queue, prow, piece_w, out, n, height, width, slots,
                       num_pieces, nwords, fpw, envs, static_cast<cudaStream_t>(stream));
}

// The tall words entry: bp_packed_words's arguments with `envs` env-slots a
// block in place of per_warp, as bp_packed_mask_tall, on boards of 1 to 128
// rows: the words entry takes it above 32 rows and, on fewer, where
// kernels/packed.py `words_kernel_kind` says (on an H100 it beat the bit-row
// words kernel on 9, 16 and 24 rows and lost to it on 10).
extern "C" int bp_packed_words_tall(const void* words, const void* queue, const void* prow,
                                    const void* piece_w, void* out, int n, int height,
                                    int width, int slots, int num_pieces, int nwords,
                                    int fpw, int envs, void* stream) {
  return launch_anchor(true, words, queue, prow, piece_w, out, n, height, width, slots,
                       num_pieces, nwords, fpw, envs, static_cast<cudaStream_t>(stream));
}

// The general apply, any H >= 1: bp_packed_apply_tall's arguments; the
// placed rows staged in shared memory (`kStaged`) wherever a warp's fit.
extern "C" int bp_packed_apply_general(const void* words, const void* attrs, const void* r,
                                       const void* c, const void* valid, void* words_out,
                                       void* k_out, void* legal_out, int n, int height,
                                       int width, int region_size, void* stream) {
  return launch_apply_general(4LL * height <= kSmemOptIn, words, attrs, r, c, valid,
                              words_out, k_out, legal_out, n, height, width, region_size,
                              static_cast<cudaStream_t>(stream));
}

// The general apply with its pass 2 chosen: `staged` nonzero keeps the
// placed rows in shared memory, zero reads the input rows again.  The
// measurements hold the two bit-equal and time them in turns.
extern "C" int bp_packed_apply_general_pass(const void* words, const void* attrs,
                                            const void* r, const void* c, const void* valid,
                                            void* words_out, void* k_out, void* legal_out,
                                            int n, int height, int width, int region_size,
                                            int staged, void* stream) {
  return launch_apply_general(staged != 0, words, attrs, r, c, valid, words_out, k_out,
                              legal_out, n, height, width, region_size,
                              static_cast<cudaStream_t>(stream));
}

// The general mask, any H >= 1: bp_packed_words_tall's arguments (no
// alignment asked of `out`); the windowed kernel where a footprint spans at
// most 32 rows (nwords * fpw <= 32, every shipped piece set), else the
// thread-an-anchor-row one.
extern "C" int bp_packed_mask_general(const void* words, const void* queue,
                                      const void* prow, const void* piece_w, void* out,
                                      int n, int height, int width, int slots,
                                      int num_pieces, int nwords, int fpw, void* stream) {
  return launch_mask_general(nwords * fpw <= 32, false, words, queue, prow, piece_w, out, n,
                             height, width, slots, num_pieces, nwords, fpw,
                             static_cast<cudaStream_t>(stream));
}

// The general mask with its kernel chosen: `windowed` nonzero takes the
// warp over windows (refused where nwords * fpw > 32), zero the thread an
// anchor row.  The measurements hold the two bit-equal and time them in
// turns.
extern "C" int bp_packed_mask_general_pick(const void* words, const void* queue,
                                           const void* prow, const void* piece_w, void* out,
                                           int n, int height, int width, int slots,
                                           int num_pieces, int nwords, int fpw,
                                           int windowed, void* stream) {
  return launch_mask_general(windowed != 0, false, words, queue, prow, piece_w, out, n,
                             height, width, slots, num_pieces, nwords, fpw,
                             static_cast<cudaStream_t>(stream));
}

// The general words entry, any H >= 1: bp_packed_words_tall's arguments;
// the windowed kernel where a footprint spans at most 32 rows, else the
// thread-an-anchor-row one, as bp_packed_mask_general picks.
extern "C" int bp_packed_words_general(const void* words, const void* queue,
                                       const void* prow, const void* piece_w, void* out,
                                       int n, int height, int width, int slots,
                                       int num_pieces, int nwords, int fpw, void* stream) {
  return launch_mask_general(nwords * fpw <= 32, true, words, queue, prow, piece_w, out, n,
                             height, width, slots, num_pieces, nwords, fpw,
                             static_cast<cudaStream_t>(stream));
}

// The general words entry with its kernel chosen, as
// bp_packed_mask_general_pick.
extern "C" int bp_packed_words_general_pick(const void* words, const void* queue,
                                            const void* prow, const void* piece_w,
                                            void* out, int n, int height, int width,
                                            int slots, int num_pieces, int nwords, int fpw,
                                            int windowed, void* stream) {
  return launch_mask_general(windowed != 0, true, words, queue, prow, piece_w, out, n,
                             height, width, slots, num_pieces, nwords, fpw,
                             static_cast<cudaStream_t>(stream));
}
