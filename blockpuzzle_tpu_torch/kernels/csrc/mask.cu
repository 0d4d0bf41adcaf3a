// Hand action mask: the CUDA port of the TPU kernel `_mask_kernel`
// (blockpuzzle_tpu/kernels/mask.py:57, launched by `_mask_pallas_call`,
// mask.py:85, from `MaskKernel.__call__`).  Six kernels: the bit-row
// kernel (`mask_rows_kernel`, entry `bp_mask_rows`) for boards with H <= 32
// and W <= 32 and pieces of at most 8 rows and 8 columns, every shipped
// preset and piece set; the wide kernel (`mask_wide_kernel`, entry
// `bp_mask_wide`), the bit-row kernel on rows of NW = 2..4 words, for
// H <= 32 and 32 < W <= 128 and the same pieces; the tall kernel
// (`mask_tall_kernel`, entry `bp_mask_tall`), a warp an env-slot, for
// 32 < H <= 128, W <= 128 and the same pieces; the deep kernel
// (`mask_deep_kernel`, entry `bp_mask_deep`), a warp an env-slot walking
// the board in windows of 32 rows, for H > 128, W <= 128 and the same
// pieces wherever a block of one warp or more fits the shared memory a
// block may opt in to with its boards staged whole; the xwide kernel
// (`mask_xwide_kernel`, entry `bp_mask_xwide`), a segment of lanes an
// env-slot and a lane a word of every row, for 128 < W <= 1024, any height
// and the same pieces wherever a block of one warp fits, and on rows of
// 1025 to 4096 cells one env-slot a warp, lane l holding words l + 32 j;
// and the general kernel (`mask_kernel`, entry `bp_mask`) for what is left:
// rows of more than 4096 cells, pieces of more than 8 rows or columns, or a
// deep or xwide board too large for one warp's shared memory.  The
// wrapper (kernels/mask.py) picks one by shape.  The wide, tall, deep and
// xwide kernels are also the all-pieces legality (K4, the TPU kernel
// `_legality_kernel`, blockpuzzle_tpu/kernels/collision.py:41, launched by
// `_legality_pallas_call`, collision.py:50) on those boards: a second
// instance of each (`kEvery`, entries `bp_legality_wide`, `bp_legality_tall`,
// `bp_legality_deep`, `bp_legality_xwide`; the wrapper kernels/collision.py
// `LegalityKernel`), described below the xwide kernel.
//
// What all compute (not how the TPU did it): anchor (r, c) of hand slot s
// is legal iff the slot holds a piece (0 <= pid < P), the piece's bounding
// box lies on the board (r + h <= H, c + w <= W), and every cell of its
// footprint is empty (byte 0; the TPU kernel's occupied count is a sum of
// bytes, 0 iff every byte is).  The output is (N, S*HW) bool, slot-major
// then row-major anchor.  The TPU formulation -- a bf16 one-hot matmul over
// cover_T padded to 128 lanes per piece with a +1024 bias on invalid
// anchors -- exists for Mosaic's layout rules and is not carried over.
//
// Bound on the H100: device memory.  Per env it reads the HW-byte board and
// S int32 piece ids and writes S*HW bool bytes: 204 B per env on the
// default preset (HW = 100, S = 1), 10.0 MB at N = 49152, 3.0 us at
// 3.35 TB/s.
//
// The bit-row kernel.  Every piece is the union of <= 2 rectangles
// (rules.piece_rects: rows dr .. dr + rh - 1, columns dc .. dc + rw - 1 of
// the piece).  With row words built from bytes, no bit >= W is set, so the
// anchors of a whole row are tested at once:
//
//     V_j(r)  = OR_{t in [dr_j, dr_j + rh_j)} row(r + t)        (vertical OR)
//     B_j(r)  = OR_{u < rw_j} V_j(r) >> (dc_j + u)               (smear)
//     legal(r) = ~(B_1 | B_2) & (2^(W - w + 1) - 1)  if r + h <= H, else 0;
//
// bit c of B_j is set iff rectangle j at anchor (r, c) meets an occupied
// cell inside the board, and the anchors whose rectangles leave the board
// on the right are the ones the last mask drops.  The design answers what
// bounded the general kernel and B7 (packed_mask.cu):
//   - one segment of H lanes per (env, slot), lane r = anchor row r, P =
//     32 / H segments a warp (3 at H = 10), instead of a thread per anchor:
//     4.9 M threads at N = 49152 become 0.5 M;
//   - no 64-bit division: per-lane quotients are float reciprocals
//     (`small_div`);
//   - no loop whose trip count depends on the piece, in place of B7's
//     per-footprint-cell loop, whose trip count was the largest of a
//     warp's pieces': max_h shuffles (an unrolled loop, warp-uniform; 5 for
//     classic19), a smear in doubling steps (`smear`), rows packed four
//     bytes a 32-bit load (`pack_row`): together 11% less device time
//     than a byte loop and a loop over each rectangle's columns (H100,
//     default preset, N = 49152);
//   - a block of `warps` warps covers E = warps * P env-slots, the wrapper
//     picking the fewest warps (at least 4) for which E*H*W is a multiple of
//     16 (`mask_block_warps`, as B7): its output is one 16-byte-aligned
//     span.  It copies the boards its env-slots read into shared memory with
//     16-byte loads (`stage_bytes`: any start address; on the shipped
//     presets every block's span starts on a 16-byte boundary), each lane
//     packs its row from there, and the legal rows, staged as bit words,
//     leave as 16-byte vectors of 0/1 bytes (`store_rows`).
// Every lane runs every shuffle and barrier; lanes past the last env-slot
// and the 32 - P*H left-over lanes compute on no env-slot and store nothing.
//
// The wide kernel is the same on a row held as NW 32-bit words, NW a
// template parameter: NW packs a row (`pack_row` from 32 i bytes into it,
// min(32, W - 32 i) cells), NW * max_h shuffles, and each shift of the
// smear and by dc a shift of the NW-word number (`shr_words`: word i takes
// the low bits of word i + 1 by a funnel shift, the top word zeros; a
// rectangle of width <= 8 never moves a bit across more than one word
// boundary); the legal row's mask is built a word at a time with no shift
// by 32 (W = 64, 128, or W - w + 1 >= 32 (i + 1)).  Legal rows are staged
// as NW words a row and stored as 16-byte vectors (`store_words`).  It
// answers what bounded the general kernel on such boards: 15.7 M threads
// of 64-bit index arithmetic and chains of up to 9 dependent byte loads at
// N = 49152 on 8x40, every board byte read again by each anchor whose
// footprint covers it.  A block that needs more than 48 KB of shared
// memory (16 warps, odd H and W near 128) opts in to it.
//
// The tall kernel carries the same test to boards of 33 to 128 rows, where
// a segment of H lanes no longer fits a warp: one warp an env-slot, lane l
// holding rows l + 32 j in slot j < NR = ceil(H / 32) (NR, NW template
// parameters, 2..4 and 1..4), each as NW words.  Row r + t of the vertical
// OR comes from lane (l + t) mod 32, from slot j + 1 where l + t >= 32 (the
// seam; `bit_rows::rows_below`, one shuffle a slot and word for every t).
// The smear and dc shift are the wide kernel's, a slot at a time; legal
// rows are staged as NW words a row and stored as 16-byte vectors from the
// block's byte offset (`bit_rows::store_tall`: the block's span may start
// off a 16-byte boundary, so any number of warps a block fits).  It answers
// what bounded the general kernel on tall boards: a thread an anchor (14.6
// M threads on 33x9 at N = 49152), 64-bit index arithmetic and a chain of
// dependent byte loads each.
//
// The deep kernel is the tall kernel with its NR register slots turned
// into a loop over windows of 32 anchor rows, from the top down, so that
// registers do not grow with H: the warp holds two slots, rows 32 j + l
// and 32 (j + 1) + l, enough because a piece spans at most 8 rows, so
// row r + t (t < 8) of window j lies in slot j or j + 1 (`rows_below` on
// the pair).  After a window's legal rows are staged the second slot moves
// into the first and the next window is packed into the second; rows past
// the bottom pack as 0 and no anchor reaches them (r + h <= H).  The
// block's boards are staged whole, as in the tall kernel, and the block's
// warps and turns are the tall kernel's choice (`kernels/packed.py`
// `deep_launch_shape`), down to one warp where four do not fit; a block
// above 48 KB opts in.  It answers what bounded the general kernel on such
// boards: 51 M threads of 64-bit `%` and `/` on 130x8 at N = 49152, each a
// chain of up to 9 dependent byte loads.
//
// The xwide kernel turns the bit-row layout around for rows of 129 to 1024
// cells, where a lane's registers cannot hold a row: a segment of NW =
// ceil(W / 32) lanes takes an env-slot, 32 / NW segments a warp (6 at
// NW = 5 on 8x136, 30 of 32 lanes live), and lane w holds word w of every
// row, so no register array grows with W or H.  The block loads its envs'
// boards as 16-byte vectors straight into row words in shared memory
// (`bit_rows::stage_words`: 16 bits a vector, ORed into the words they fall
// in), with no staged copy of the bytes, so that a board takes 160 bytes of
// shared memory on 8x136 instead of 1088 and more boards fit an SM; the S
// slots of an env read the same words.  A
// lane walks the anchor rows in a runtime loop holding the 8 rows below the
// anchor row (one shared load a row); the vertical OR of each rectangle is
// lane-local, and its smear and dc shift take the next word from lane
// w + 1 by one `__shfl_down_sync` (a piece of at most 8 columns moves a bit
// by at most 7 + 7 < 32 columns, so only the next word reaches a word), in
// the wide kernel's doubling steps on the pair (`smear_words<2>`,
// `shr_words<2>`).  Legal words are staged as NW words a row and leave as
// 16-byte vectors from the block's byte offset (`store_words_n`: an output
// row of 136 bytes starts off a 16-byte boundary).  Every lane runs every
// shuffle and barrier; lanes of no env-slot read env 0's words and store
// nothing.  It answers what bounded the general kernel on such boards: a
// thread an anchor (53.5 M threads on 8x136 at N = 49152), 64-bit `%` and
// `/`, and a chain of dependent byte loads each, every board byte read
// again by each anchor whose footprint covers it.  A block is 4 warps
// (`kernels/packed.py` `xwide_launch_shape`: in turns on the card they beat
// 16, whose barriers hold more warps waiting); the entry opts in above 48
// KB, which no board of at most 32 rows needs.
//
// Rows of 1025 to 4096 cells (NW = 33 to 128 words) pass a warp's 32
// lanes: the same kernel with NJ = ceil(NW / 32) slots a lane (a template
// parameter; NJ = 1 is the segment form above), one env-slot a warp, lane
// l holding words l + 32 j of every row in slot j.  The words are strided,
// as in the xwide clear (clear.cu), so that every lane works and only the
// last slot is ragged: a slot past word NW - 1 reads 0 and stores nothing.
// The vertical OR is lane-local a slot at a time, each row's words read
// from shared memory on every trip (a ring of the 8 rows below of each slot,
// 8 NJ registers, was 4-29% slower in turns on an H100, PERF.md §6), and
// the word w + 1 that the smear and dc shift of word w need is the next
// lane's slot j, but lane 0's slot j + 1 for lane 31: one `__shfl_sync` a
// slot and rectangle from lane l + 1 mod 32, in place of the segment's
// `__shfl_down_sync`.  It answers
// what bounded the general kernel there, as on 8x136: a thread an anchor
// (103.8 M threads on 2x1056 at N = 49152), 64-bit `%` and `/`, a chain of
// dependent byte loads each.
//
// Nothing in the row loop depends on H, so the same kernel takes boards of
// any height (40x136: the anchor rows of a board of more than 32 rows, 40
// trips of the loop).  What grows with H is the block's shared memory: the
// staged row words of its envs and the legal rows of its env-slots, H * NW
// words each.  Where S = 1 an env-slot's legal rows go over its board's
// row words in place: a lane alone reads and writes its words of its
// env-slot's rows, and it writes legal row r after it has read rows
// r .. r + 7 (into the ring, or on that trip), so no row is written before
// its last read; that halves the
// block (19,200 bytes at 40x136 for 4 warps, 39,200 with two arrays).
// Where a block of 4 warps passes what a block may opt in to, the launch
// shape takes fewer warps; where one warp does not fit, or a block would
// stage or store 2^21 bytes or more (`small_div`), the general kernel runs.
//
// The every-piece instances compute K4's (N, P, HW) legality map as the
// hand mask of a hand that holds every piece: env-slot q takes piece
// q mod P (`slot_piece`), slots = P, no hand is read, and everything else
// is the mask's (the staged boards, the rectangle smear, the legal rows,
// the stores; the launch shapes are the mask's at S = P).  The xwide
// instance takes boards of any height, as the mask does: a block of 24
// env-slots (classic19 on 40x136) reads at most 3 envs, whose rows are
// staged once and read by all their slots (21,600 bytes a block of 4
// warps), so no env's rows are packed again for each piece; on rows of
// 1025 to 4096 cells a warp takes one (env, piece), and a block of 4 warps
// reads at most 2 envs at P = 5 (mini5 on 2x1056).  Bound on the
// H100: device memory; per env they read HW board bytes and write P*HW
// bools, 314.6 MB on 8x40, 1069.5 MB on 8x136 and 5347.7 MB on 40x136 at
// N = 49152 (93.9, 319.3 and 1596.3 us at 3.35 TB/s; the function's
// operations, an env's rows packed once, come to 36.8 and 109.5 us on the
// first two at the integer rate, `utils/bounds.py`; the wide, tall and deep
// instances repack an env's rows for each piece).  They answer
// what bounded the general legality kernel (legality.cu) on such boards:
// a thread an (env, piece, anchor), 298.8 M threads on 8x40 at N = 49152,
// each with 64-bit `%` and `/`, its piece's row of the table and a chain
// of up to 5 dependent byte loads, every board byte read again by each
// anchor whose footprint covers it.
//
// The general kernel: one thread per (env, slot, anchor), flat over
// N*S*HW.  Each thread reads its piece's (h, w, cell offsets) row from a
// small table (P rows of 3+maxc int32, L1-resident) and tests at most maxc
// (9 for classic19) board bytes (`piece_fits`, piece_fits.cuh, shared with
// the legality kernel).  Per-thread work (64-bit index arithmetic, a
// data-dependent chain of byte loads) bounds it, not bytes.  It is left to
// the shapes no other kernel takes: W > 4096, pieces larger than 8, or a
// deep or xwide board whose one-warp block does not fit shared memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bit_rows.cuh"
#include "piece_fits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPiece = 8;  // rows and columns of a piece the bit-row kernel takes
constexpr long long kSmemOptIn = 227 * 1024;  // shared memory a block may opt in to
using bit_rows::kAll;

// OR_{u < rw} v >> u for 0 <= rw <= 8 (0 for rw = 0): doubling steps cover
// 2 and 4 columns, and the widest step k <= rw ORed with itself shifted by
// rw - k covers the rest.
__device__ __forceinline__ uint32_t smear(uint32_t v, int rw) {
  const uint32_t s2 = v | v >> 1;
  const uint32_t s4 = s2 | s2 >> 2;
  const uint32_t s = rw >= 4 ? s4 : rw >= 2 ? s2 : v;
  const int k = rw >= 4 ? 4 : rw >= 2 ? 2 : 1;
  return rw > 0 ? s | s >> (rw - k) : 0u;
}

// The piece of env-slot q (env q / slots, slot q % slots): the id its hand
// holds, or in the every-piece instances (kEvery, slots = P, no hand read)
// piece q % P, so that the output is K4's (N, P, HW) legality map.
template <bool kEvery>
__device__ __forceinline__ int slot_piece(const int32_t* __restrict__ queue, int q, int slots) {
  return kEvery ? q % slots : queue[q];
}

__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    mask_rows_kernel(const uint8_t* __restrict__ board,
                     const int32_t* __restrict__ queue,
                     const int4* __restrict__ pieces,
                     uint8_t* __restrict__ out, int total, int height,
                     int width, int slots, int num_pieces, int max_h,
                     int max_w, int per_warp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int per_block = blockDim.x / 32 * per_warp;
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem);  // E*H legal-bit words
  uint8_t* span = bit_rows::staged_span(smem, per_block * height);
  const int hw = height * width;
  const int first = blockIdx.x * per_block;            // first env-slot
  const int count = min(per_block, total - first);     // env-slots here
  const int env0 = first / slots;                      // first env read
  const long long lo = static_cast<long long>(env0) * hw;
  const long long hi = static_cast<long long>((first + count - 1) / slots + 1) * hw;
  const int d = bit_rows::stage_bytes(board, lo, hi, span);

  const int l = threadIdx.x % 32;
  const int s = bit_rows::small_div(l, __frcp_rn(static_cast<float>(height)));  // per_warp: left over
  const int lane = l - s * height;                     // anchor row
  const int seg = threadIdx.x / 32 * per_warp + s;     // env-slot in the block
  const bool active = s < per_warp && seg < count;
  const int pid = active ? queue[first + seg] : -1;
  // piece row [h, w, rect 1, rect 2], each rect dr | dc << 8 | rh << 16 |
  // rw << 24; no piece: no anchor
  const int4 pc = pid >= 0 && pid < num_pieces ? pieces[pid]
                                                : make_int4(height + 1, width + 1, 0, 0);
  __syncthreads();
  uint32_t x = 0;
  if (active) {
    const int q = first - env0 * slots + seg;  // env in the span: q / slots
    const int env = slots <= 32 ? bit_rows::small_div(q, __frcp_rn(static_cast<float>(slots)))
                                : q / slots;
    x = bit_rows::pack_row(span, d + env * hw + lane * width, width);
  }
  const unsigned r1 = static_cast<unsigned>(pc.z), r2 = static_cast<unsigned>(pc.w);
  const int dr1 = r1 & 0xff, rh1 = (r1 >> 16) & 0xff;
  const int dr2 = r2 & 0xff, rh2 = (r2 >> 16) & 0xff;
  // vertical OR over each rectangle's rows; a row past the bottom reads
  // another segment's word, and such an anchor fails r + h <= H below
  uint32_t v1 = 0, v2 = 0;
#pragma unroll
  for (int t = 0; t < kMaxPiece; ++t) {
    if (t < max_h) {
      const uint32_t y = __shfl_sync(kAll, x, l + t);
      v1 |= static_cast<unsigned>(t - dr1) < static_cast<unsigned>(rh1) ? y : 0u;
      v2 |= static_cast<unsigned>(t - dr2) < static_cast<unsigned>(rh2) ? y : 0u;
    }
  }
  // horizontal smear: bit c blocked iff a rectangle cell of anchor c meets
  // the board
  const int dc1 = (r1 >> 8) & 0xff, rw1 = r1 >> 24;
  const int dc2 = (r2 >> 8) & 0xff, rw2 = r2 >> 24;
  const uint32_t blocked = smear(v1, rw1) >> dc1 | smear(v2, rw2) >> dc2;
  const int anchors = width - pc.y + 1;  // columns c with c + w <= W
  if (active) {  // bit c: anchor (lane, c) is legal
    rows[seg * height + lane] =
        lane + pc.x <= height && anchors > 0
            ? ~blocked & ((anchors < 32 ? 1u << anchors : 0u) - 1u)
            : 0u;
  }
  __syncthreads();
  bit_rows::store_rows(rows, out + static_cast<long long>(first) * hw, count * hw, width);
}

// v >> k for the NW-word number v (word 0 lowest), 0 <= k < 32: word i
// takes the low k bits of word i + 1, the top word zeros.
template <int NW>
__device__ __forceinline__ void shr_words(uint32_t (&v)[NW], int k) {
#pragma unroll
  for (int i = 0; i < NW; ++i) v[i] = __funnelshift_r(v[i], i + 1 < NW ? v[i + 1] : 0u, k);
}

// `smear` on the NW-word number v, in place: every shift a `shr_words`.
template <int NW>
__device__ __forceinline__ void smear_words(uint32_t (&v)[NW], int rw) {
  uint32_t s2[NW], s4[NW], s[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) s2[i] = v[i];
  shr_words(s2, 1);
#pragma unroll
  for (int i = 0; i < NW; ++i) s2[i] |= v[i], s4[i] = s2[i];
  shr_words(s4, 2);
#pragma unroll
  for (int i = 0; i < NW; ++i) s4[i] |= s2[i], s[i] = rw >= 4 ? s4[i] : rw >= 2 ? s2[i] : v[i];
  const int k = rw >= 4 ? 4 : rw >= 2 ? 2 : 1;
#pragma unroll
  for (int i = 0; i < NW; ++i) v[i] = s[i];
  shr_words(v, rw > 0 ? rw - k : 0);
#pragma unroll
  for (int i = 0; i < NW; ++i) v[i] = rw > 0 ? v[i] | s[i] : 0u;
}

template <int NW, bool kEvery>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    mask_wide_kernel(const uint8_t* __restrict__ board,
                     const int32_t* __restrict__ queue,
                     const int4* __restrict__ pieces,
                     uint8_t* __restrict__ out, int total, int height,
                     int width, int slots, int num_pieces, int max_h,
                     int per_warp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int per_block = blockDim.x / 32 * per_warp;
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem);  // E*H legal rows of NW words
  uint8_t* span = bit_rows::staged_span(smem, per_block * height * NW);
  const int hw = height * width;
  const int first = blockIdx.x * per_block;            // first env-slot
  const int count = min(per_block, total - first);     // env-slots here
  const int env0 = first / slots;                      // first env read
  const long long lo = static_cast<long long>(env0) * hw;
  const long long hi = static_cast<long long>((first + count - 1) / slots + 1) * hw;
  const int d = bit_rows::stage_bytes(board, lo, hi, span);

  const int l = threadIdx.x % 32;
  const int s = bit_rows::small_div(l, __frcp_rn(static_cast<float>(height)));  // per_warp: left over
  const int lane = l - s * height;                     // anchor row
  const int seg = threadIdx.x / 32 * per_warp + s;     // env-slot in the block
  const bool active = s < per_warp && seg < count;
  const int pid = active ? slot_piece<kEvery>(queue, first + seg, slots) : -1;
  // piece row [h, w, rect 1, rect 2] as in mask_rows_kernel; no piece: no anchor
  const int4 pc = pid >= 0 && pid < num_pieces ? pieces[pid]
                                                : make_int4(height + 1, width + 1, 0, 0);
  __syncthreads();
  uint32_t x[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) x[i] = 0;
  if (active) {
    const int q = first - env0 * slots + seg;  // env in the span: q / slots
    const int env = slots <= 32 ? bit_rows::small_div(q, __frcp_rn(static_cast<float>(slots)))
                                : q / slots;
    const int at = d + env * hw + lane * width;
#pragma unroll
    for (int i = 0; i + 1 < NW; ++i) x[i] = bit_rows::pack_row(span, at + 32 * i, 32);
    x[NW - 1] = bit_rows::pack_row(span, at + 32 * (NW - 1), width - 32 * (NW - 1));
  }
  const unsigned r1 = static_cast<unsigned>(pc.z), r2 = static_cast<unsigned>(pc.w);
  const int dr1 = r1 & 0xff, rh1 = (r1 >> 16) & 0xff;
  const int dr2 = r2 & 0xff, rh2 = (r2 >> 16) & 0xff;
  // vertical OR over each rectangle's rows, word by word; a row past the
  // bottom reads another segment's words, and such an anchor fails
  // r + h <= H below
  uint32_t v1[NW], v2[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) v1[i] = v2[i] = 0;
#pragma unroll
  for (int t = 0; t < kMaxPiece; ++t) {
    if (t < max_h) {
      const bool in1 = static_cast<unsigned>(t - dr1) < static_cast<unsigned>(rh1);
      const bool in2 = static_cast<unsigned>(t - dr2) < static_cast<unsigned>(rh2);
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const uint32_t y = __shfl_sync(kAll, x[i], l + t);
        v1[i] |= in1 ? y : 0u;
        v2[i] |= in2 ? y : 0u;
      }
    }
  }
  // horizontal smear and shift by dc: bit c blocked iff a rectangle cell of
  // anchor c meets the board
  smear_words(v1, r1 >> 24);
  shr_words(v1, (r1 >> 8) & 0xff);
  smear_words(v2, r2 >> 24);
  shr_words(v2, (r2 >> 8) & 0xff);
  const int anchors = width - pc.y + 1;  // columns c with c + w <= W
  const bool fits = lane + pc.x <= height && anchors > 0;
  if (active) {  // bit c of the row: anchor (lane, c) is legal
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int a = anchors - 32 * i;    // anchors in word i: min(max(a, 0), 32)
      const uint32_t span_mask = a >= 32 ? kAll : a > 0 ? (1u << a) - 1u : 0u;
      rows[(seg * height + lane) * NW + i] = fits ? ~(v1[i] | v2[i]) & span_mask : 0u;
    }
  }
  __syncthreads();
  bit_rows::store_words<NW>(rows, out + static_cast<long long>(first) * hw, count * hw, width);
}

template <int NR, int NW, bool kEvery>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    mask_tall_kernel(const uint8_t* __restrict__ board,
                     const int32_t* __restrict__ queue,
                     const int4* __restrict__ pieces,
                     uint8_t* __restrict__ out, int total, int height,
                     int width, int slots, int num_pieces, int max_h,
                     int per_warp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warps = blockDim.x / 32;
  const int per_block = warps * per_warp;              // env-slots: per_warp a warp
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem);  // E*H legal rows of NW words
  uint8_t* span = bit_rows::staged_span(smem, per_block * height * NW);
  const int hw = height * width;
  const int first = blockIdx.x * per_block;            // first env-slot
  const int count = min(per_block, total - first);     // env-slots here
  const int env0 = first / slots;                      // first env read
  const long long lo = static_cast<long long>(env0) * hw;
  const long long hi = static_cast<long long>((first + count - 1) / slots + 1) * hw;
  const int d = bit_rows::stage_bytes(board, lo, hi, span);

  const int l = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // lane it loads the piece of the warp's env-slot of round it, it * warps + warp
  const int pids = l < per_warp && l * warps + warp < count
                       ? slot_piece<kEvery>(queue, first + l * warps + warp, slots)
                       : -1;
  __syncthreads();
  for (int it = 0; it < per_warp; ++it) {
    const int seg = it * warps + warp;                 // env-slot in the block
    const bool active = seg < count;
    const int pid = __shfl_sync(kAll, pids, it);
    // piece row [h, w, rect 1, rect 2] as in mask_rows_kernel; no piece: no anchor
    const int4 pc = pid >= 0 && pid < num_pieces ? pieces[pid]
                                                  : make_int4(height + 1, width + 1, 0, 0);
    // slot j: board row l + 32 j; rows past the bottom read 0, and such an
    // anchor fails r + h <= H below
    uint32_t x[NR][NW];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int i = 0; i < NW; ++i) x[j][i] = 0;
    }
    if (active) {
      const int q = first - env0 * slots + seg;  // env in the span: q / slots
      const int env = slots <= 32 ? bit_rows::small_div(q, __frcp_rn(static_cast<float>(slots)))
                                  : q / slots;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int r = l + 32 * j;
        if (r < height) {
          const int at = d + env * hw + r * width;
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            x[j][i] = bit_rows::pack_row(span, at + 32 * i, min(32, width - 32 * i));
          }
        }
      }
    }
    const unsigned r1 = static_cast<unsigned>(pc.z), r2 = static_cast<unsigned>(pc.w);
    const int dr1 = r1 & 0xff, rh1 = (r1 >> 16) & 0xff;
    const int dr2 = r2 & 0xff, rh2 = (r2 >> 16) & 0xff;
    // vertical OR over each rectangle's rows, word by word: row r + t across
    // the seam (`rows_below`)
    uint32_t v1[NR][NW], v2[NR][NW];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int i = 0; i < NW; ++i) v1[j][i] = v2[j][i] = 0;
    }
#pragma unroll
    for (int t = 0; t < kMaxPiece; ++t) {
      if (t < max_h) {
        const bool in1 = static_cast<unsigned>(t - dr1) < static_cast<unsigned>(rh1);
        const bool in2 = static_cast<unsigned>(t - dr2) < static_cast<unsigned>(rh2);
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          uint32_t v[NR], y[NR];
#pragma unroll
          for (int j = 0; j < NR; ++j) v[j] = x[j][i];
          bit_rows::rows_below<NR>(v, t, 0u, y);
#pragma unroll
          for (int j = 0; j < NR; ++j) {
            v1[j][i] |= in1 ? y[j] : 0u;
            v2[j][i] |= in2 ? y[j] : 0u;
          }
        }
      }
    }
    const int anchors = width - pc.y + 1;  // columns c with c + w <= W
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      // horizontal smear and shift by dc: bit c blocked iff a rectangle cell
      // of anchor c meets the board
      smear_words<NW>(v1[j], r1 >> 24);
      shr_words<NW>(v1[j], (r1 >> 8) & 0xff);
      smear_words<NW>(v2[j], r2 >> 24);
      shr_words<NW>(v2[j], (r2 >> 8) & 0xff);
      const int r = l + 32 * j;
      const bool fits = r + pc.x <= height && anchors > 0;
      if (active && r < height) {  // bit c of the row: anchor (r, c) is legal
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const int a = anchors - 32 * i;  // anchors in word i: min(max(a, 0), 32)
          const uint32_t span_mask = a >= 32 ? kAll : a > 0 ? (1u << a) - 1u : 0u;
          rows[(seg * height + r) * NW + i] = fits ? ~(v1[j][i] | v2[j][i]) & span_mask : 0u;
        }
      }
    }
  }
  __syncthreads();
  bit_rows::store_tall<NW>(rows, out, static_cast<long long>(first) * hw, count * hw, width);
}

// Window `w` of the staged board that starts at span[at]: lane l's row
// 32 w + l as NW words, 0 past the bottom.
template <int NW>
__device__ __forceinline__ void pack_window(const uint8_t* span, int at, int w, int height,
                                            int width, uint32_t (&x)[NW]) {
  const int r = 32 * w + threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    x[i] = r < height ? bit_rows::pack_row(span, at + r * width + 32 * i,
                                           min(32, width - 32 * i))
                      : 0u;
  }
}

template <int NW, bool kEvery>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    mask_deep_kernel(const uint8_t* __restrict__ board,
                     const int32_t* __restrict__ queue,
                     const int4* __restrict__ pieces,
                     uint8_t* __restrict__ out, int total, int height,
                     int width, int slots, int num_pieces, int max_h,
                     int per_warp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warps = blockDim.x / 32;
  const int per_block = warps * per_warp;              // env-slots: per_warp a warp
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem);  // E*H legal rows of NW words
  uint8_t* span = bit_rows::staged_span(smem, per_block * height * NW);
  const int hw = height * width;
  const int first = blockIdx.x * per_block;            // first env-slot
  const int count = min(per_block, total - first);     // env-slots here
  const int env0 = first / slots;                      // first env read
  const long long lo = static_cast<long long>(env0) * hw;
  const long long hi = static_cast<long long>((first + count - 1) / slots + 1) * hw;
  const int d = bit_rows::stage_bytes(board, lo, hi, span);

  const int l = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // lane it loads the piece of the warp's env-slot of round it, it * warps + warp
  const int pids = l < per_warp && l * warps + warp < count
                       ? slot_piece<kEvery>(queue, first + l * warps + warp, slots)
                       : -1;
  __syncthreads();
  const int windows = (height + 31) / 32;
  for (int it = 0; it < per_warp; ++it) {
    const int seg = it * warps + warp;                 // env-slot in the block
    if (seg >= count) break;                           // the whole warp
    const int pid = __shfl_sync(kAll, pids, it);
    // piece row [h, w, rect 1, rect 2] as in mask_rows_kernel; no piece: no anchor
    const int4 pc = pid >= 0 && pid < num_pieces ? pieces[pid]
                                                  : make_int4(height + 1, width + 1, 0, 0);
    const int q = first - env0 * slots + seg;  // env in the span: q / slots
    const int env = slots <= 32 ? bit_rows::small_div(q, __frcp_rn(static_cast<float>(slots)))
                                : q / slots;
    const int at = d + env * hw;               // the board's first byte in the span
    const unsigned r1 = static_cast<unsigned>(pc.z), r2 = static_cast<unsigned>(pc.w);
    const int dr1 = r1 & 0xff, rh1 = (r1 >> 16) & 0xff;
    const int dr2 = r2 & 0xff, rh2 = (r2 >> 16) & 0xff;
    const int anchors = width - pc.y + 1;      // columns c with c + w <= W
    // the two slots: rows 32 j + l (x[0]) and 32 (j + 1) + l (x[1])
    uint32_t x[2][NW];
    pack_window<NW>(span, at, 0, height, width, x[0]);
    pack_window<NW>(span, at, 1, height, width, x[1]);
    for (int j = 0; j < windows; ++j) {
      // vertical OR over each rectangle's rows, word by word: row r + t
      // across the seam from the second slot (`rows_below`)
      uint32_t v1[NW], v2[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) v1[i] = v2[i] = 0;
#pragma unroll
      for (int t = 0; t < kMaxPiece; ++t) {
        if (t < max_h) {
          const bool in1 = static_cast<unsigned>(t - dr1) < static_cast<unsigned>(rh1);
          const bool in2 = static_cast<unsigned>(t - dr2) < static_cast<unsigned>(rh2);
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            const uint32_t v[2] = {x[0][i], x[1][i]};
            uint32_t y[2];
            bit_rows::rows_below<2>(v, t, 0u, y);
            v1[i] |= in1 ? y[0] : 0u;
            v2[i] |= in2 ? y[0] : 0u;
          }
        }
      }
      // horizontal smear and shift by dc: bit c blocked iff a rectangle cell
      // of anchor c meets the board
      smear_words<NW>(v1, r1 >> 24);
      shr_words<NW>(v1, (r1 >> 8) & 0xff);
      smear_words<NW>(v2, r2 >> 24);
      shr_words<NW>(v2, (r2 >> 8) & 0xff);
      const int r = 32 * j + l;
      const bool fits = r + pc.x <= height && anchors > 0;
      if (r < height) {  // bit c of the row: anchor (r, c) is legal
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const int a = anchors - 32 * i;  // anchors in word i: min(max(a, 0), 32)
          const uint32_t span_mask = a >= 32 ? kAll : a > 0 ? (1u << a) - 1u : 0u;
          rows[(seg * height + r) * NW + i] = fits ? ~(v1[i] | v2[i]) & span_mask : 0u;
        }
      }
      // the next window: the second slot moves up, the one after it comes in
#pragma unroll
      for (int i = 0; i < NW; ++i) x[0][i] = x[1][i];
      pack_window<NW>(span, at, j + 2, height, width, x[1]);
    }
  }
  __syncthreads();
  bit_rows::store_tall<NW>(rows, out, static_cast<long long>(first) * hw, count * hw, width);
}

template <bool kEvery, int NJ>
__global__ void __launch_bounds__(bit_rows::kMaxWarps * 32)
    mask_xwide_kernel(const uint8_t* __restrict__ board,
                      const int32_t* __restrict__ queue,
                      const int4* __restrict__ pieces,
                      uint8_t* __restrict__ out, int total, int height,
                      int width, int slots, int num_pieces, int max_h,
                      int per_warp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nw = (width + 31) / 32;
  const int per_block = blockDim.x / 32 * per_warp;
  const int hw = height * width;
  const int first = blockIdx.x * per_block;            // first env-slot
  const int count = min(per_block, total - first);     // env-slots here
  const int env0 = first / slots;                      // first env read
  const int envs = (first + count - 1) / slots + 1 - env0;  // envs read
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem);  // E*H legal rows of NW words
  // the envs' rows of NW words; where S = 1 the legal rows go over them
  // (env-slot e reads env e's rows, each word only from the lane that holds it)
  uint32_t* words = slots == 1 ? rows : rows + per_block * height * nw;
  const long long lo = static_cast<long long>(env0) * hw;
  bit_rows::stage_words(board, lo, lo + static_cast<long long>(envs) * hw, width, nw, words);

  // t.lane: the word of slot 0; NJ > 1 takes one env-slot a warp (per_warp 1)
  const bit_rows::Seat t = bit_rows::seat(NJ == 1 ? nw : 32, NJ == 1 ? per_warp : 1);
  const bool active = t.s < per_warp && t.seg < count;
  const int pid = active ? slot_piece<kEvery>(queue, first + t.seg, slots) : -1;
  // piece row [h, w, rect 1, rect 2] as in mask_rows_kernel; no piece: no anchor
  const int4 pc = pid >= 0 && pid < num_pieces ? pieces[pid]
                                                : make_int4(height + 1, width + 1, 0, 0);
  __syncthreads();
  int env = 0;  // its board among the block's; a lane of no env-slot reads board 0, stores nothing
  if (active) {
    const int q = first - env0 * slots + t.seg;
    env = slots <= 32 ? bit_rows::small_div(q, __frcp_rn(static_cast<float>(slots)))
                      : q / slots;
  }
  // row r's word of slot j: x[r * nw + 32 j]
  const uint32_t* x = words + env * height * nw + t.lane;
  const unsigned r1 = static_cast<unsigned>(pc.z), r2 = static_cast<unsigned>(pc.w);
  const int dr1 = r1 & 0xff, rh1 = (r1 >> 16) & 0xff, dc1 = (r1 >> 8) & 0xff, rw1 = r1 >> 24;
  const int dr2 = r2 & 0xff, rh2 = (r2 >> 16) & 0xff, dc2 = (r2 >> 8) & 0xff, rw2 = r2 >> 24;
  bool has[NJ], last[NJ];                              // slot j holds word w < NW; w = NW - 1
  uint32_t span_mask[NJ];                              // anchors c + w <= W in word w
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int w = t.lane + 32 * j;
    has[j] = NJ == 1 || j + 1 < NJ || w < nw;
    last[j] = w + 1 == nw;
    const int a = width - pc.y + 1 - 32 * w;
    span_mask[j] = a >= 32 ? kAll : a > 0 ? (1u << a) - 1u : 0u;
  }
  // NJ = 1: rows r .. r + 7 of the lane's word in a ring of registers, 0
  // past the bottom (such an anchor fails r + h <= H below); NJ > 1 reads
  // each row's words from shared memory on every trip, 0 past the bottom
  // and in a slot of no word (faster on the card than a ring of 8 NJ)
  uint32_t below[kMaxPiece];
  if constexpr (NJ == 1) {
#pragma unroll
    for (int i = 0; i < kMaxPiece; ++i) below[i] = i < height ? x[i * nw] : 0u;
  }
  for (int r = 0; r < height; ++r) {
    // vertical OR over each rectangle's rows, lane-local, a slot at a time
    uint32_t v1[NJ], v2[NJ], n1[NJ], n2[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      v1[j] = v2[j] = 0u;
#pragma unroll
      for (int i = 0; i < kMaxPiece; ++i) {
        if (i < max_h) {
          uint32_t y;
          if constexpr (NJ == 1) {
            y = below[i];
          } else {
            y = has[j] && r + i < height ? x[(r + i) * nw + 32 * j] : 0u;
          }
          v1[j] |= static_cast<unsigned>(i - dr1) < static_cast<unsigned>(rh1) ? y : 0u;
          v2[j] |= static_cast<unsigned>(i - dr2) < static_cast<unsigned>(rh2) ? y : 0u;
        }
      }
    }
    // the next word w + 1 of each slot's word w: the next lane's (one
    // `__shfl_down_sync`) where a segment holds the row; with NJ > 1 the
    // next lane's slot j, but lane 0's slot j + 1 for lane 31 (one
    // `__shfl_sync` a slot from lane l + 1 mod 32)
    if constexpr (NJ == 1) {
      n1[0] = __shfl_down_sync(kAll, v1[0], 1);
      n2[0] = __shfl_down_sync(kAll, v2[0], 1);
    } else {
      uint32_t rot1[NJ], rot2[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        rot1[j] = __shfl_sync(kAll, v1[j], (t.l + 1) & 31);
        rot2[j] = __shfl_sync(kAll, v2[j], (t.l + 1) & 31);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        n1[j] = t.l < 31 ? rot1[j] : j + 1 < NJ ? rot1[j + 1] : 0u;
        n2[j] = t.l < 31 ? rot2[j] : j + 1 < NJ ? rot2[j + 1] : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      // smear and shift by dc on the pair (word w, word w + 1): they move
      // bits down by at most 7 + 7 < 32 columns, so no word past the next
      // one reaches word w; the top word's next is 0
      uint32_t b1[2] = {v1[j], last[j] ? 0u : n1[j]}, b2[2] = {v2[j], last[j] ? 0u : n2[j]};
      smear_words<2>(b1, rw1);
      shr_words<2>(b1, dc1);
      smear_words<2>(b2, rw2);
      shr_words<2>(b2, dc2);
      if (active && has[j]) {  // bit c of word w: anchor (r, 32 w + c) is legal
        rows[(t.seg * height + r) * nw + t.lane + 32 * j] =
            r + pc.x <= height ? ~(b1[0] | b2[0]) & span_mask[j] : 0u;
      }
    }
    if constexpr (NJ == 1) {
#pragma unroll
      for (int i = 0; i + 1 < kMaxPiece; ++i) below[i] = below[i + 1];
      below[kMaxPiece - 1] = r + kMaxPiece < height ? x[(r + kMaxPiece) * nw] : 0u;
    }
  }
  __syncthreads();
  bit_rows::store_words_n(rows, out, static_cast<long long>(first) * hw, count * hw, width, nw,
                          threadIdx.x, blockDim.x);
}

__global__ void mask_kernel(const uint8_t* __restrict__ board,
                            const int32_t* __restrict__ queue,
                            const int32_t* __restrict__ piece_table,
                            uint8_t* __restrict__ out,
                            long long total, int height, int width,
                            int slots, int num_pieces, int max_cells) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int hw = height * width;
  const int anchor = static_cast<int>(i % hw);
  const long long env_slot = i / hw;            // env * slots + slot
  const long long env = env_slot / slots;
  const int pid = queue[env_slot];
  bool legal = false;
  if (pid >= 0 && pid < num_pieces) {
    legal = piece_fits(board + env * hw, piece_table + pid * (3 + max_cells),
                       anchor, height, width);
  }
  out[i] = legal;
}

// A launch of the wide, tall, deep and xwide kernels: `slots` env-slots an
// env (the hand's S, or P for the every-piece instances, whose `queue` is
// null), `per_warp` of them a warp and `warps` warps a block.
struct Launch {
  const void* board;
  const void* queue;
  const void* pieces;
  void* out;
  int total, height, width, slots, num_pieces, max_h, per_warp, warps;
  cudaStream_t stream;
};

using Kernel = void (*)(const uint8_t*, const int32_t*, const int4*, uint8_t*, int, int, int,
                        int, int, int, int);

// `kernel`'s launch on `a` with `smem` bytes of shared memory a block:
// refused above what a block may opt in to, opted in to above 48 KB.
int launch(Kernel kernel, const Launch& a, long long smem) {
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = a.warps * a.per_warp;
  kernel<<<(a.total + per_block - 1) / per_block, a.warps * 32, static_cast<int>(smem),
           a.stream>>>(
      static_cast<const uint8_t*>(a.board), static_cast<const int32_t*>(a.queue),
      static_cast<const int4*>(a.pieces), static_cast<uint8_t*>(a.out), a.total, a.height,
      a.width, a.slots, a.num_pieces, a.max_h, a.per_warp);
  return static_cast<int>(cudaGetLastError());
}

// The bytes of the boards a block of the wide, tall and deep kernels
// stages: at most (E + S - 1) / S + 1 envs.
long long span_bytes(const Launch& a) {
  const int per_block = a.warps * a.per_warp;
  return static_cast<long long>((per_block + a.slots - 1) / a.slots + 1) * a.height * a.width;
}

template <int NW, bool kEvery>
int launch_mask_wide(const Launch& a) {
  return launch(mask_wide_kernel<NW, kEvery>, a,
                bit_rows::smem_bytes(a.warps * a.per_warp * a.height * NW, span_bytes(a)));
}

template <int NR, int NW, bool kEvery>
int launch_mask_tall(const Launch& a) {
  return launch(mask_tall_kernel<NR, NW, kEvery>, a,
                bit_rows::smem_bytes(a.warps * a.per_warp * a.height * NW, span_bytes(a)));
}

template <int NR, bool kEvery>
int launch_mask_tall_rows(const Launch& a) {
  switch ((a.width + 31) / 32) {
    case 1: return launch_mask_tall<NR, 1, kEvery>(a);
    case 2: return launch_mask_tall<NR, 2, kEvery>(a);
    case 3: return launch_mask_tall<NR, 3, kEvery>(a);
    default: return launch_mask_tall<NR, 4, kEvery>(a);
  }
}

// The deep kernel's launch: the same shape as the tall one's; a block whose
// shared memory passes what a block may opt in to is refused.
template <int NW, bool kEvery>
int launch_mask_deep(const Launch& a) {
  const long long rows = 4LL * a.warps * a.per_warp * a.height * NW;
  return launch(mask_deep_kernel<NW, kEvery>, a, (rows + 15) / 16 * 16 + span_bytes(a) + 32);
}

bool aligned(const void* out, const void* pieces) {
  return ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(pieces)) & 15) == 0;
}

// The checks every entry of the four kernels makes: a piece table and an
// output on 16-byte boundaries, pieces of at most 8 rows and columns, 1 to
// 16 warps, at least one env-slot an env and N * slots < 2^31.
bool common_ok(const Launch& a, int n, int max_w) {
  return n >= 0 && a.slots >= 1 && a.max_h <= kMaxPiece && max_w <= kMaxPiece &&
         a.warps >= 1 && a.warps <= bit_rows::kMaxWarps &&
         static_cast<long long>(n) * a.slots <= INT_MAX && aligned(a.out, a.pieces);
}

// H <= 32 and 32 < W <= 128: per_warp = 32 / H, warps such that the
// block's output, warps * per_warp * H * W bytes, is a multiple of 16
template <bool kEvery>
int mask_wide(Launch a, int n, int max_w) {
  if (!common_ok(a, n, max_w) || a.height < 1 || a.height > 32 ||
      a.per_warp != 32 / a.height || a.width <= 32 || a.width > 128 ||
      (a.warps * a.per_warp * a.height * a.width) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.total = n * a.slots;
  if (a.total == 0) return static_cast<int>(cudaGetLastError());
  switch ((a.width + 31) / 32) {
    case 2: return launch_mask_wide<2, kEvery>(a);
    case 3: return launch_mask_wide<3, kEvery>(a);
    default: return launch_mask_wide<4, kEvery>(a);
  }
}

// 32 < H <= 128 (tall) or H > 128 (deep), W <= 128: per_warp 1 to 4
template <bool kEvery>
int mask_tall(Launch a, int n, int max_w, bool deep) {
  if (!common_ok(a, n, max_w) || a.height <= 32 || (a.height > 128) != deep ||
      a.width < 1 || a.width > 128 || a.per_warp < 1 || a.per_warp > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.total = n * a.slots;
  if (a.total == 0) return static_cast<int>(cudaGetLastError());
  if (deep) {
    switch ((a.width + 31) / 32) {
      case 1: return launch_mask_deep<1, kEvery>(a);
      case 2: return launch_mask_deep<2, kEvery>(a);
      case 3: return launch_mask_deep<3, kEvery>(a);
      default: return launch_mask_deep<4, kEvery>(a);
    }
  }
  switch ((a.height + 31) / 32) {
    case 2: return launch_mask_tall_rows<2, kEvery>(a);
    case 3: return launch_mask_tall_rows<3, kEvery>(a);
    default: return launch_mask_tall_rows<4, kEvery>(a);
  }
}

// The xwide kernel of NJ slots a lane.
template <bool kEvery>
Kernel xwide_kernel(int nj) {
  return nj == 1   ? mask_xwide_kernel<kEvery, 1>
         : nj == 2 ? mask_xwide_kernel<kEvery, 2>
         : nj == 3 ? mask_xwide_kernel<kEvery, 3>
                   : mask_xwide_kernel<kEvery, 4>;
}

// 128 < W <= 4096, any height: per_warp = 32 / NW where W <= 1024 (NW
// lanes an env-slot), 1 above (NJ = ceil(NW / 32) words a lane, one
// env-slot a warp); the block's shared memory holds its legal rows, then
// the row words of the envs it reads (one array where S = 1); refused where
// a block stages or stores 2^21 bytes or more (`small_div`)
template <bool kEvery>
int mask_xwide(Launch a, int n, int max_w) {
  const int nw = (a.width + 31) / 32;
  const int nj = (nw + 31) / 32;
  if (!common_ok(a, n, max_w) || a.height < 1 || a.width <= 128 || a.width > 4096 ||
      a.per_warp != (nj == 1 ? 32 / nw : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.total = n * a.slots;
  if (a.total == 0) return static_cast<int>(cudaGetLastError());
  const int per_block = a.warps * a.per_warp;
  const long long most = a.slots == 1 ? per_block : (per_block + a.slots - 1) / a.slots + 1;
  if ((per_block > most ? per_block : most) * a.height * a.width >= (1LL << 21)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(xwide_kernel<kEvery>(nj), a,
                4LL * (most + (a.slots == 1 ? 0 : per_block)) * a.height * nw);
}

}  // namespace

// board (N, HW) u8, queue (N, S) i32, pieces (P, 4) i32 rows [h, w, rect 1,
// rect 2] (16-byte aligned), out (N, S*HW) bool (16-byte aligned).
// per_warp = 32 / H env-slots a warp, warps a block such that warps *
// per_warp * H * W is a multiple of 16; H <= 32, W <= 32, pieces of at most
// 8 rows and 8 columns, N*S < 2^31.
extern "C" int bp_mask_rows(const void* board, const void* queue,
                            const void* pieces, void* out, int n, int height,
                            int width, int slots, int num_pieces, int max_h,
                            int max_w, int per_warp, int warps, void* stream) {
  const long long total = static_cast<long long>(n) * slots;
  if (height < 1 || height > 32 || per_warp != 32 / height || width < 1 ||
      width > 32 || slots < 1 || max_h > kMaxPiece || max_w > kMaxPiece ||
      warps < 1 || warps > bit_rows::kMaxWarps ||
      (warps * per_warp * height * width) % 16 != 0 || total > INT_MAX ||
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(pieces)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    const int per_block = warps * per_warp;
    const int blocks = static_cast<int>((total + per_block - 1) / per_block);
    // the envs one block reads: at most (E + S - 1) / S + 1
    const long long span = static_cast<long long>((per_block + slots - 1) / slots + 1) *
                           height * width;
    const int smem = bit_rows::smem_bytes(per_block * height, span);
    mask_rows_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(board), static_cast<const int32_t*>(queue),
        static_cast<const int4*>(pieces), static_cast<uint8_t*>(out),
        static_cast<int>(total), height, width, slots, num_pieces, max_h, max_w,
        per_warp);
  }
  return static_cast<int>(cudaGetLastError());
}

// As bp_mask_rows, for 32 < W <= 128: rows of NW = ceil(W / 32) words.
extern "C" int bp_mask_wide(const void* board, const void* queue,
                            const void* pieces, void* out, int n, int height,
                            int width, int slots, int num_pieces, int max_h,
                            int max_w, int per_warp, int warps, void* stream) {
  return mask_wide<false>({board, queue, pieces, out, 0, height, width, slots, num_pieces,
                           max_h, per_warp, warps, static_cast<cudaStream_t>(stream)},
                          n, max_w);
}

// As bp_mask_rows, for 32 < H <= 128 and W <= 128: one env-slot a warp at a
// time, lane l holding rows l + 32 j (j < NR = ceil(H / 32)) of NW =
// ceil(W / 32) words; per_warp (1 to 4) env-slots a warp in turn, from the
// one staged span of the block's warps * per_warp env-slots; any count of
// warps from 1 to 16 (the block's output span may start off a 16-byte
// boundary).
extern "C" int bp_mask_tall(const void* board, const void* queue,
                            const void* pieces, void* out, int n, int height,
                            int width, int slots, int num_pieces, int max_h,
                            int max_w, int per_warp, int warps, void* stream) {
  return mask_tall<false>({board, queue, pieces, out, 0, height, width, slots, num_pieces,
                           max_h, per_warp, warps, static_cast<cudaStream_t>(stream)},
                          n, max_w, false);
}

// As bp_mask_tall, for H > 128 and W <= 128: one env-slot a warp at a
// time, walking its board in windows of 32 rows (lane l: rows 32 j + l and
// 32 (j + 1) + l); per_warp (1 to 4) env-slots a warp in turn, warps 1 to
// 16; refused where the block's shared memory (its legal rows and its
// staged boards) passes what a block may opt in to.
extern "C" int bp_mask_deep(const void* board, const void* queue,
                            const void* pieces, void* out, int n, int height,
                            int width, int slots, int num_pieces, int max_h,
                            int max_w, int per_warp, int warps, void* stream) {
  return mask_tall<false>({board, queue, pieces, out, 0, height, width, slots, num_pieces,
                           max_h, per_warp, warps, static_cast<cudaStream_t>(stream)},
                          n, max_w, true);
}

// As bp_mask_rows, for 128 < W <= 4096 and any height: a segment of NW =
// ceil(W / 32) lanes an env-slot, lane w holding word w of every row;
// per_warp = 32 / NW segments a warp where W <= 1024, and above one
// env-slot a warp, lane l holding words l + 32 j (per_warp = 1); warps 1 to
// 16 (the block's output span may start off a 16-byte boundary); refused
// where the block's shared
// memory (its legal rows and its envs' row words, one array where S = 1)
// passes what a block may opt in to, or where it stages or stores 2^21
// bytes or more.
extern "C" int bp_mask_xwide(const void* board, const void* queue,
                             const void* pieces, void* out, int n, int height,
                             int width, int slots, int num_pieces, int max_h,
                             int max_w, int per_warp, int warps, void* stream) {
  return mask_xwide<false>({board, queue, pieces, out, 0, height, width, slots, num_pieces,
                            max_h, per_warp, warps, static_cast<cudaStream_t>(stream)},
                           n, max_w);
}

// The all-pieces legality (K4) on the mask's wide, tall, deep and xwide
// kernels: their every-piece instances, each with its mask entry's launch
// shape rules at S = P.  board (N, HW) u8, pieces (P, 4) i32 rows as
// bp_mask_rows's (16-byte aligned); out (N, P*HW) bool (16-byte aligned),
// piece-major then row-major anchor; N*P < 2^31.
extern "C" int bp_legality_wide(const void* board, const void* pieces, void* out, int n,
                                int height, int width, int num_pieces, int max_h, int max_w,
                                int per_warp, int warps, void* stream) {
  return mask_wide<true>({board, nullptr, pieces, out, 0, height, width, num_pieces,
                          num_pieces, max_h, per_warp, warps,
                          static_cast<cudaStream_t>(stream)},
                         n, max_w);
}

extern "C" int bp_legality_tall(const void* board, const void* pieces, void* out, int n,
                                int height, int width, int num_pieces, int max_h, int max_w,
                                int per_warp, int warps, void* stream) {
  return mask_tall<true>({board, nullptr, pieces, out, 0, height, width, num_pieces,
                          num_pieces, max_h, per_warp, warps,
                          static_cast<cudaStream_t>(stream)},
                         n, max_w, false);
}

extern "C" int bp_legality_deep(const void* board, const void* pieces, void* out, int n,
                                int height, int width, int num_pieces, int max_h, int max_w,
                                int per_warp, int warps, void* stream) {
  return mask_tall<true>({board, nullptr, pieces, out, 0, height, width, num_pieces,
                          num_pieces, max_h, per_warp, warps,
                          static_cast<cudaStream_t>(stream)},
                         n, max_w, true);
}

extern "C" int bp_legality_xwide(const void* board, const void* pieces, void* out, int n,
                                 int height, int width, int num_pieces, int max_h, int max_w,
                                 int per_warp, int warps, void* stream) {
  return mask_xwide<true>({board, nullptr, pieces, out, 0, height, width, num_pieces,
                           num_pieces, max_h, per_warp, warps,
                           static_cast<cudaStream_t>(stream)},
                          n, max_w);
}

// board (N, HW) u8, queue (N, S) i32, piece_table (P, 3 + max_cells) i32
// holding [h, w, ncells, flat offsets dr*W + dc ...]; out (N, S*HW) bool.
extern "C" int bp_mask(const void* board, const void* queue,
                       const void* piece_table, void* out, int n, int height,
                       int width, int slots, int num_pieces, int max_cells,
                       void* stream) {
  const long long total = static_cast<long long>(n) * slots * height * width;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(board), static_cast<const int32_t*>(queue),
        static_cast<const int32_t*>(piece_table), static_cast<uint8_t*>(out),
        total, height, width, slots, num_pieces, max_cells);
  }
  return static_cast<int>(cudaGetLastError());
}
