// All-(piece, anchor) legality map: the CUDA port of the TPU kernel
// `_legality_kernel` (blockpuzzle_tpu/kernels/collision.py:41, launched by
// `_legality_pallas_call`, collision.py:50, from `LegalityKernel.__call__`).
// Two kernels here: the bit-row kernel (`legality_rows_kernel`, entry
// `bp_legality_rows`) for boards with H <= 32 and W <= 32 and pieces of at
// most 8 rows and 8 columns, every shipped preset and piece set, and the
// general kernel (`legality_kernel`, entry `bp_legality`) for rows of more
// than 1024 cells, rows of more than 128 cells on boards of more than 32
// rows, larger pieces, or a deep board whose one-warp block does not fit.
// Between those, the legality runs on the hand mask's wide, tall, deep and
// xwide kernels (mask.cu, their every-piece instances `bp_legality_wide`,
// `_tall`, `_deep`, `_xwide`).  The wrapper (kernels/collision.py) picks one
// by shape.
//
// What both compute: out[n, p, a] is true iff piece p fits at flat anchor a
// of board n -- its bounding box lies on the board and every cell of its
// footprint is empty.  The TPU formulation -- a bf16 matmul of the board
// tile against cover_T padded to 256 action lanes, then `== 0 & valid` --
// exists for Mosaic's layout rules; the port needs no padding.
//
// Bound on the H100: device memory, and the store above all.  Per env it
// reads HW board bytes and writes P*HW bool bytes: at N = 49152 on the
// default preset (P = 19, HW = 100) that is 93.4 MB written and 4.9 MB
// read, ~29 us at 3.35 TB/s.
//
// The bit-row kernel is the bit-row mask's row test (mask.cu) with the piece
// loop turned inside out.  Every piece is the union of <= 2 rectangles (rows
// dr .. dr + rh - 1, columns dc .. dc + rw - 1 of the piece), and on row
// words built from bytes (no bit >= W) a whole row of anchors is tested at
// once: with S(rh, rw)(r) = OR_{t < rh} OR_{u < rw} row(r + t) >> u,
//
//     legal_p(r) = ~(S(rh1, rw1)(r + dr1) >> dc1 | S(rh2, rw2)(r + dr2) >> dc2)
//                  & (2^(W - w + 1) - 1)           if r + h <= H, else 0.
//
// S depends on the rectangle's shape alone, and a piece set has few shapes
// (11 for the 19 classic pieces), so the work per piece shrinks to two
// table reads, two shifts and a mask:
//   - one segment of H lanes per env (not per (env, piece)), 32 / H segments
//     a warp, four warps a block: the block stages its envs' boards once
//     (`stage_bytes`), each lane packs its row once (`pack_row`);
//   - each lane then builds S for every shape in use, once: the rows below
//     it arrive by max_h shuffles, ORed in one after the other, and for each
//     height the smear grows a column at a time (two operations a shape);
//     the words go to a table in shared memory, a row of blockDim + 8 words
//     per shape, word i of a row being thread i's.  `shapes` names the
//     shapes in use, bit 8 * (rh - 1) + rw - 1; a shape's row is the number
//     of lower bits set;
//   - then a warp-uniform loop over the P pieces: the piece's row [h, anchor
//     column mask, rect 1, rect 2] from shared memory (a broadcast load;
//     each rect is `row * (blockDim + 8) + dr | dc << 16`, built by the
//     wrapper), S read at the lane dr below (thread + dr: the same segment
//     wherever r + h <= H; elsewhere whatever the word holds, dropped by the
//     row test), and the legal word of (env, piece, row) into shared memory
//     at (env * P + p) * H + r: about fifteen operations a piece and lane,
//     against a thread per anchor with two 64-bit divisions, a table row and
//     up to 9 dependent byte loads each;
//   - the block's output is one contiguous span of E*P*H*W bytes, written as
//     16-byte vectors of 0/1 bytes from the staged words (`store_span`).  It
//     is E*P*H*W, not E*H*W, that would have to be a multiple of 16 for
//     every block to start on a boundary (woodoku: P*H*W = 1539), and a
//     block writes 22,800 bytes on default: so the store takes any start
//     (the bytes up to the first boundary and the tail go one by one) and
//     divides by W with a multiply good to 2^32 / W bytes.
// Shared memory: 16 KB a block on default (9.1 KB of legal words, 5.9 KB of
// S, the pieces, the boards), under the 48 KB a launch gets without opting
// in; the wrapper takes the general kernel where a piece set would need
// more.  Byte offsets into the output are 64 bits.
//
// The general kernel: one thread per (env, piece, anchor), flat over
// N*P*HW, output index (n*P + p)*HW + a, so any N works and the ragged edge
// is one bounds test.  Each thread reads its piece's row of the piece table
// (the general mask kernel's table, L1-resident) and tests at most maxc
// board bytes with `piece_fits` (piece_fits.cuh, shared with the general
// mask kernel).  Per-thread work bounds it, not bytes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bit_rows.cuh"
#include "piece_fits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowWarps = 4;   // warps a block of the bit-row kernel
constexpr int kMaxPiece = 8;   // rows and columns of a piece it takes
constexpr int kPad = 8;        // words past a shape's row: thread + dr, dr < 8
using bit_rows::kAll;

__global__ void __launch_bounds__(kRowWarps * 32)
    legality_rows_kernel(const uint8_t* __restrict__ board,
                         const int4* __restrict__ pieces,
                         uint8_t* __restrict__ out, int n, int height,
                         int width, int num_pieces, int max_h, int max_w,
                         unsigned long long shapes, int per_warp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int per_block = blockDim.x / 32 * per_warp;
  const int stride = blockDim.x + kPad;
  const int nrows = per_block * num_pieces * height;
  int4* ptab = reinterpret_cast<int4*>(smem);                   // P piece rows
  uint32_t* rows = reinterpret_cast<uint32_t*>(ptab + num_pieces);  // E*P*H legal words
  uint32_t* stab = rows + nrows;                                // a row per shape
  uint8_t* span = bit_rows::staged_span(
      smem, 4 * num_pieces + nrows + __popcll(shapes) * stride);
  const int hw = height * width;
  const int first = blockIdx.x * per_block;          // first env
  const int count = min(per_block, n - first);       // envs here
  const long long lo = static_cast<long long>(first) * hw;
  const int d = bit_rows::stage_bytes(board, lo, lo + static_cast<long long>(count) * hw, span);
  for (int i = threadIdx.x; i < num_pieces; i += blockDim.x) ptab[i] = pieces[i];

  const bit_rows::Seat t = bit_rows::seat(height, per_warp);
  const bool active = t.s < per_warp && t.seg < count;
  __syncthreads();
  uint32_t x = 0;
  if (active) x = bit_rows::pack_row(span, d + t.seg * hw + t.lane * width, width);
  // S(rh, rw) of this lane for every shape in use; a row past the bottom
  // reads another segment's word, and such an anchor fails r + h <= H below
  uint32_t* mine = stab + threadIdx.x;
  uint32_t below = 0;
#pragma unroll
  for (int rh = 1; rh <= kMaxPiece; ++rh) {
    if (rh <= max_h) {
      below |= __shfl_sync(kAll, x, t.l + rh - 1);
      uint32_t s = 0;
#pragma unroll
      for (int rw = 1; rw <= kMaxPiece; ++rw) {
        if (rw <= max_w) {
          s |= below >> (rw - 1);
          const int bit = 8 * (rh - 1) + rw - 1;
          if (shapes >> bit & 1) mine[__popcll(shapes & ((1ull << bit) - 1)) * stride] = s;
        }
      }
    }
  }
  __syncwarp();  // a lane reads what the lanes of its segment wrote
  uint32_t* legal = rows + t.seg * num_pieces * height + t.lane;
  for (int p = 0; p < num_pieces; ++p) {
    const int4 pc = ptab[p];
    const uint32_t blocked = mine[pc.z & 0xffff] >> (pc.z >> 16) |
                             mine[pc.w & 0xffff] >> (pc.w >> 16);
    if (active) {  // bit c: piece p at anchor (lane, c) is legal
      legal[p * height] = t.lane + pc.x <= height ? ~blocked & static_cast<uint32_t>(pc.y) : 0u;
    }
  }
  __syncthreads();
  bit_rows::store_span(rows, out, static_cast<long long>(first) * num_pieces * hw,
                       count * num_pieces * hw, width);
}

__global__ void legality_kernel(const uint8_t* __restrict__ board,
                                const int32_t* __restrict__ piece_table,
                                uint8_t* __restrict__ out, long long total,
                                int height, int width, int num_pieces,
                                int max_cells) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int hw = height * width;
  const int anchor = static_cast<int>(i % hw);
  const long long env_piece = i / hw;           // env * num_pieces + piece
  const int piece = static_cast<int>(env_piece % num_pieces);
  const long long env = env_piece / num_pieces;
  out[i] = piece_fits(board + env * hw, piece_table + piece * (3 + max_cells),
                      anchor, height, width);
}

}  // namespace

// Shared memory of `legality_rows_kernel`: the piece rows, the legal words,
// the shape table, the staged boards.
static int legality_rows_smem(int per_block, int height, int width, int num_pieces,
                              int nshapes) {
  return bit_rows::smem_bytes(
      4 * num_pieces + per_block * num_pieces * height + nshapes * (kRowWarps * 32 + kPad),
      static_cast<long long>(per_block) * height * width);
}

// board (N, HW) u8 of 0/1 cells, pieces (P, 4) i32 rows [h, anchor column
// mask, rect 1, rect 2] (16-byte aligned; `legality_rows_table`), out (N, P,
// HW) bool (16-byte aligned).  `shapes`: bit 8 * (rh - 1) + rw - 1 for each
// rectangle shape in use.  per_warp = 32 / H envs a warp, `warps` = 4;
// H <= 32, W <= 32, pieces of at most 8 rows and 8 columns, a block's shared
// memory at most 48 KB.
extern "C" int bp_legality_rows(const void* board, const void* pieces,
                                void* out, int n, int height, int width,
                                int num_pieces, int max_h, int max_w,
                                unsigned long long shapes, int per_warp,
                                int warps, void* stream) {
  if (height < 1 || height > 32 || per_warp != 32 / height || width < 1 ||
      width > 32 || num_pieces < 1 || max_h < 1 || max_h > kMaxPiece || max_w < 1 ||
      max_w > kMaxPiece || warps != kRowWarps ||
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(pieces)) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = warps * per_warp;
  int nshapes = 0;
  for (unsigned long long s = shapes; s != 0; s &= s - 1) ++nshapes;
  const int smem = legality_rows_smem(per_block, height, width, num_pieces, nshapes);
  // `store_span` divides a block's byte offsets by W: bytes * W < 2^32
  if (smem > 48 * 1024 ||
      static_cast<long long>(per_block) * num_pieces * height * width * width > UINT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int blocks = (n + per_block - 1) / per_block;
    legality_rows_kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(board), static_cast<const int4*>(pieces),
        static_cast<uint8_t*>(out), n, height, width, num_pieces, max_h, max_w, shapes,
        per_warp);
  }
  return static_cast<int>(cudaGetLastError());
}

// board (N, HW) u8, piece_table (P, 3 + max_cells) i32 holding [h, w,
// ncells, flat offsets dr*W + dc ...]; out (N, P, HW) bool.
extern "C" int bp_legality(const void* board, const void* piece_table,
                           void* out, int n, int height, int width,
                           int num_pieces, int max_cells, void* stream) {
  const long long total =
      static_cast<long long>(n) * num_pieces * height * width;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    legality_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(board),
        static_cast<const int32_t*>(piece_table), static_cast<uint8_t*>(out),
        total, height, width, num_pieces, max_cells);
  }
  return static_cast<int>(cudaGetLastError());
}
