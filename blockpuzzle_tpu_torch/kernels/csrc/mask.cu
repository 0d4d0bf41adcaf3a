// Hand action mask: the CUDA port of the TPU kernel `_mask_kernel`
// (blockpuzzle_tpu/kernels/mask.py:57, launched by `_mask_pallas_call`,
// mask.py:85, from `MaskKernel.__call__`).  Two kernels: the bit-row kernel
// (`mask_rows_kernel`, entry `bp_mask_rows`) for boards with H <= 32 and
// W <= 32 and pieces of at most 8 rows and 8 columns, every shipped preset
// and piece set, and the general kernel (`mask_kernel`, entry `bp_mask`)
// for any other board.  The wrapper (kernels/mask.py)
// picks one by shape.
//
// What both compute (not how the TPU did it): anchor (r, c) of hand slot s
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
// The general kernel: one thread per (env, slot, anchor), flat over
// N*S*HW.  Each thread reads its piece's (h, w, cell offsets) row from a
// small table (P rows of 3+maxc int32, L1-resident) and tests at most maxc
// (9 for classic19) board bytes (`piece_fits`, piece_fits.cuh, shared with
// the legality kernel).  Per-thread work (64-bit index arithmetic, a
// data-dependent chain of byte loads) bounds it, not bytes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bit_rows.cuh"
#include "piece_fits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPiece = 8;  // rows and columns of a piece the bit-row kernel takes
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
