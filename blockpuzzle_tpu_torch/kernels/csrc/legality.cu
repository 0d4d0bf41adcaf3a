// All-(piece, anchor) legality map: the CUDA port of the TPU kernel
// `_legality_kernel` (blockpuzzle_tpu/kernels/collision.py, launched by
// `_legality_pallas_call` from `LegalityKernel.__call__`).
//
// What it computes: out[n, p, a] is true iff piece p fits at flat anchor a
// of board n -- its bounding box lies on the board and every cell of its
// footprint is empty.  The TPU formulation -- a bf16 matmul of the board
// tile against cover_T padded to 256 action lanes, then `== 0 & valid` --
// exists for Mosaic's layout rules; the port needs no padding.
//
// Design: one thread per (env, piece, anchor), flat over N*P*HW, output
// index (n*P + p)*HW + a, so any N works and the ragged edge is one bounds
// test.  Each thread reads its piece's row of the piece table (the mask
// kernel's table, L1-resident) and tests at most maxc board bytes with
// `piece_fits` (piece_fits.cuh, shared with the mask kernel).
//
// Bound on the H100: device memory, and the store above all.  Per env it
// reads HW board bytes and writes P*HW bool bytes: at N = 49152 on the
// default preset (P = 19, HW = 100) that is 93.4 MB written and 4.9 MB
// read, ~29 us at 3.35 TB/s.  The P*HW threads of one env are adjacent, so
// the board comes from L1 after the first touch and every warp's store is
// one coalesced 32-byte segment.

#include <cstdint>
#include <cuda_runtime.h>

#include "piece_fits.cuh"

namespace {

constexpr int kThreads = 256;

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
