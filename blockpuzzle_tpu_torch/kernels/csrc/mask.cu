// Hand action mask: the CUDA port of the TPU kernel `_mask_kernel`
// (blockpuzzle_tpu/kernels/mask.py, launched by `_mask_pallas_call` from
// `MaskKernel.__call__`).
//
// What it computes (not how the TPU did it): anchor (r, c) of hand slot s is
// legal iff the slot holds a piece (0 <= pid < P), the piece's bounding box
// lies on the board (r + h <= H, c + w <= W), and every cell of its
// footprint is empty.  The TPU formulation -- a bf16 one-hot matmul over
// cover_T padded to 128 lanes per piece with a +1024 bias on invalid
// anchors -- exists for Mosaic's layout rules and is not carried over.
//
// Design: one thread per (env, slot, anchor), flat over N*S*HW, so any N
// works and the ragged edge is one bounds test.  Each thread reads its
// piece's (h, w, cell offsets) row from a small table (P rows of 3+maxc
// int32, L1-resident) and tests at most maxc (9 for classic19) board bytes
// (`piece_fits`, piece_fits.cuh, shared with the legality kernel).
//
// Bound on the H100: device memory.  Per env it reads the HW-byte board
// and S int32 piece ids and writes S*HW bool bytes: 204 B per env on the
// default preset (HW = 100, S = 1), 10.0 MB at N = 49152, ~3 us at
// 3.35 TB/s.  Threads of one env are adjacent, so the board's bytes come
// from L1 after the first touch and the output store is fully coalesced;
// the <= 9 taps per thread are integer compares, far below any compute
// bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "piece_fits.cuh"

namespace {

constexpr int kThreads = 256;

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
