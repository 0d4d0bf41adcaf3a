// Hand action mask from packed board words.  No Pallas source: the JAX
// package runs this in jnp, as `_bitboard_legal_slots` and
// `_bitboard_mask_from_words` (blockpuzzle_tpu/env/core.py), the mask of
// its packed engine.  The plain version is `packed_mask_plain`
// (kernels/packed.py).
//
// What it computes: anchor (r, c) of hand slot s is legal iff the slot
// holds a piece (0 <= pid < P), c + piece_w <= W, and for every footprint
// word k < nwords
//
//     wks_k(r) & ((prow[pid][k] << c) & cmask[c]) == 0,
//
// where wks_k(r) ORs board rows r + k*fpw + j into W-bit field j (fpw =
// 32 / W fields a word) and rows past the bottom read as full, so pieces
// overhanging the bottom fail.  cmask[c] strips the bits a shift by c
// spills into the next field; that spill is exactly a column overflow,
// which the explicit c + piece_w <= W test catches instead.  The output is
// (N, S*H*W) bool, slot-major then row-major anchor, as the u8 mask
// kernel's (mask.cu).
//
// Design: one thread per (env, slot, anchor row), flat over N*S*H, so any
// N works and the ragged edge is one bounds test.  The thread builds its
// nwords board words once (2 for classic19 at W = 10) and tests the W
// anchors of its row against the slot's footprint words, writing W
// consecutive bools.  The footprint tables (P*nwords + P + W words) stay
// in L1.
//
// Bound on the H100: device memory, the store above all.  Per env it reads
// H int64 words and S int32 ids and writes S*H*W bools: 184 B on the
// default preset (H = W = 10, S = 1), 9.0 MB at N = 49152, ~2.7 us at
// 3.35 TB/s.  A thread's board words come from L1 after the first of the
// env's threads touches them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 8;  // kernels/packed.py MAX_WORDS

__global__ void packed_mask_kernel(const long long* __restrict__ words,
                                   const int32_t* __restrict__ queue,
                                   const uint32_t* __restrict__ prow,
                                   const int32_t* __restrict__ piece_w,
                                   const uint32_t* __restrict__ cmask,
                                   uint8_t* __restrict__ out, long long total,
                                   int height, int width, int slots,
                                   int num_pieces, int nwords, int fpw) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int row = static_cast<int>(i % height);
  const long long env_slot = i / height;  // env * slots + slot
  const long long env = env_slot / slots;
  uint8_t* o = out + env_slot * height * width + row * width;
  const int pid = queue[env_slot];
  if (pid < 0 || pid >= num_pieces) {
    for (int c = 0; c < width; ++c) o[c] = 0;
    return;
  }
  const long long* b = words + env * height;
  const uint32_t full = width < 32 ? (1u << width) - 1u : 0xffffffffu;
  uint32_t wk[kMaxWords], pk[kMaxWords];
#pragma unroll
  for (int k = 0; k < kMaxWords; ++k) {
    if (k < nwords) {
      uint32_t acc = 0;
      for (int j = 0; j < fpw; ++j) {
        const int rr = row + k * fpw + j;
        const uint32_t field =
            rr < height ? static_cast<uint32_t>(b[rr]) : full;
        acc |= field << (j * width);
      }
      wk[k] = acc;
      pk[k] = prow[pid * nwords + k];
    }
  }
  const int pw = piece_w[pid];
  for (int c = 0; c < width; ++c) {
    const uint32_t cm = cmask[c];
    bool legal = c + pw <= width;
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) {
      if (k < nwords) legal &= (wk[k] & ((pk[k] << c) & cm)) == 0;
    }
    o[c] = legal;
  }
}

}  // namespace

// words (N, H) i64 holding u32 row words; queue (N, S) i32; prow (P,
// nwords) u32 footprint words; piece_w (P,) i32; cmask (W,) u32; out (N,
// S*H*W) bool.  Needs W <= 32 and nwords <= 8.
extern "C" int bp_packed_mask(const void* words, const void* queue,
                              const void* prow, const void* piece_w,
                              const void* cmask, void* out, int n, int height,
                              int width, int slots, int num_pieces,
                              int nwords, int fpw, void* stream) {
  const long long total = static_cast<long long>(n) * slots * height;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    packed_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(words),
        static_cast<const int32_t*>(queue),
        static_cast<const uint32_t*>(prow),
        static_cast<const int32_t*>(piece_w),
        static_cast<const uint32_t*>(cmask), static_cast<uint8_t*>(out),
        total, height, width, slots, num_pieces, nwords, fpw);
  }
  return static_cast<int>(cudaGetLastError());
}
