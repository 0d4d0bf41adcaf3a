// Chosen-action apply on packed boards.  No Pallas source: the JAX package
// runs this in jnp, in the packed branch of `VecBlockPuzzle.step`
// (blockpuzzle_tpu/env/core.py), with `_cover_words` and
// `_clear_scan_packed`.  The plain version is `packed_apply_plain`
// (kernels/packed.py).
//
// What it computes, per env, on the (H,) row words (bit w of word r is
// cell (r, w)): the chosen action's footprint words, the union of <= 2
// rectangles, each a shifted 2^rw - 1 row mask on its rows; legal = valid
// and no word overlaps; a legal action ORs the footprint in, finds every
// full row (word == 2^W - 1), full column (set in the AND of all rows,
// counted with __popc) and full aligned region on the placed board, clears
// them all in one AND-NOT, and reports k = their number.  An illegal
// action is a strict no-op with k = 0, even on a board that already holds
// a full line.  Shifts of 32 or more give 0, as XLA's uint32 shifts do.
//
// Design: one thread per env, any N (the tail is one bounds test).  The
// H <= 32 words sit in a register array: every loop over rows runs to the
// fixed bound MAX_ROWS, fully unrolled, and tests `i < height`, so no
// index is dynamic.  Region masks are built on a pass down the rows (the
// band AND closes at each band's last row) and spread on a pass back up.
//
// Bound on the H100: device memory.  Per env it reads H int64 words, 11
// int32 attrs, r, c and valid and writes H int64 words, k and legal:
// 222 B on the default preset (H = 10), 10.9 MB at N = 49152, ~3.3 us at
// 3.35 TB/s.  Each thread's words are contiguous, so a warp's loads cover
// whole cache lines.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 32;  // kernels/packed.py MAX_ROWS

__device__ __forceinline__ uint32_t shl32(uint32_t x, int s) {
  return s < 32 ? x << s : 0u;
}

__global__ void packed_apply_kernel(const long long* __restrict__ words,
                                    const int32_t* __restrict__ attrs,
                                    const int32_t* __restrict__ r_in,
                                    const int32_t* __restrict__ c_in,
                                    const uint8_t* __restrict__ valid,
                                    long long* __restrict__ words_out,
                                    int32_t* __restrict__ k_out,
                                    uint8_t* __restrict__ legal_out, int n,
                                    int height, int width, int region_size) {
  const long long env =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (env >= n) return;
  const long long* b = words + env * height;
  const int32_t* a = attrs + env * 11;
  const int r = r_in[env];
  const int c = c_in[env];
  int row0[2], row1[2];
  uint32_t rowmask[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    row0[j] = r + a[3 + 4 * j];
    row1[j] = row0[j] + a[5 + 4 * j];
    rowmask[j] = shl32(shl32(1u, a[6 + 4 * j]) - 1u, c + a[4 + 4 * j]);
  }

  uint32_t w[kMaxRows];
  bool overlap = false;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i < height) {
      const uint32_t x = static_cast<uint32_t>(b[i]);
      uint32_t cover = 0;
      if (i >= row0[0] && i < row1[0]) cover |= rowmask[0];
      if (i >= row0[1] && i < row1[1]) cover |= rowmask[1];
      overlap |= (x & cover) != 0;
      w[i] = x | cover;
    }
  }
  const bool legal = valid[env] != 0 && !overlap;
  long long* o = words_out + env * height;
  int k = 0;
  if (legal) {
    const uint32_t full = shl32(1u, width) - 1u;
    uint32_t cols = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      if (i < height) {
        cols &= w[i];
        k += w[i] == full;
      }
    }
    k += __popc(cols);
    uint32_t band_end[kMaxRows];  // region bits of the band ending at row i
    if (region_size > 0) {
      const uint32_t tile0 = shl32(1u, region_size) - 1u;
      uint32_t band = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < height) {
          band &= w[i];
          if ((i + 1) % region_size == 0) {
            uint32_t reg = 0;
            for (int s = 0; s + region_size <= width; s += region_size) {
              const uint32_t tile = tile0 << s;
              if ((band & tile) == tile) {
                reg |= tile;
                ++k;
              }
            }
            band_end[i] = reg;
            band = 0xffffffffu;
          }
        }
      }
    }
    uint32_t reg = 0;
#pragma unroll
    for (int i = kMaxRows - 1; i >= 0; --i) {
      if (i < height) {
        if (region_size > 0 && (i + 1) % region_size == 0) reg = band_end[i];
        const uint32_t clear = (w[i] == full ? full : 0u) | cols | reg;
        o[i] = static_cast<long long>(w[i] & ~clear);
      }
    }
  } else {
    for (int i = 0; i < height; ++i) o[i] = b[i];
  }
  k_out[env] = k;
  legal_out[env] = legal;
}

}  // namespace

// words (N, H) i64 holding u32 row words; attrs (N, 11) i32 rows [h, w,
// cells, dr1, dc1, h1, w1, dr2, dc2, h2, w2]; r, c (N,) i32; valid (N,)
// bool; outputs words_out (N, H) i64, k (N,) i32, legal (N,) bool.
// region_size 0 means no region clear.  Needs H <= 32 and W <= 32.
extern "C" int bp_packed_apply(const void* words, const void* attrs,
                               const void* r, const void* c,
                               const void* valid, void* words_out,
                               void* k_out, void* legal_out, int n,
                               int height, int width, int region_size,
                               void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    packed_apply_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(words),
        static_cast<const int32_t*>(attrs), static_cast<const int32_t*>(r),
        static_cast<const int32_t*>(c), static_cast<const uint8_t*>(valid),
        static_cast<long long*>(words_out), static_cast<int32_t*>(k_out),
        static_cast<uint8_t*>(legal_out), n, height, width, region_size);
  }
  return static_cast<int>(cudaGetLastError());
}
