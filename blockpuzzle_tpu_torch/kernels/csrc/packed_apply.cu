// Chosen-action apply on packed boards.  No Pallas source: the JAX package
// runs this in jnp, in the packed branch of `VecBlockPuzzle.step`
// (blockpuzzle_tpu/env/core.py:962), with `_cover_words` (:674) and
// `_clear_scan_packed` (:696).  The plain version is `packed_apply_plain`
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
// a full line: it writes its input words back.  Shifts of 32 or more give
// 0, as XLA's uint32 shifts do.
//
// Bound on the H100: device memory.  Per env it reads H int64 words, 11
// int32 attrs, r, c and valid and writes H int64 words, k and legal:
// 218 B on the default preset (H = 10), 10.7 MB at N = 49152, 3.2 us at
// 3.35 TB/s.  The integer work (~10 operations a word) is far below that.
//
// Design: one segment of H lanes per env, lane j holding row word j, and
// P = 32 / H segments a warp (3 at H = 10; the wrapper passes P).  The row
// loads and stores of a warp are then contiguous, 8 bytes a lane, and no
// thread keeps a per-row register array; the 32 - P*H lanes left over
// (2 at H = 10) run the same instructions on no env.  Each lane loads its
// row word and, as broadcast loads within its segment, the env's r, c,
// valid and the two rectangles of attrs, and builds its own footprint
// word.  Overlap and full rows are `__ballot_sync` masked to the segment
// (`__popc` counts the rows); columns are one `__reduce_and_sync` over the
// segment's lanes; with regions (woodoku, region_size 3) each lane ANDs
// its band's rows by region_size shuffles from explicit source lanes, and
// a band's first lane counts the band's full tiles, summed by
// `__reduce_add_sync`.  Each lane stores its word; the segment's first
// lane writes k and legal.  Every lane of a warp runs every shuffle,
// ballot and reduction (the reductions name the caller's segment, or the
// left-over lanes), so the masks hold on the ragged tail too.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ uint32_t shl32(uint32_t x, int s) {
  return s < 32 ? x << s : 0u;
}

__global__ void __launch_bounds__(kThreads)
    packed_apply_kernel(const long long* __restrict__ words,
                        const int32_t* __restrict__ attrs,
                        const int32_t* __restrict__ r_in,
                        const int32_t* __restrict__ c_in,
                        const uint8_t* __restrict__ valid,
                        long long* __restrict__ words_out,
                        int32_t* __restrict__ k_out,
                        uint8_t* __restrict__ legal_out, int n, int height,
                        int width, int region_size, int per_warp) {
  const int l = threadIdx.x % 32;
  // segment in the warp (per_warp: the left-over lanes): (l + 1/2) / H is
  // at least 1/64 from an integer, far above the float rounding error
  const int s = static_cast<int>((l + 0.5f) * __frcp_rn(static_cast<float>(height)));
  const int lane = l - s * height;  // the row this lane holds
  const int base = s * height;      // the segment's first warp lane
  const long long env =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32 * per_warp + s;
  const bool active = s < per_warp && env < n;
  // the caller's segment in ballot bits (the left-over lanes form one too)
  const unsigned seg = s < per_warp
                           ? (height == 32 ? kAll : ((1u << height) - 1u) << base)
                           : kAll << base;

  long long x64 = 0;
  uint32_t x = kAll;  // no env: the identity of the AND
  uint32_t cover = 0;
  bool ok = false;
  if (active) {
    x64 = words[env * height + lane];
    x = static_cast<uint32_t>(x64);
    const int32_t* a = attrs + env * 11;
    const int r = r_in[env];
    const int c = c_in[env];
    ok = valid[env] != 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row0 = r + a[3 + 4 * j];
      if (lane >= row0 && lane < row0 + a[5 + 4 * j]) {
        cover |= shl32(shl32(1u, a[6 + 4 * j]) - 1u, c + a[4 + 4 * j]);
      }
    }
  }
  const bool overlap = (__ballot_sync(kAll, (x & cover) != 0) & seg) != 0;
  const bool legal = ok && !overlap;
  const uint32_t w = x | cover;
  const uint32_t full = shl32(1u, width) - 1u;
  const unsigned rows_full = __ballot_sync(kAll, active && w == full) & seg;
  const uint32_t cols = __reduce_and_sync(seg, w);
  int k = __popc(rows_full) + __popc(cols);
  uint32_t reg = 0;
  if (region_size > 0) {
    const int b0 = lane - lane % region_size;  // first row of this lane's band
    const bool whole = b0 + region_size <= height;  // a whole band on the board
    uint32_t band = kAll;
    for (int t = 0; t < region_size; ++t) {
      band &= __shfl_sync(kAll, w, whole ? base + b0 + t : l);
    }
    int tiles = 0;
    if (whole) {
      const uint32_t tile0 = shl32(1u, region_size) - 1u;
      for (int t = 0; t + region_size <= width; t += region_size) {
        const uint32_t tile = tile0 << t;
        if ((band & tile) == tile) {
          reg |= tile;
          tiles += lane == b0;
        }
      }
    }
    k += __reduce_add_sync(seg, tiles);
  }

  if (active) {
    const uint32_t clear = (w == full ? full : 0u) | cols | reg;
    words_out[env * height + lane] =
        legal ? static_cast<long long>(w & ~clear) : x64;
    if (lane == 0) {
      k_out[env] = legal ? k : 0;
      legal_out[env] = legal;
    }
  }
}

}  // namespace

// words (N, H) i64 holding u32 row words; attrs (N, 11) i32 rows [h, w,
// cells, dr1, dc1, h1, w1, dr2, dc2, h2, w2]; r, c (N,) i32; valid (N,)
// bool; outputs words_out (N, H) i64, k (N,) i32, legal (N,) bool.
// region_size 0 means no region clear.  per_warp = 32 / H envs a warp;
// H <= 32, W <= 32.
extern "C" int bp_packed_apply(const void* words, const void* attrs,
                               const void* r, const void* c,
                               const void* valid, void* words_out,
                               void* k_out, void* legal_out, int n,
                               int height, int width, int region_size,
                               int per_warp, void* stream) {
  if (height < 1 || height > 32 || per_warp != 32 / height || width > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int envs_per_block = kThreads / 32 * per_warp;
    const long long blocks = (static_cast<long long>(n) + envs_per_block - 1) / envs_per_block;
    packed_apply_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(words), static_cast<const int32_t*>(attrs),
        static_cast<const int32_t*>(r), static_cast<const int32_t*>(c),
        static_cast<const uint8_t*>(valid), static_cast<long long*>(words_out),
        static_cast<int32_t*>(k_out), static_cast<uint8_t*>(legal_out), n,
        height, width, region_size, per_warp);
  }
  return static_cast<int>(cudaGetLastError());
}
