// Hand action mask from packed board words.  No Pallas source: the JAX
// package runs this in jnp, as `_bitboard_legal_slots` and
// `_bitboard_mask_from_words` (blockpuzzle_tpu/env/core.py:489,541), the
// mask of its packed engine.  The plain version is `packed_mask_plain`
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
// spills into the next field.  The output is (N, S*H*W) bool, slot-major
// then row-major anchor, as the u8 mask kernel's (mask.cu).
//
// The kernel tests all anchors of a row at once.  At c + piece_w <= W a
// footprint bit p = j*W + b (b < piece_w) lands on bit p + c <= 31 of its
// own field, so cmask[c] strips nothing there, and the word test fails iff
// some set bit p of prow[pid][k] has bit c of (wks_k(r) >> p) set:
//
//     legal bits = ~OR_k OR_{p in prow[pid][k]} (wks_k(r) >> p)
//                  & (2^(W - piece_w + 1) - 1),
//
// one shift and one OR per footprint cell for the whole row; the anchors
// with c + piece_w > W are illegal either way.
//
// Bound on the H100: device memory, the store above all.  Per env it reads
// H int64 words and S int32 ids and writes S*H*W bools: 184 B on the
// default preset (H = W = 10, S = 1), 9.0 MB at N = 49152, 2.7 us at
// 3.35 TB/s.
//
// Design: one segment of H lanes per (env, slot), lane r = anchor row r,
// P = 32 / H segments a warp (3 at H = 10); the 32 - P*H lanes left over
// run the same instructions on no env-slot.  Lane r loads board row r (a
// warp's loads are contiguous); it builds its footprint-band words one at
// a time from its neighbours' rows by `__shfl_sync` from explicit source
// lanes, rows r + t >= H reading full, and folds each into its row's legal
// bits as above, so no per-word register array is kept.  The store is the
// point: the output is bytes, W to a row.  A block of `warps` warps covers
// E = warps * P env-slots, the wrapper picking the fewest warps (at least
// 4) for which E*H*W is a multiple of 16: the block's output is then one
// contiguous span starting on a 16-byte boundary (4 warps, 1200 bytes on
// the default preset), and small blocks keep loads, arithmetic and stores
// of different blocks overlapping on an SM.  Each lane puts its row's legal
// bits, one word, into shared memory; after `__syncthreads` each thread
// assembles 16 consecutive output bits from the (at most three) rows they
// fall in, spreads each 4 bits into 4 bytes with one multiply, and stores
// the 16 bytes with one `uint4` store; the ragged tail goes byte by byte.
// Every lane runs every shuffle and barrier.  The small quotients (lane /
// H, byte / W, both below 2^14) are a float multiply by the reciprocal:
// (q + 1/2) / d lies at least 1/(2d) >= 1/64 from an integer, and the
// rounding error is below 2^-9.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 16;  // kernels/packed.py mask_block_warps
constexpr unsigned kAll = 0xffffffffu;

// q / d for 0 <= q < 2^14, 1 <= d <= 32, given inv = __frcp_rn(d)
__device__ __forceinline__ int small_div(int q, float inv) {
  return static_cast<int>((static_cast<float>(q) + 0.5f) * inv);
}

// bits 0..3 of x -> bytes 0..3 of the result, each 0 or 1
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xfu) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    packed_mask_kernel(const long long* __restrict__ words,
                       const int32_t* __restrict__ queue,
                       const uint32_t* __restrict__ prow,
                       const int32_t* __restrict__ piece_w,
                       uint8_t* __restrict__ out, int total, int height,
                       int width, int slots, int num_pieces, int nwords,
                       int fpw, int per_warp) {
  // legal bits of the block's rows: E*H <= kMaxWarps*32 rows
  __shared__ uint32_t rows[kMaxWarps * 32];
  const int l = threadIdx.x % 32;
  const int s = small_div(l, __frcp_rn(static_cast<float>(height)));  // per_warp: left over
  const int lane = l - s * height;  // anchor row
  const int seg = threadIdx.x / 32 * per_warp + s;  // env-slot in the block
  const int per_block = blockDim.x / 32 * per_warp;
  const int first = blockIdx.x * per_block;
  const int es = first + seg;  // env * slots + slot
  const bool active = s < per_warp && es < total;
  const uint32_t full = width < 32 ? (1u << width) - 1u : kAll;
  uint32_t x = full;
  int pid = -1;
  if (active) {
    pid = queue[es];
    x = static_cast<uint32_t>(words[static_cast<long long>(es / slots) * height + lane]);
  }
  const bool has = pid >= 0 && pid < num_pieces;
  const int pw = has ? piece_w[pid] : width + 1;  // no piece: no anchor
  // blocked bit c: some footprint cell of anchor (lane, c) meets the board
  uint32_t blocked = 0;
  for (int k = 0; k < nwords; ++k) {
    // board rows lane + k*fpw + j in field j, rows past H full
    uint32_t wk = 0;
    for (int j = 0; j < fpw; ++j) {
      const int t = lane + k * fpw + j;
      const uint32_t y = __shfl_sync(kAll, x, t < height ? l + k * fpw + j : l);
      wk |= (t < height ? y : full) << (j * width);
    }
    if (pw <= width) {
      for (uint32_t m = prow[pid * nwords + k]; m != 0; m &= m - 1) {
        blocked |= wk >> (__ffs(m) - 1);
      }
    }
  }
  if (active) {  // bit c: anchor (lane, c) is legal
    rows[seg * height + lane] =
        pw <= width
            ? ~blocked & ((width - pw + 1 < 32 ? 1u << (width - pw + 1) : 0u) - 1u)
            : 0u;
  }
  __syncthreads();
  const int left = total - first;
  const int bytes = (left < per_block ? left : per_block) * height * width;
  uint8_t* o = out + static_cast<long long>(first) * height * width;  // 16-byte aligned
  const int nvec = bytes / 16;
  const float inv_w = __frcp_rn(static_cast<float>(width));
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    // output bits 16i .. 16i + 15: row q / W, anchor q % W
    const int q = 16 * i;
    int row = small_div(q, inv_w);
    int c = q - row * width;
    uint32_t bits = 0;
    for (int got = 0; got < 16; got += width - c, ++row, c = 0) {
      bits |= (rows[row] >> c) << got;
    }
    reinterpret_cast<uint4*>(o)[i] = make_uint4(spread4(bits), spread4(bits >> 4),
                                                spread4(bits >> 8), spread4(bits >> 12));
  }
  for (int q = nvec * 16 + threadIdx.x; q < bytes; q += blockDim.x) {
    const int row = small_div(q, inv_w);
    o[q] = (rows[row] >> (q - row * width)) & 1u;
  }
}

}  // namespace

// words (N, H) i64 holding u32 row words; queue (N, S) i32; prow (P,
// nwords) u32 footprint words; piece_w (P,) i32; out (N, S*H*W) bool,
// 16-byte aligned.  per_warp = 32 / H env-slots a warp, warps per block
// such that warps * per_warp * H * W is a multiple of 16; H <= 32, W <= 32
// and N*S < 2^31.
extern "C" int bp_packed_mask(const void* words, const void* queue,
                              const void* prow, const void* piece_w,
                              void* out, int n, int height, int width,
                              int slots, int num_pieces, int nwords, int fpw,
                              int per_warp, int warps, void* stream) {
  const long long total = static_cast<long long>(n) * slots;
  if (height < 1 || height > 32 || per_warp != 32 / height || width > 32 ||
      warps < 1 || warps > kMaxWarps || (warps * per_warp * height * width) % 16 != 0 ||
      total > INT_MAX || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    const int per_block = warps * per_warp;
    const int blocks = static_cast<int>((total + per_block - 1) / per_block);
    packed_mask_kernel<<<blocks, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(words), static_cast<const int32_t*>(queue),
        static_cast<const uint32_t*>(prow), static_cast<const int32_t*>(piece_w),
        static_cast<uint8_t*>(out), static_cast<int>(total), height, width, slots,
        num_pieces, nwords, fpw, per_warp);
  }
  return static_cast<int>(cudaGetLastError());
}
