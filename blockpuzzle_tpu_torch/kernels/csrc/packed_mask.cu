// Hand action mask from packed board words, with a second entry that gives
// the same legality as row words.  No Pallas source: the JAX package runs
// the mask in jnp, as `_bitboard_legal_slots` and
// `_bitboard_mask_from_words` (blockpuzzle_tpu/env/core.py:489,541), the
// mask of its packed engine, and the words as `legal_words`
// (blockpuzzle_tpu/env/words.py:78), the serving sampler's input.  The
// plain versions are `packed_mask_plain` and `packed_legal_words_plain`
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
// Every lane runs every shuffle and barrier.
//
// The words entry (`packed_words_kernel`, B7w) shares the per-lane
// legality (`row_bits`) and stores each lane's row word as it is, one int64
// at out[es * H + lane]: a warp's stores are one contiguous span, and there
// is no shared memory and no barrier.  Its bound is device memory too: per
// env H int64 words and S int32 ids in, S*H int64 words out, 164 B on the
// default preset, 8.06 MB at N = 49152, 2.41 us at 3.35 TB/s.  What holds it
// is its issue rate: a warp carries only 32 / H env-slots (3 at H = 10)
// through some 240 instructions, 16384 warps on the default preset.  Its
// design cuts instructions, not round trips: the band's shuffle loops
// unroll where the footprint's shape is known at compile time (the
// presets' 2 words of 3 rows, `packed_words_kernel<2, 3>`; other shapes
// the general loops), and the division by S drops where S = 1.  Timed in turns
// on an H100 (chip_measure.py --parts kernels), unrolling took 0.70-0.80x
// of the time of the kernel it replaces on every board of at most 32 rows;
// persistent blocks walking groups of env-slots with the rule tables in
// shared memory took 1.15-1.20x, the tables in shared memory alone
// 1.05-1.08x.  From 16 rows, and where a warp here leaves 5 or more lanes
// idle (9 and 11-13 rows), the words entry takes the tall words kernel of
// packed_tall.cu instead (kernels/packed.py `words_kernel_kind`), which beat
// this one on 9, 16 and 24 rows.
//
// The small quotients (lane / H, byte / W, both below 2^14) are a float
// multiply by the reciprocal: (q + 1/2) / d lies at least 1/(2d) >= 1/64
// from an integer, and the rounding error is below 2^-9.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 16;  // kernels/packed.py mask_block_warps
constexpr int kWordsWarps = 4;  // warps a block of the words kernel
constexpr unsigned kAll = 0xffffffffu;

// q / d for 0 <= q < 2^14, 1 <= d <= 32, given inv = __frcp_rn(d)
__device__ __forceinline__ int small_div(int q, float inv) {
  return static_cast<int>((static_cast<float>(q) + 0.5f) * inv);
}

// bits 0..3 of x -> bytes 0..3 of the result, each 0 or 1
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xfu) * 0x00204081u) & 0x01010101u;
}

// Legal bits of anchor row `lane` (bit c: anchor (lane, c) is legal) of an
// env-slot holding piece `pid` whose board row `lane` is `x` (`full` and -1
// where the lane holds no env-slot: 0).  Lane `l` of the warp holds row
// `lane` of its segment; every lane of the warp must call it (it
// shuffles).  The mask and the words kernels both call it, so the two
// entries cannot drift apart.  NW > 0: the footprint words (NW of FPW
// fields) are known at compile time and the band's loops unroll (the words
// kernel's instances); NW = 0 takes nwords and fpw as they come.
template <int NW = 0, int FPW = 0>
__device__ __forceinline__ uint32_t row_bits(uint32_t x, int pid,
                                             const uint32_t* __restrict__ prow,
                                             const int32_t* __restrict__ piece_w, int l,
                                             int lane, int height, int width, int num_pieces,
                                             int nwords, int fpw) {
  const uint32_t full = width < 32 ? (1u << width) - 1u : kAll;
  const bool has = pid >= 0 && pid < num_pieces;
  const int pw = has ? piece_w[pid] : width + 1;  // no piece: no anchor
  // blocked bit c: some footprint cell of anchor (lane, c) meets the board
  uint32_t blocked = 0;
  if constexpr (NW > 0) {  // the loops below, unrolled
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint32_t wk = 0;
#pragma unroll
      for (int j = 0; j < FPW; ++j) {
        const int t = lane + k * FPW + j;
        const uint32_t y = __shfl_sync(kAll, x, t < height ? l + k * FPW + j : l);
        wk |= (t < height ? y : full) << (j * width);
      }
      if (pw <= width) {
        for (uint32_t m = prow[pid * NW + k]; m != 0; m &= m - 1) {
          blocked |= wk >> (__ffs(m) - 1);
        }
      }
    }
  } else {
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
  }
  return pw <= width
             ? ~blocked & ((width - pw + 1 < 32 ? 1u << (width - pw + 1) : 0u) - 1u)
             : 0u;
}

// `row_bits` of anchor row `lane` of env-slot `es`, its board row and piece
// id read from device memory, 0 where the lane is not `active`.
__device__ __forceinline__ uint32_t legal_row_bits(
    const long long* __restrict__ words, const int32_t* __restrict__ queue,
    const uint32_t* __restrict__ prow, const int32_t* __restrict__ piece_w,
    int es, bool active, int l, int lane, int height, int width, int slots,
    int num_pieces, int nwords, int fpw) {
  uint32_t x = width < 32 ? (1u << width) - 1u : kAll;
  int pid = -1;
  if (active) {
    pid = queue[es];
    x = static_cast<uint32_t>(words[static_cast<long long>(es / slots) * height + lane]);
  }
  return row_bits(x, pid, prow, piece_w, l, lane, height, width, num_pieces, nwords, fpw);
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
  const uint32_t bits = legal_row_bits(words, queue, prow, piece_w, es, active, l, lane,
                                       height, width, slots, num_pieces, nwords, fpw);
  if (active) {
    rows[seg * height + lane] = bits;
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

// The words entry: the same legal bits, stored as they are, one int64 word
// per (env-slot, row) at out[es * H + lane].  A warp's segments are
// consecutive env-slots, so its stores are one contiguous span; there is
// no shared memory and no barrier.  NW, FPW: `row_bits`' instance.
template <int NW, int FPW>
__global__ void __launch_bounds__(kWordsWarps * 32)
    packed_words_kernel(const long long* __restrict__ words,
                        const int32_t* __restrict__ queue,
                        const uint32_t* __restrict__ prow,
                        const int32_t* __restrict__ piece_w,
                        long long* __restrict__ out, int total, int height,
                        int width, int slots, int num_pieces, int nwords, int fpw,
                        int per_warp) {
  const int l = threadIdx.x % 32;
  const int s = small_div(l, __frcp_rn(static_cast<float>(height)));  // per_warp: left over
  const int lane = l - s * height;  // anchor row
  const int es = (blockIdx.x * kWordsWarps + threadIdx.x / 32) * per_warp + s;
  const bool active = s < per_warp && es < total;
  uint32_t x = width < 32 ? (1u << width) - 1u : kAll;
  int pid = -1;
  if (active) {
    pid = queue[es];
    const int env = slots > 1 ? es / slots : es;  // the same in every thread
    x = static_cast<uint32_t>(words[static_cast<long long>(env) * height + lane]);
  }
  const uint32_t bits = row_bits<NW, FPW>(x, pid, prow, piece_w, l, lane, height, width,
                                          num_pieces, nwords, fpw);
  if (active) out[static_cast<long long>(es) * height + lane] = bits;
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

// The words entry: out (N, S*H) i64, word es*H + r holding the legal bits
// of anchor row r of env-slot es; the other arguments as bp_packed_mask's,
// with N*S < 2^31 - 2^9 (so that no thread's env-slot index overflows).
// The footprint of the presets this kernel serves (default and tenten: 2
// words of 3 rows) takes an unrolled instance, any other the general one.
extern "C" int bp_packed_words(const void* words, const void* queue,
                               const void* prow, const void* piece_w,
                               void* out, int n, int height, int width,
                               int slots, int num_pieces, int nwords, int fpw,
                               int per_warp, void* stream) {
  const long long total = static_cast<long long>(n) * slots;
  if (height < 1 || height > 32 || per_warp != 32 / height || width > 32 ||
      total > INT_MAX - kWordsWarps * 32 * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    const int per_block = kWordsWarps * per_warp;
    const int blocks = static_cast<int>((total + per_block - 1) / per_block);
    const auto kernel =
        nwords == 2 && fpw == 3 ? packed_words_kernel<2, 3> : packed_words_kernel<0, 0>;
    kernel<<<blocks, kWordsWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(words), static_cast<const int32_t*>(queue),
        static_cast<const uint32_t*>(prow), static_cast<const int32_t*>(piece_w),
        static_cast<long long*>(out), static_cast<int>(total), height, width, slots,
        num_pieces, nwords, fpw, per_warp);
  }
  return static_cast<int>(cudaGetLastError());
}
