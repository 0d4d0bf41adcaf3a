// Device code shared by the bit-row u8 kernels: the hand mask of mask.cu
// (`mask_rows_kernel`, and `mask_wide_kernel` on multi-word rows), the
// clear scan of clear.cu (`clear_rows_kernel`, `clear_wide_kernel`), the
// apply of collision.cu (`apply_rows_kernel`) and the all-pieces legality
// of legality.cu (`legality_rows_kernel`); and by the kernels of boards of
// more than 32 rows (`mask_tall_kernel`, `clear_tall_kernel` and the tall
// packed apply of packed_tall.cu), which hold a board in one warp, rows
// l + 32 j in lane l (`rows_below`, `clear_tall`, `store_tall` below), and
// of more than 128 rows (`mask_deep_kernel`, `clear_deep_kernel`, the
// general packed mask), which walk a board in windows of 32 rows; and by
// the kernels of rows of more than 128 cells (`mask_xwide_kernel`,
// `clear_xwide_kernel`), a lane a word of every row (`stage_words`,
// `store_words_n`).
//
// All but those take boards as (N, H*W) u8 cells, H <= 32, and work on them as row
// words: lane r of a segment of H lanes holds board row r as a W-bit word
// where W <= 32, or as NW = ceil(W / 32) words, word i holding columns
// 32 i .. 32 i + 31, where 32 < W <= 128 (the wide kernels); bit c is set
// iff cell (r, c) is nonzero, and no bit >= W is set (`seat` gives a thread
// its place).  A block first copies its span of boards into shared memory
// (`stage_bytes`, 16-byte loads), each lane packs its row from there
// (`pack_row`, four cells a 32-bit load, one call a word), and at the end
// the block writes its output rows, staged in shared memory as bit words,
// as 16-byte vectors of 0/1 bytes (`store_rows` for an aligned span under
// 2^21 bytes, `store_words` for rows of NW words, `store_span` for any
// other).  `clear_segment` is the simultaneous clear on row words, shared by
// the clear and the apply, `clear_words` the same on NW words a row.
// `small_div` and `spread4` are copies of packed_mask.cu's, which stays as
// it is.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bit_rows {

constexpr int kMaxWarps = 16;  // kernels/packed.py mask_block_warps
constexpr unsigned kAll = 0xffffffffu;

// q / d for 0 <= q < 2^21 and any d >= 1, given inv = __frcp_rn(d).  x =
// q + 1/2 is exact in float; inv = (1 + e1) / d and the product rounds to
// x * inv * (1 + e2), |e1|, |e2| <= 2^-24, so it lies within x / d * 2^-22
// of x / d = (2q + 1) / (2d), which is at least 1/(2d) from every integer
// (an odd numerator over an even denominator).  x / d * 2^-22 < 1/(2d)
// while x < 2^21, so the truncation is the integer quotient.  The kernels
// divide lanes (q < 32), staged envs (q < 2^10), a block's output bytes
// by the row width (q < 16 warps * 32 rows * 128 cells = 2^16, W <= 128),
// and, in the tall packed mask (packed_tall.cu `packed_anchor_kernel`), a
// thread index by the segment's C (q < 1024), a staged row by H (q < 114
// boards * 128 rows < 2^14), a staged full row by the full rows a board
// (q < 114 * 38 < 2^13) and an env-slot by S (q < 2^11).
__device__ __forceinline__ int small_div(int q, float inv) {
  return static_cast<int>((static_cast<float>(q) + 0.5f) * inv);
}

// q / d for q * d < 2^32 and 1 <= d <= 32, given magic = wide_magic(d).
// With m = floor(2^32 / d) + 1, m * d = 2^32 + e and 1 <= e <= d, so
// q * m / 2^32 = q / d + q * e / (d * 2^32): the last term is below 1 / d,
// the least distance from q / d up to the next integer, when q * e < 2^32.
// (d = 1 would need m = 2^32 + 1.)
__device__ __forceinline__ uint32_t wide_magic(int d) {
  return 0xffffffffu / static_cast<uint32_t>(d) + 1u;
}
__device__ __forceinline__ int wide_div(int q, int d, uint32_t magic) {
  return d > 1 ? static_cast<int>(__umulhi(static_cast<uint32_t>(q), magic)) : q;
}

// bits 0..3 of x -> bytes 0..3 of the result, each 0 or 1
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xfu) * 0x00204081u) & 0x01010101u;
}

// Copies bytes [lo, hi) of `src` into `buf` (16-byte aligned): byte lo + i
// lands at buf[d + i], where d = (src + lo) mod 16 is returned.  The bytes
// of whole aligned 16-byte chunks go as one uint4 load and store each, the
// unaligned head and the ragged tail byte by byte, so any start address
// works.  Every thread of the block calls it; a __syncthreads must follow
// before `buf` is read.
__device__ __forceinline__ int stage_bytes(const uint8_t* __restrict__ src,
                                           long long lo, long long hi,
                                           uint8_t* buf) {
  const uint8_t* p = src + lo;
  const int len = static_cast<int>(hi - lo);
  const int d = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const int head = min((16 - d) & 15, len);
  const int nvec = (len - head) / 16;
  const uint4* from = reinterpret_cast<const uint4*>(p + head);
  uint4* to = reinterpret_cast<uint4*>(buf + d + head);  // d + head is 0 or 16
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) to[i] = from[i];
  for (int i = threadIdx.x; i < head; i += blockDim.x) buf[d + i] = p[i];
  for (int i = head + 16 * nvec + threadIdx.x; i < len; i += blockDim.x) {
    buf[d + i] = p[i];
  }
  return d;
}

// The W-bit word of the board row at byte `start` of the staged `span`
// (16-byte aligned): bit c = (span[start + c] != 0).  It reads the
// (W + 6) / 4 aligned 32-bit words that hold the row -- up to 3 bytes
// before it and 6 past its end, inside the `smem_bytes` allocation, whose
// values only reach bits the final shift and mask drop -- marks each
// nonzero byte in its top bit and gathers a word's four top bits with one
// multiply: bits 7, 15, 23, 31 times 2^21 + 2^14 + 2^7 + 1 land on bits
// 28..31, and no other product reaches them or carries into them.
__device__ __forceinline__ uint32_t nonzero_nibble(uint32_t v) {  // bit j: byte j != 0
  const uint32_t top = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
  return (top * 0x00204081u) >> 28;
}

__device__ __forceinline__ uint32_t pack_row(const uint8_t* span, int start, int width) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(span) + (start >> 2);
  const int nwords = (width + 6) >> 2;
  uint64_t nibbles = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    if (i < nwords) nibbles |= static_cast<uint64_t>(nonzero_nibble(words[i])) << (4 * i);
  }
  const uint32_t x = static_cast<uint32_t>(nibbles >> (start & 3));
  return width < 32 ? x & ((1u << width) - 1u) : x;
}

// The row at byte `start` of `span` as NW words, 32 (NW - 1) < W <= 32 NW
// (NW = 1: W <= 32): word i packs the min(32, W - 32 i) cells from 32 i on.
template <int NW>
__device__ __forceinline__ void pack_words(const uint8_t* span, int start, int width,
                                           uint32_t (&x)[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) x[i] = pack_row(span, start + 32 * i, min(32, width - 32 * i));
}

// Writes `bytes` 0/1 bytes to `o` (16-byte aligned): byte q is bit q % W of
// rows[q / W], and no row word holds a bit >= W.  Each thread assembles 16
// consecutive bits from the (at most three) rows they fall in, spreads each
// 4 bits into 4 bytes with one multiply, and stores one uint4; the ragged
// tail goes byte by byte.  Every thread of the block calls it, after a
// __syncthreads that follows the last write to `rows`; bytes < 2^21.
__device__ __forceinline__ void store_rows(const uint32_t* rows, uint8_t* o,
                                           int bytes, int width) {
  const int nvec = bytes / 16;
  const float inv_w = __frcp_rn(static_cast<float>(width));
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
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

// `store_rows` for rows of NW words, 32 (NW - 1) < W <= 32 NW: byte q of
// `o` (16-byte aligned) is column c = q % W of row q / W, bit c % 32 of
// rows[(q / W) * NW + c / 32], and no word holds a bit >= W.  As W > 16, 16
// consecutive bytes fall in at most two rows; inside a row they may
// straddle a word boundary, so a thread funnel-shifts the pair of words
// holding column c (the top word's pair is zeros) into the 32 columns from
// c, and where the row has fewer than 16 left (W - c < 16) the next row's
// first word supplies the rest, shifted up past them.  Then as `store_rows`:
// one uint4 a thread, the ragged tail byte by byte.  Every thread of the
// block calls it, after a __syncthreads that follows the last write to
// `rows`; bytes < 2^21.
template <int NW>
__device__ __forceinline__ void store_words(const uint32_t* rows, uint8_t* o, int bytes,
                                            int width) {
  const int nvec = bytes / 16;
  const float inv_w = __frcp_rn(static_cast<float>(width));
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int q = 16 * i;
    const int row = small_div(q, inv_w);
    const int c = q - row * width;
    const uint32_t* r = rows + row * NW;
    const int w = c >> 5;
    uint32_t bits = __funnelshift_r(r[w], w + 1 < NW ? r[w + 1] : 0u, c & 31);
    if (width - c < 16) bits |= r[NW] << (width - c);
    reinterpret_cast<uint4*>(o)[i] = make_uint4(spread4(bits), spread4(bits >> 4),
                                                spread4(bits >> 8), spread4(bits >> 12));
  }
  for (int q = nvec * 16 + threadIdx.x; q < bytes; q += blockDim.x) {
    const int row = small_div(q, inv_w);
    const int c = q - row * width;
    o[q] = (rows[row * NW + (c >> 5)] >> (c & 31)) & 1u;
  }
}

// `store_rows` for any span: `bytes` 0/1 bytes to out[at ...], `out` 16-byte
// aligned, `at` any byte offset (64 bits: N * P * HW may pass 2^31), and
// bytes * W < 2^32 (`wide_div`).  The bytes up to the first 16-byte boundary
// and the ragged tail go byte by byte, the vectors between as in
// `store_rows`.  Every thread of the block calls it, after a __syncthreads
// that follows the last write to `rows`.
__device__ __forceinline__ void store_span(const uint32_t* rows, uint8_t* out,
                                           long long at, int bytes, int width) {
  uint8_t* o = out + at;
  const int head = min(static_cast<int>((16 - (at & 15)) & 15), bytes);
  const int nvec = (bytes - head) / 16;
  const uint32_t magic = wide_magic(width);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int q = head + 16 * i;
    int row = wide_div(q, width, magic);
    int c = q - row * width;
    uint32_t bits = 0;
    for (int got = 0; got < 16; got += width - c, ++row, c = 0) {
      bits |= (rows[row] >> c) << got;
    }
    *reinterpret_cast<uint4*>(o + q) = make_uint4(spread4(bits), spread4(bits >> 4),
                                                  spread4(bits >> 8), spread4(bits >> 12));
  }
  // the head's bytes, then the tail's
  for (int j = threadIdx.x; j < bytes - 16 * nvec; j += blockDim.x) {
    const int q = j < head ? j : j + 16 * nvec;
    const int row = wide_div(q, width, magic);
    o[q] = (rows[row] >> (q - row * width)) & 1u;
  }
}

// Shared memory of a bit-row kernel: `nrows` staged row words, rounded up
// to 16 bytes, then `nspans` staged spans of `span` board bytes each.  A
// span starts up to 15 bytes after a 16-byte boundary (`stage_bytes`) and is
// read up to 6 bytes past its end (`pack_row`); the next one begins
// `span_stride` bytes after it, on a 16-byte boundary again.
__host__ __device__ constexpr int span_stride(long long span) {
  return static_cast<int>((span + 32 + 15) / 16 * 16);
}

__host__ __device__ constexpr int smem_bytes(int nrows, long long span, int nspans = 1) {
  return static_cast<int>((4 * nrows + 15) / 16 * 16 + (nspans - 1) * span_stride(span) +
                          span + 32);
}

__device__ __forceinline__ uint8_t* staged_span(uint8_t* smem, int nrows) {
  return smem + (4 * nrows + 15) / 16 * 16;
}

// A thread's place among its warp's segments of `height` lanes, `per_warp`
// = 32 / height of them; the 32 - per_warp * height left-over lanes form a
// segment of their own (s == per_warp), which holds no board.
struct Seat {
  int l;          // lane of the warp
  int s;          // segment of the warp
  int lane;       // lane of the segment: the board row this thread holds
  int base;       // the segment's first warp lane
  int seg;        // segment of the block
  unsigned mask;  // the segment's lanes in ballot bits
};

__device__ __forceinline__ Seat seat(int height, int per_warp) {
  Seat t;
  t.l = threadIdx.x % 32;
  t.s = small_div(t.l, __frcp_rn(static_cast<float>(height)));
  t.lane = t.l - t.s * height;
  t.base = t.s * height;
  t.seg = threadIdx.x / 32 * per_warp + t.s;
  t.mask = t.s < per_warp ? (height == 32 ? kAll : ((1u << height) - 1u) << t.base)
                          : kAll << t.base;
  return t;
}

// The simultaneous clear of the board whose row word `x` the caller's
// segment holds (a lane of no board passes the AND's identity, all ones):
// full rows by `x == 2^W - 1` (a ballot), full columns by one
// `__reduce_and_sync` over the segment, regions (region_size > 0) by ANDing
// each band's rows by shuffles from explicit source lanes and testing its
// region_size-bit fields.  Returns the cleared word and sets `k` to the
// number of full lines, by popcounts and `__reduce_add_sync`.  Every lane
// of the warp calls it: the ballot and the shuffles name the whole warp,
// the reductions the caller's segment.
__device__ __forceinline__ uint32_t clear_segment(uint32_t x, bool active, const Seat& t,
                                                  int height, int width, int region_size,
                                                  int& k) {
  const uint32_t full = width < 32 ? (1u << width) - 1u : kAll;
  const unsigned rows_full = __ballot_sync(kAll, active && x == full) & t.mask;
  const uint32_t cols = __reduce_and_sync(t.mask, x);
  k = __popc(rows_full) + __popc(cols);
  uint32_t reg = 0;
  if (region_size > 0) {
    const int b0 = t.lane - t.lane % region_size;   // first row of this lane's band
    const bool whole = b0 + region_size <= height;  // a whole band on the board
    uint32_t band = kAll;
    for (int i = 0; i < region_size; ++i) {
      band &= __shfl_sync(kAll, x, whole ? t.base + b0 + i : t.l);
    }
    int tiles = 0;
    if (whole) {
      const uint32_t tile0 = region_size < 32 ? (1u << region_size) - 1u : kAll;
      for (int i = 0; i + region_size <= width; i += region_size) {
        const uint32_t tile = tile0 << i;
        if ((band & tile) == tile) {
          reg |= tile;
          tiles += t.lane == b0;
        }
      }
    }
    k += __reduce_add_sync(t.mask, tiles);
  }
  return x & ~((x == full ? full : 0u) | cols | reg);
}

// The full region_size-bit fields of `band`, a row of NW words (32 (NW -
// 1) < W <= 32 NW): the fields start at columns c0 = 0, rs, 2 rs, ... with
// c0 + rs <= W, in column order.  Where 32 is not a multiple of rs a field
// may straddle two words (W = 36, rs = 3: columns 30..32), so each is read
// from the funnel-shifted pair of words holding its first column, and a
// full one is marked in `reg` in both.  Returns how many are full;
// region_size 1..32.
template <int NW>
__device__ __forceinline__ int full_fields(const uint32_t (&band)[NW], int width,
                                           int region_size, uint32_t (&reg)[NW]) {
  const uint32_t tile0 = region_size < 32 ? (1u << region_size) - 1u : kAll;
  int tiles = 0;
  int c0 = 0;  // the next field's first column
#pragma unroll
  for (int w = 0; w < NW; ++w) {  // the fields whose first column is in word w
    for (; c0 < 32 * (w + 1) && c0 + region_size <= width; c0 += region_size) {
      const int b = c0 - 32 * w;
      const uint32_t field =
          __funnelshift_r(band[w], w + 1 < NW ? band[w + 1] : 0u, b) & tile0;
      if (field == tile0) {
        reg[w] |= tile0 << b;
        if (w + 1 < NW && b + region_size > 32) reg[w + 1] |= tile0 >> (32 - b);
        ++tiles;
      }
    }
  }
  return tiles;
}

// `clear_segment` on rows of NW words (32 (NW - 1) < W <= 32 NW), cleared
// in place: a row is full when every word equals its column mask (all ones
// but the top word's, 2^(W - 32 (NW - 1)) - 1, or all ones when 32 divides
// W), one ballot; full columns by one `__reduce_and_sync` a word; regions
// by ANDing each band's rows, word by word, by shuffles from explicit
// source lanes, then testing its region_size-bit fields (`full_fields`).
// Sets `k` as `clear_segment` does; region_size <= 32.
template <int NW>
__device__ __forceinline__ void clear_words(uint32_t (&x)[NW], bool active, const Seat& t,
                                            int height, int width, int region_size,
                                            int& k) {
  const int tail = width - 32 * (NW - 1);  // columns of the top word: 1..32
  const uint32_t top = tail < 32 ? (1u << tail) - 1u : kAll;
  bool full = true;
#pragma unroll
  for (int i = 0; i < NW; ++i) full &= x[i] == (i + 1 < NW ? kAll : top);
  const unsigned rows_full = __ballot_sync(kAll, active && full) & t.mask;
  k = __popc(rows_full);
  uint32_t cols[NW], reg[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    cols[i] = __reduce_and_sync(t.mask, x[i]);
    k += __popc(cols[i]);
    reg[i] = 0;
  }
  if (region_size > 0) {
    const int b0 = t.lane - t.lane % region_size;   // first row of this lane's band
    const bool whole = b0 + region_size <= height;  // a whole band on the board
    uint32_t band[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) band[i] = kAll;
    for (int r = 0; r < region_size; ++r) {
      const int src = whole ? t.base + b0 + r : t.l;
#pragma unroll
      for (int i = 0; i < NW; ++i) band[i] &= __shfl_sync(kAll, x[i], src);
    }
    int tiles = 0;
    if (whole) {
      const int got = full_fields<NW>(band, width, region_size, reg);
      tiles = t.lane == b0 ? got : 0;
    }
    k += __reduce_add_sync(t.mask, tiles);
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    x[i] &= ~((full ? (i + 1 < NW ? kAll : top) : 0u) | cols[i] | reg[i]);
  }
}

// Tall boards (32 < H <= 32 NR): one warp holds one board, lane l rows
// l + 32 j in slot j < NR, each as NW words (one where W <= 32).  A row
// below row r, r + d for 0 <= d < 32, lies in lane (l + d) mod 32, in slot
// j, or in slot j + 1 where l + d >= 32 (the seam): `rows_below` shuffles
// every slot from that lane once and picks, rows past slot NR - 1 reading
// `past`.  Every lane of the warp calls it.
template <int NR>
__device__ __forceinline__ void rows_below(const uint32_t (&v)[NR], int d, uint32_t past,
                                           uint32_t (&out)[NR]) {
  const int l = threadIdx.x % 32;
  const int src = (l + d) & 31;
  const bool seam = l + d >= 32;
  uint32_t s[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) s[j] = __shfl_sync(kAll, v[j], src);
#pragma unroll
  for (int j = 0; j < NR; ++j) out[j] = seam ? (j + 1 < NR ? s[j + 1] : past) : s[j];
}

// The simultaneous clear of a tall board (`clear_words` on the slots above),
// in place: rows r >= H hold all ones (the AND's identity) and count for
// nothing, and `active` is false on a warp that holds no board.  Full rows
// by one ballot a slot; full columns by ANDing a lane's slots, then one
// `__reduce_and_sync` over the warp a word; regions (region_size 1..32):
// each row ANDs itself with the region_size - 1 rows below it
// (`rows_below`), a band's first row r (r % rs == 0, r + rs <= H) tests the
// fields of that AND (`full_fields`) and counts them, and every row
// takes its band's cleared fields from its first row, e = r % rs rows
// above: lane (l - e) mod 32, slot j - 1 where l < e.  A band may cross the
// seam (H = 36, rs = 3: rows 30, 31 in slot 0, row 32 in lane 0 of slot 1).
// Sets `k` to the number of full lines, the same in every lane.
template <int NR, int NW>
__device__ __forceinline__ void clear_tall(uint32_t (&x)[NR][NW], bool active, int height,
                                           int width, int region_size, int& k) {
  const int l = threadIdx.x % 32;
  const int tail = width - 32 * (NW - 1);  // columns of the top word: 1..32
  const uint32_t top = tail < 32 ? (1u << tail) - 1u : kAll;
  bool full[NR];
  k = 0;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    bool f = true;
#pragma unroll
    for (int i = 0; i < NW; ++i) f &= x[j][i] == (i + 1 < NW ? kAll : top);
    full[j] = f;
    k += __popc(__ballot_sync(kAll, active && l + 32 * j < height && f));
  }
  uint32_t cols[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t c = kAll;
#pragma unroll
    for (int j = 0; j < NR; ++j) c &= x[j][i];
    cols[i] = __reduce_and_sync(kAll, c);
    k += __popc(cols[i]);
  }
  uint32_t reg[NR][NW];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
#pragma unroll
    for (int i = 0; i < NW; ++i) reg[j][i] = 0;
  }
  if (region_size > 0) {
    uint32_t band[NR][NW];  // row r: the AND of rows r .. r + rs - 1
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int i = 0; i < NW; ++i) band[j][i] = x[j][i];
    }
    for (int d = 1; d < region_size; ++d) {
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        uint32_t v[NR], y[NR];
#pragma unroll
        for (int j = 0; j < NR; ++j) v[j] = x[j][i];
        rows_below<NR>(v, d, kAll, y);
#pragma unroll
        for (int j = 0; j < NR; ++j) band[j][i] &= y[j];
      }
    }
    const int step = 32 % region_size;  // r % rs from one slot to the next
    int e[NR];                          // r % rs
    e[0] = l % region_size;
#pragma unroll
    for (int j = 1; j < NR; ++j) {
      e[j] = e[j - 1] + step;
      if (e[j] >= region_size) e[j] -= region_size;
    }
    int tiles = 0;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int r = l + 32 * j;
      if (e[j] == 0 && r + region_size <= height) {  // a whole band's first row
        tiles += full_fields<NW>(band[j], width, region_size, reg[j]);
      }
    }
    k += __reduce_add_sync(kAll, tiles);
    // each row takes its band's fields from the band's first row, e rows up
    uint32_t got[NR][NW];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int src = (l - e[j]) & 31;
      const bool seam = l < e[j];
#pragma unroll
      for (int i = 0; i < NW; ++i) {  // slot 0 never crosses the seam (e <= l)
        const uint32_t up = __shfl_sync(kAll, reg[j > 0 ? j - 1 : 0][i], src);
        const uint32_t here = __shfl_sync(kAll, reg[j][i], src);
        got[j][i] = seam ? up : here;
      }
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
#pragma unroll
      for (int i = 0; i < NW; ++i) reg[j][i] = got[j][i];
    }
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      x[j][i] &= ~((full[j] ? (i + 1 < NW ? kAll : top) : 0u) | cols[i] | reg[j][i]);
    }
  }
}

// `store_rows` for rows of NW > 1 words (W > 32), NW known at run time: byte
// q of out[at ...] (`out` 16-byte aligned, `at` any offset) is column
// c = q % W of row q / W, bit c % 32 of rows[(q / W) * nw + c / 32], and no
// word holds a bit >= W.  The bytes up to the first 16-byte boundary and the
// ragged tail go byte by byte; 16 consecutive bytes fall in at most two
// rows, so each vector between funnel-shifts the pair of words holding
// column c (the top word's pair is zeros) into the 32 columns from c and,
// where the row has fewer than 16 left, takes the next row's first word
// shifted up past them, spreads the 16 bits and stores one uint4.  Threads
// t = 0 .. nt - 1 of the block (or of a warp) share the work: each calls it,
// after the barrier that follows the last write to `rows`; bytes < 2^21.
__device__ __forceinline__ void store_words_n(const uint32_t* rows, uint8_t* out, long long at,
                                              int bytes, int width, int nw, int t, int nt) {
  uint8_t* o = out + at;
  const int head = min(static_cast<int>((16 - (at & 15)) & 15), bytes);
  const int nvec = (bytes - head) / 16;
  const float inv_w = __frcp_rn(static_cast<float>(width));
  for (int v = t; v < nvec; v += nt) {
    const int q = head + 16 * v;
    const int row = small_div(q, inv_w);
    const int c = q - row * width;
    const uint32_t* r = rows + row * nw;
    const int w = c >> 5;
    uint32_t bits = __funnelshift_r(r[w], w + 1 < nw ? r[w + 1] : 0u, c & 31);
    if (width - c < 16) bits |= r[nw] << (width - c);
    *reinterpret_cast<uint4*>(o + q) = make_uint4(spread4(bits), spread4(bits >> 4),
                                                  spread4(bits >> 8), spread4(bits >> 12));
  }
  for (int j = t; j < bytes - 16 * nvec; j += nt) {
    const int q = j < head ? j : j + 16 * nvec;
    const int row = small_div(q, inv_w);
    const int c = q - row * width;
    o[q] = (rows[row * nw + (c >> 5)] >> (c & 31)) & 1u;
  }
}

// The store of the tall kernels: `bytes` 0/1 bytes to out[at ...] (`out`
// 16-byte aligned, `at` any offset): byte q is column c = q % W of row
// q / W, bit c % 32 of rows[(q / W) * NW + c / 32], and no word holds a bit
// >= W.  The bytes up to the first 16-byte boundary and the ragged tail go
// byte by byte; each vector between gathers its 16 bits as `store_rows`
// does where a row is one word (W <= 32: up to 16 rows), spreads them and
// stores one uint4; rows of NW > 1 words are `store_words_n`'s.  Threads
// t = 0 .. nt - 1 of the block (or of a warp) share the work: each calls
// it, after the barrier that follows the last write to `rows`; bytes <
// 2^21.
template <int NW>
__device__ __forceinline__ void store_tall(const uint32_t* rows, uint8_t* out, long long at,
                                           int bytes, int width, int t, int nt) {
  if constexpr (NW > 1) {
    store_words_n(rows, out, at, bytes, width, NW, t, nt);
  } else {
    uint8_t* o = out + at;
    const int head = min(static_cast<int>((16 - (at & 15)) & 15), bytes);
    const int nvec = (bytes - head) / 16;
    const float inv_w = __frcp_rn(static_cast<float>(width));
    for (int v = t; v < nvec; v += nt) {
      const int q = head + 16 * v;
      int row = small_div(q, inv_w);
      int c = q - row * width;
      uint32_t bits = 0;
      for (int got = 0; got < 16; got += width - c, ++row, c = 0) {
        bits |= (rows[row] >> c) << got;
      }
      *reinterpret_cast<uint4*>(o + q) = make_uint4(spread4(bits), spread4(bits >> 4),
                                                    spread4(bits >> 8), spread4(bits >> 12));
    }
    for (int j = t; j < bytes - 16 * nvec; j += nt) {
      const int q = j < head ? j : j + 16 * nvec;
      const int row = small_div(q, inv_w);
      o[q] = (rows[row] >> (q - row * width)) & 1u;
    }
  }
}

// `store_tall` by every thread of the block, after a __syncthreads.
template <int NW>
__device__ __forceinline__ void store_tall(const uint32_t* rows, uint8_t* out, long long at,
                                           int bytes, int width) {
  store_tall<NW>(rows, out, at, bytes, width, threadIdx.x, blockDim.x);
}

// Rows of more than 128 cells (the xwide kernels, 128 < W <= 1024, any H):
// a segment of NW = ceil(W / 32) lanes holds one board, lane w word w of
// every row (cells 32 w .. 32 w + 31), the transpose of the layouts above;
// `seat(nw, 32 / nw)` gives a thread its segment and word (the xwide clear
// and apply on rows of up to 4096 cells: `seat(32, 1)`, one board a warp,
// lane l words l + 32 j).  The block's
// boards go straight from device memory to row words in shared memory
// (`stage_words`), without a staged copy of their bytes: 1088 bytes of an
// 8x136 board become 160 of words, so more boards fit an SM.

// bits 0..15 of the result: byte j of v (4 words, 16 bytes) nonzero
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return nonzero_nibble(v.x) | nonzero_nibble(v.y) << 4 | nonzero_nibble(v.z) << 8 |
         nonzero_nibble(v.w) << 12;
}

// ORs `bits` (< 2^16) into a row of words from column c on: into word c / 32
// and, where they pass its end, the next one.  kMeet: returns whether any
// of them was set already (the atomics' old words; the cover's staging).
template <bool kMeet = false>
__device__ __forceinline__ bool or_bits(uint32_t* row, int c, uint32_t bits) {
  if (bits == 0) return false;
  const int w = c >> 5, off = c & 31;
  const uint32_t lo = bits << off, hi = off > 16 ? bits >> (32 - off) : 0u;
  if constexpr (kMeet) {
    bool met = (atomicOr(row + w, lo) & lo) != 0;
    if (hi != 0) met |= (atomicOr(row + w + 1, hi) & hi) != 0;
    return met;
  } else {
    atomicOr(row + w, lo);
    if (hi != 0) atomicOr(row + w + 1, hi);
    return false;
  }
}

// The n <= 16 bits of byte q .. q + n - 1 of a run of rows of W > 16
// cells into their row words (`words`, NW a row): the columns of row q / W
// from q % W on, and past that row's end the first columns of the next.
// kMeet (the apply's cover, ORed over its boards): a bit that was set
// already marks its board's word met[R / H] (R its row).
template <bool kMeet = false>
__device__ __forceinline__ void place_bits(uint32_t* words, int q, uint32_t bits, int n,
                                           int width, int nw, float inv_w,
                                           uint32_t* met = nullptr, float inv_h = 0.f) {
  const int row = small_div(q, inv_w);
  const int c = q - row * width;
  const int k = min(n, width - c);  // the bits in this row
  if (or_bits<kMeet>(words + row * nw, c, k < 16 ? bits & ((1u << k) - 1u) : bits)) {
    met[small_div(row, inv_h)] = 1u;
  }
  if (k < n && or_bits<kMeet>(words + (row + 1) * nw, 0, bits >> k)) {
    met[small_div(row + 1, inv_h)] = 1u;
  }
}

// Bytes [lo, hi) of `src`, rows of W cells one after another (a block's
// boards), as row words in shared memory: bit c % 32 of
// words[R * NW + c / 32] set iff byte lo + R * W + c is nonzero, no bit >= W
// set.  The words are zeroed, then the bytes of whole aligned 16-byte chunks
// go as one uint4 load each, gathered to 16 bits (`pack16`) and ORed into
// the one or two rows and one to three words they fall in (shared atomics:
// two chunks may share a word); the unaligned head and the ragged tail go
// byte by byte, so any start address works.  Every thread of the block
// calls it; a __syncthreads must follow before `words` is read.
// hi - lo < 2^21 (`small_div`).  kCover (the apply's covers): the words are
// not zeroed but ORed over (they hold the boards, staged and followed by a
// __syncthreads), and a bit that meets a set one marks its board's word of
// `met` (boards of `height` rows; zeroed before the boards' barrier): the
// cover overlaps that board.
template <bool kCover = false>
__device__ __forceinline__ void stage_words(const uint8_t* __restrict__ src, long long lo,
                                            long long hi, int width, int nw,
                                            uint32_t* words, uint32_t* met = nullptr,
                                            int height = 1) {
  const uint8_t* p = src + lo;
  const int len = static_cast<int>(hi - lo);
  const float inv_w = __frcp_rn(static_cast<float>(width));
  const float inv_h = __frcp_rn(static_cast<float>(height));
  if constexpr (!kCover) {
    const int nwords = small_div(len, inv_w) * nw;
    for (int i = threadIdx.x; i < nwords; i += blockDim.x) words[i] = 0u;
    __syncthreads();
  }
  const int d = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const int head = min((16 - d) & 15, len);
  const int nvec = (len - head) / 16;
  const uint4* from = reinterpret_cast<const uint4*>(p + head);
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    place_bits<kCover>(words, head + 16 * i, pack16(from[i]), 16, width, nw, inv_w, met, inv_h);
  }
  for (int j = threadIdx.x; j < len - 16 * nvec; j += blockDim.x) {
    const int q = j < head ? j : j + 16 * nvec;
    if (p[q] != 0) place_bits<kCover>(words, q, 1u, 1, width, nw, inv_w, met, inv_h);
  }
}

}  // namespace bit_rows
