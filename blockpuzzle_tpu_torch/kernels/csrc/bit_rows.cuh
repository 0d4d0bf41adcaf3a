// Device code shared by the bit-row u8 kernels: the hand mask of mask.cu
// (`mask_rows_kernel`), the clear scan of clear.cu (`clear_rows_kernel`),
// the apply of collision.cu (`apply_rows_kernel`) and the all-pieces
// legality of legality.cu (`legality_rows_kernel`).
//
// All take boards as (N, H*W) u8 cells, H <= 32 and W <= 32, and work on
// them as row words: lane r of a segment of H lanes holds board row r as a
// W-bit word (bit c set iff cell (r, c) is nonzero; `seat` gives a thread
// its place).  A block first copies its span of boards into shared memory
// (`stage_bytes`, 16-byte loads), each lane packs its row from there
// (`pack_row`, four cells a 32-bit load), and at the end the block writes
// its output rows, staged in shared memory as bit words, as 16-byte vectors
// of 0/1 bytes (`store_rows` for an aligned span under 2^14 bytes,
// `store_span` for any other).  `clear_segment` is the simultaneous clear
// on row words, shared by the clear and the apply.  `small_div` and
// `spread4` are copies of packed_mask.cu's, which stays as it is.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bit_rows {

constexpr int kMaxWarps = 16;  // kernels/packed.py mask_block_warps
constexpr unsigned kAll = 0xffffffffu;

// q / d for 0 <= q < 2^14, 1 <= d <= 32, given inv = __frcp_rn(d):
// (q + 1/2) / d lies at least 1/(2d) >= 1/64 from an integer, and the
// rounding error is below 2^-9.
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
__device__ __forceinline__ uint32_t pack_row(const uint8_t* span, int start, int width) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(span) + (start >> 2);
  const int nwords = (width + 6) >> 2;
  uint64_t nibbles = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    if (i < nwords) {
      const uint32_t v = words[i];
      const uint32_t top = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
      nibbles |= static_cast<uint64_t>((top * 0x00204081u) >> 28) << (4 * i);
    }
  }
  const uint32_t x = static_cast<uint32_t>(nibbles >> (start & 3));
  return width < 32 ? x & ((1u << width) - 1u) : x;
}

// Writes `bytes` 0/1 bytes to `o` (16-byte aligned): byte q is bit q % W of
// rows[q / W], and no row word holds a bit >= W.  Each thread assembles 16
// consecutive bits from the (at most three) rows they fall in, spreads each
// 4 bits into 4 bytes with one multiply, and stores one uint4; the ragged
// tail goes byte by byte.  Every thread of the block calls it, after a
// __syncthreads that follows the last write to `rows`; bytes < 2^14.
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

}  // namespace bit_rows
