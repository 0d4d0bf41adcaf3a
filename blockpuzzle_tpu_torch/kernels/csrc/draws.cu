// The main path's random draws on the card: the step's deal (B9) and the
// two uniform-legal policy draws (B2, B2w), on the one hash of hash32.cuh.
// No Pallas source: the JAX package leaves these draws to XLA, which fuses
// them into the step's program.  The plain versions are in kernels/draws.py.
//
// * `deal_kernel` (B9) replaces `_deal_batch2` (blockpuzzle_tpu/env/core.py:317)
//   as the port draws it (`rng.deal`): out[e, j] = (bits * P) >> 32, the
//   high word of the 32x32 product (`__umulhi`), for lane j of stream `tag`
//   of env e, at the env's own counter (an (N,) int32 array) or at one
//   counter for all (`init`'s 0).  It serves the step's 2S-wide TAG_STEP
//   draw and every TAG_RESET deal.
// * `uniform_legal_kernel` (B2) replaces the argmax of the root bench.py:161-164
//   (`UniformLegalSampler`): per env the argmax over the A actions of
//   `legal ? bits | 1 : 0`, ties to the lowest index, so a row with no legal
//   action gives 0, as torch's and jnp's argmax do.
// * `words_select_kernel` (B2w) replaces `sample_uniform_legal`
//   (blockpuzzle_tpu/env/words.py:43): one TAG_POLICY draw at lane 0 made a
//   float32 uniform u = float(bits >> 9) * 2^-23, the rank
//   r = min(trunc(u * float(total)), max(total - 1, 0)) of the legal bits of
//   the S*H row words, the word holding the r-th legal bit, and the 5-step
//   rank-select inside it (env/words.py); action 0 where total is 0.
//
// Bound on the H100: device memory for all three; the integer work (about
// 27 operations for the per-env fold of key and counter, 11 a lane) stays
// below it.  At N = 49152 on the default preset (S = 1, H = W = 10): B9
// reads an int64 key and an int32 counter and writes 2S int32 deals, 20 B
// an env, 0.98 MB, 0.29 us at 3.35 TB/s; B2 reads the key and A = 100 mask
// bytes and writes an int64 action, 116 B an env, 5.7 MB, 1.70 us; B2w
// reads the key and S*H = 10 int64 words and writes an int64 action, 96 B
// an env, 4.7 MB, 1.41 us.
//
// Design.  B9: one thread per output element, so that a warp's stores are
// one contiguous span whatever the width; each thread folds its env's key
// and counter again (three mix32s), which costs less than a shuffle scheme
// at widths of 1 to 6.  B2: one warp per env; lane l hashes actions
// l, l + 32, ... (a warp's mask loads are 32 consecutive bytes: rows of
// A = 100 bytes are not 16-byte aligned, so no vector loads), keeps its
// strict maximum, which is its lowest index among equals, and five
// `__shfl_xor_sync` steps reduce (value, index) pairs, larger value first,
// then lower index, a total order, so every lane ends on the row's first
// maximum.  B2w: one thread per env walks its S*H words twice (the
// popcount total, then the word search), the second time from L1; the
// float product is `__fmul_rn`, so it is neither contracted nor rounded
// otherwise, and the cast truncates toward zero as JAX's int32 cast does.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "hash32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    deal_kernel(const unsigned long long* __restrict__ key,
                const int32_t* __restrict__ counter, uint32_t counter0, uint32_t tag,
                int width, uint32_t num_pieces, int32_t* __restrict__ out, int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int env = i / width;
  const int lane = i - env * width;
  const uint32_t c = counter != nullptr ? static_cast<uint32_t>(counter[env]) : counter0;
  const uint32_t bits = lane_bits(stream_hash(key[env], c), tag, lane);
  out[i] = static_cast<int32_t>(__umulhi(bits, num_pieces));
}

__global__ void __launch_bounds__(kThreads)
    uniform_legal_kernel(const unsigned long long* __restrict__ key, uint32_t counter,
                         uint32_t tag, const uint8_t* __restrict__ mask,
                         long long* __restrict__ out, int n, int actions) {
  const int env = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;  // warp-uniform
  const int l = threadIdx.x % 32;
  if (env >= n) return;
  const uint32_t h = stream_hash(key[env], counter);
  const uint8_t* row = mask + static_cast<long long>(env) * actions;
  // the lane's first maximum: an illegal action counts 0, so a lane whose
  // actions are all illegal keeps (0, its first index)
  uint32_t best = 0;
  int idx = l;
  for (int a = l; a < actions; a += 32) {
    const uint32_t v = row[a] ? lane_bits(h, tag, a) | 1u : 0u;
    if (v > best) {
      best = v;
      idx = a;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const uint32_t ov = __shfl_xor_sync(kAll, best, off);
    const int oi = __shfl_xor_sync(kAll, idx, off);
    if (ov > best || (ov == best && oi < idx)) {
      best = ov;
      idx = oi;
    }
  }
  if (l == 0) out[env] = idx;
}

__global__ void __launch_bounds__(kThreads)
    words_select_kernel(const unsigned long long* __restrict__ key, uint32_t counter,
                        uint32_t tag, const long long* __restrict__ words,
                        long long* __restrict__ out, int n, int nwords, int width) {
  const int env = blockIdx.x * kThreads + threadIdx.x;
  if (env >= n) return;
  const uint32_t bits = lane_bits(stream_hash(key[env], counter), tag, 0);
  const float u = __fmul_rn(static_cast<float>(bits >> 9), 1.0f / 8388608.0f);
  const long long* w = words + static_cast<long long>(env) * nwords;
  int total = 0;
  for (int k = 0; k < nwords; ++k) total += __popc(static_cast<uint32_t>(w[k]));
  if (total == 0) {
    out[env] = 0;
    return;
  }
  const int r = min(static_cast<int>(__fmul_rn(u, static_cast<float>(total))), total - 1);
  // the word holding the r-th legal bit: the first whose running count
  // passes r (one exists, as r < total)
  int k = 0;
  int prev = 0;
  uint32_t word = static_cast<uint32_t>(w[0]);
  for (int c = __popc(word); prev + c <= r; c = __popc(word)) {
    prev += c;
    word = static_cast<uint32_t>(w[++k]);
  }
  // the (r - prev)-th set bit of the word: 5-step binary search on prefix
  // popcounts, as rank_select_bit
  int rem = r - prev;
  int pos = 0;
  for (int span = 16; span > 0; span >>= 1) {
    const int c = __popc(word & (((1u << span) - 1u) << pos));
    if (rem >= c) {
      rem -= c;
      pos += span;
    }
  }
  out[env] = static_cast<long long>(k) * width + pos;
}

}  // namespace

// key (N,) i64; counter (N,) i32 or null, then counter0 is every env's
// counter; tag < 2^16; 1 <= width <= 2^16; out (N, width) i32, contiguous;
// N * width < 2^31 - 2^8.
extern "C" int bp_deal(const void* key, const void* counter, uint32_t counter0, int tag,
                       int width, int num_pieces, void* out, int n, void* stream) {
  const long long total = static_cast<long long>(n) * width;
  if (tag < 0 || tag >= (1 << 16) || width < 1 || width > (1 << 16) || num_pieces < 1 ||
      total > INT_MAX - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total > 0) {
    const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
    deal_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(key), static_cast<const int32_t*>(counter),
        counter0, static_cast<uint32_t>(tag), width, static_cast<uint32_t>(num_pieces),
        static_cast<int32_t*>(out), static_cast<int>(total));
  }
  return static_cast<int>(cudaGetLastError());
}

// key (N,) i64; mask (N, A) bool, contiguous; out (N,) i64; tag < 2^16;
// 1 <= A <= 2^16.
extern "C" int bp_uniform_legal(const void* key, uint32_t counter, int tag,
                                const void* mask, void* out, int n, int actions,
                                void* stream) {
  if (tag < 0 || tag >= (1 << 16) || actions < 1 || actions > (1 << 16) || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int per_block = kThreads / 32;
    const int blocks = (n + per_block - 1) / per_block;
    uniform_legal_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(key), counter, static_cast<uint32_t>(tag),
        static_cast<const uint8_t*>(mask), static_cast<long long*>(out), n, actions);
  }
  return static_cast<int>(cudaGetLastError());
}

// key (N,) i64; words (N, nwords) i64 holding u32 row words, contiguous;
// out (N,) i64; width the board's W (the action is word * W + bit);
// tag < 2^16; N < 2^31 - 2^8.
extern "C" int bp_words_select(const void* key, uint32_t counter, int tag,
                               const void* words, void* out, int n, int nwords,
                               int width, void* stream) {
  if (tag < 0 || tag >= (1 << 16) || nwords < 1 || width < 1 || width > 32 || n < 0 ||
      n > INT_MAX - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    words_select_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(key), counter, static_cast<uint32_t>(tag),
        static_cast<const long long*>(words), static_cast<long long*>(out), n, nwords,
        width);
  }
  return static_cast<int>(cudaGetLastError());
}
