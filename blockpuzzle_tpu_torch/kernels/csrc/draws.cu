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
// Bound on the H100, at the card's 32-bit integer rate (utils/bounds.py),
// counted on the busier of the two pipes that take integer work: the
// multiplies go to the FMA pipe, the rest to the ALU pipe, 64 results a
// clock an SM each.  A draw folds an env's key and counter (21 ALU
// operations and 6 multiplies) and the stream's tag (4 ALU, `lane_seed`),
// then hashes each lane in 5 ALU operations and 2 multiplies
// (`seeded_bits`).  At N = 49152 on the default preset (S = 1, H = W =
// 10): B9 reads an int64 key and an int32 counter and writes 2S int32
// deals, 20 B an env, 0.98 MB, 0.29 us at 3.35 TB/s, its 1.7 M ALU
// operations below that: bound by bytes, and by the launch, which costs
// more than either; B2 reads the key and A = 100 mask bytes and writes an
// int64 action, 116 B an env, 5.7 MB, 1.70 us, but hashes 100 lanes and
// keeps their running maximum, 8 ALU operations a lane, 40.6 M, 2.42 us at
// 16.7 T/s: bound by operations; B2w reads the key and S*H = 10 int64 words
// and writes an int64 action, 96 B an env, 4.7 MB, 1.41 us, bound by bytes.
//
// Design.  B9: one thread an env folds its key and counter once and hashes
// its `width` lanes as independent chains.  At widths 1 and 2 (a reset
// deal and the step's draw at S = 1) a thread stores its lanes at once, an
// int or an 8-byte int2, a warp's stores contiguous; widths 3 to
// kStagedLanes (the step's 6 at S = 3, resets at 3) go into shared memory
// and the block stores its span of outputs (contiguous, 16-byte aligned:
// blocks of kDealEnvs envs) as int4 vectors; wider draws, which no step
// makes, go straight to device memory.  Timed in turns on an H100 at N =
// 49152, staging took 2.9 us at width 6 against 3.5 us stored straight, 2.6
// us either way at 3, and lost at 1 (2.57 against 2.46 us).  Its time is
// the launch's and one thread's chain of dependent loads and mixes: the
// card does not start and end a kernel in less than about 1.7 us (an empty
// one, back to back).
//
// B2: a few threads an env, each folding the key and counter once.  Lane
// q of an env takes a contiguous span of the row's 32-bit words and hashes
// each word's four actions as independent chains; it keeps the strict
// maximum of the words' largest values, so the first word holding its
// maximum, and finds the action inside that word once at the end; the
// lanes' (value, action) pairs meet in xor shuffles, larger value first,
// then lower action.  Where every row starts on a 4-byte boundary (A % 4
// == 0 and an aligned mask: the engine's masks) each thread reads its
// words straight from device memory.  Any other mask (A = 243, or a view
// such as big[1:] that starts off a word) is staged: a block of E envs
// (64, fewer where E * A bytes pass 48 KB) copies its span of rows, E * A
// contiguous bytes, into shared memory with 16-byte loads
// (`bit_rows::stage_bytes`: any start address), folding while the loads
// fly, and the bytes of a row's first and last words that belong to its
// neighbours are masked.  Threads an env: one at A <= 128, else two where
// rows are staged by their width (A % 4 != 0), else four.  Timed in turns
// on an H100 at N = 49152, reading straight beat staging on every
// word-row preset (5.9 us against 6.8 us at A = 100).
//
// B2w: a segment of L = 2^k <= 32 threads an env, about one for every 8
// of its S*H words, 12 where they load one at a time (`select_log_lanes`:
// 2 on the default preset's 10, 4 on tenten's 30, woodoku's 27 and 33x9's
// 33, 8 on big's 48, 16 on 108, 32 from 129 on).  Lane q holds the
// contiguous span of words [q * span, (q + 1) * span) of the row, span =
// ceil(S*H / L) (even where 16-byte loads serve: an even S*H on an aligned
// base, so every span starts on a 16-byte boundary), read once into
// registers as 16-byte or 8-byte loads, a warp's loads of its envs' rows
// adjacent.  The last lane of the segment loads the key and folds the draw
// while the words are in flight.  Each lane popcounts its span, the
// segment takes an inclusive scan of the counts by `__shfl_up_sync`, the
// last lane's is the total; it forms r = min(trunc(u * float(total)),
// total - 1) (`__fmul_rn`, so neither contracted nor rounded otherwise, the
// cast truncating toward zero as JAX's int32 cast does) and broadcasts it,
// -1 where the total is 0 (then lane 0 stores action 0).  The one lane
// whose span holds rank r finds its word among its registers and runs the
// 5-step rank-select there, so no word is read twice.  A span of more than
// 32 words (rows of more than 1024 words) is walked 32 words at a time and
// the lane holding r reads its span again up to the 32 words that hold it.
// It answers what bounded the thread-an-env kernel it replaces, which
// walked its S*H words twice, the second time to search, a warp's loads
// touching 32 rows at once (4.2 us on the default preset, 33% of its bytes
// bound).  Timed in turns with it on an H100 (chip_measure.py --parts
// draws): 1.10x faster on the default preset, where the launch and the
// words' read from L2 set the time, 1.4-3.6x on the other presets and
// 1.55-2.9x on rows of 33 to 512 words.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bit_rows.cuh"
#include "hash32.cuh"

namespace {

constexpr int kSelectThreads = 128;  // B2w's block: 0-2% faster than 256 or 512
constexpr int kMaxSpan = 32;         // words a B2w lane holds in registers at most
constexpr int kDealEnvs = 128;       // B9's block: one thread an env
constexpr int kStagedLanes = 16;     // B9 widths staged in shared memory
constexpr int kArgmaxEnvs = 64;      // envs a block of B2 at most
constexpr int kStaticSmem = 48 * 1024;
using bit_rows::kAll;

// lane j of a deal: the high word of bits * P, uniform in [0, P)
__device__ __forceinline__ int32_t deal_lane(uint32_t seed, int j, uint32_t num_pieces) {
  return static_cast<int32_t>(__umulhi(seeded_bits(seed, static_cast<uint32_t>(j)), num_pieces));
}

__global__ void __launch_bounds__(kDealEnvs)
    deal_kernel(const unsigned long long* __restrict__ key,
                const int32_t* __restrict__ counter, uint32_t counter0, uint32_t tag,
                int width, uint32_t num_pieces, int32_t* __restrict__ out, int n) {
  __shared__ __align__(16) int32_t staged[kDealEnvs * kStagedLanes];
  const int env0 = blockIdx.x * kDealEnvs;
  const int e = env0 + threadIdx.x;
  // the same in every thread: one store a thread (widths 1 and 2) keeps a
  // warp's stores contiguous; widths 3 .. kStagedLanes go through shared
  // memory
  const bool staging = width > 2 && width <= kStagedLanes;
  if (e < n) {
    const uint32_t c = counter != nullptr ? static_cast<uint32_t>(counter[e]) : counter0;
    const uint32_t seed = lane_seed(stream_hash(key[e], c), tag);
    if (width == 2) {
      reinterpret_cast<int2*>(out)[e] =
          make_int2(deal_lane(seed, 0, num_pieces), deal_lane(seed, 1, num_pieces));
    } else if (staging) {
      int32_t* o = staged + threadIdx.x * width;
#pragma unroll 4
      for (int j = 0; j < width; ++j) o[j] = deal_lane(seed, j, num_pieces);
    } else {
      int32_t* o = out + static_cast<long long>(e) * width;
#pragma unroll 4
      for (int j = 0; j < width; ++j) o[j] = deal_lane(seed, j, num_pieces);
    }
  }
  if (!staging) return;
  __syncthreads();
  // the block's outputs: ints [env0 * width, (env0 + envs) * width) of out
  const int total = min(kDealEnvs, n - env0) * width;
  int32_t* o = out + static_cast<long long>(env0) * width;  // 16-byte aligned
  const int nvec = total / 4;
  for (int i = threadIdx.x; i < nvec; i += kDealEnvs) {
    reinterpret_cast<int4*>(o)[i] = reinterpret_cast<const int4*>(staged)[i];
  }
  for (int i = 4 * nvec + threadIdx.x; i < total; i += kDealEnvs) o[i] = staged[i];
}

// The values `legal ? bits | 1 : 0` of the four actions a, ..., a + 3 of
// mask word w (byte j nonzero: action a + j legal), hashed as independent
// chains.  Where a is a multiple of 4 (kWordRows) lane a + j is a ^ j.
template <bool kWordRows>
__device__ __forceinline__ void word_values(uint32_t w, int a, uint32_t seed, uint32_t v[4]) {
  const uint32_t sa = seed ^ static_cast<uint32_t>(a);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t x = kWordRows ? sa ^ static_cast<uint32_t>(j)
                                 : seed ^ static_cast<uint32_t>(a + j);
    const uint32_t bits = mix32_tail(x) | 1u;
    v[j] = (w >> (8 * j)) & 0xffu ? bits : 0u;
  }
}

// Word k of a row that starts at byte `start` and ends before byte `end`
// of the word-aligned `words`' base, its bytes outside the row cleared.
template <bool kWordRows>
__device__ __forceinline__ uint32_t row_word(const uint32_t* words, int k, int nw, int start,
                                             int end) {
  uint32_t w = words[k];
  if (!kWordRows) {
    if (k == 0) w &= 0xffffffffu << (8 * (start & 3));
    if (k == nw - 1 && (end & 3) != 0) w &= (1u << (8 * (end & 3))) - 1u;
  }
  return w;
}

// kStaged: the block's rows are copied into shared memory first, and a
// row may start and end inside a word (its neighbours' bytes masked);
// else every row starts and ends on a 4-byte boundary (A % 4 == 0 and a
// 4-byte aligned mask) and each thread reads its words of the row straight
// from device memory.  kLanes threads an env (1, 2 or 4: lane q takes
// words [q * nw / kLanes, (q + 1) * nw / kLanes) of the row), their maxima
// merged by xor shuffles, larger value first, then lower index.
template <bool kStaged, int kLanes>
__global__ void __launch_bounds__(kArgmaxEnvs * 4)
    uniform_legal_kernel(const unsigned long long* __restrict__ key, uint32_t counter,
                         uint32_t tag, const uint8_t* __restrict__ mask,
                         long long* __restrict__ out, int n, int actions) {
  constexpr bool kWordRows = !kStaged;
  extern __shared__ __align__(16) uint8_t span[];
  const int per = blockDim.x / kLanes;  // envs a block
  const int env0 = blockIdx.x * per;
  const int t = threadIdx.x / kLanes;  // env of the block
  const int q = threadIdx.x % kLanes;  // lane of the env
  const int e = env0 + t;
  const unsigned long long stream = e < n ? key[e] : 0ull;
  int start = 0;  // the row's first byte in `base`
  const uint8_t* base = mask + static_cast<long long>(e) * actions;
  if (kStaged) {
    const int envs = min(per, n - env0);
    start = bit_rows::stage_bytes(mask, static_cast<long long>(env0) * actions,
                                  static_cast<long long>(env0 + envs) * actions, span) +
            t * actions;
    base = span;
  }
  const uint32_t seed = lane_seed(stream_hash(stream, counter), tag);
  if (kStaged) __syncthreads();
  if (e >= n) return;  // with the env's other lanes
  const int end = start + actions;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(base) + (start >> 2);
  const int nw = ((end + 3) >> 2) - (start >> 2);  // words holding the row
  const int a0 = -(start & 3);                    // action of word 0's byte 0
  // this lane's words into the strict maximum of each word's largest
  // value, so the first word holding the lane's maximum
  uint32_t best = 0;
  int word = 0;
  uint32_t v[4];
#pragma unroll 2
  for (int k = q * nw / kLanes; k < (q + 1) * nw / kLanes; ++k) {
    word_values<kWordRows>(row_word<kWordRows>(words, k, nw, start, end), a0 + 4 * k, seed, v);
    const uint32_t m = max(max(v[0], v[1]), max(v[2], v[3]));
    if (m > best) {
      best = m;
      word = k;
    }
  }
  // the lane's first maximum: the first action of its word that holds it;
  // a lane with no legal action gives (0, 0)
  int idx = 0;
  if (best != 0) {
    word_values<kWordRows>(row_word<kWordRows>(words, word, nw, start, end), a0 + 4 * word,
                           seed, v);
    idx = a0 + 4 * word + (v[0] == best ? 0 : v[1] == best ? 1 : v[2] == best ? 2 : 3);
  }
  if (kLanes > 1) {
    const unsigned group = ((1u << kLanes) - 1u) << (threadIdx.x % 32 / kLanes * kLanes);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2) {
      const uint32_t ov = __shfl_xor_sync(group, best, off, kLanes);
      const int oi = __shfl_xor_sync(group, idx, off, kLanes);
      if (ov > best || (ov == best && oi < idx)) {
        best = ov;
        idx = oi;
      }
    }
  }
  if (q == 0) out[e] = idx;
}

// Words [c0, c0 + K) of `row` that lie before `end` into x, 0 past it: as
// K / 2 16-byte loads where kVec (row + c0 on a 16-byte boundary, end - c0
// even), else K 8-byte loads.
template <int K, bool kVec>
__device__ __forceinline__ void load_span(const long long* __restrict__ row, int c0, int end,
                                          uint32_t x[K]) {
  if constexpr (kVec) {
#pragma unroll
    for (int u = 0; u < K; u += 2) {
      const longlong2 v = c0 + u < end ? *reinterpret_cast<const longlong2*>(row + c0 + u)
                                       : make_longlong2(0, 0);
      x[u] = static_cast<uint32_t>(v.x);
      x[u + 1] = static_cast<uint32_t>(v.y);
    }
  } else {
#pragma unroll
    for (int u = 0; u < K; ++u) x[u] = c0 + u < end ? static_cast<uint32_t>(row[c0 + u]) : 0u;
  }
}

template <int K>
__device__ __forceinline__ int span_count(const uint32_t x[K]) {
  int c = 0;
#pragma unroll
  for (int u = 0; u < K; ++u) c += __popc(x[u]);
  return c;
}

// B2w: a segment of 2^log_lanes threads an env, lane q the words [q *
// span, (q + 1) * span) of its row, K (>= span but where span > kMaxSpan)
// of them in registers at a time; see the head of this file.
template <int K, bool kVec>
__global__ void __launch_bounds__(kSelectThreads)
    words_select_kernel(const unsigned long long* __restrict__ key, uint32_t counter,
                        uint32_t tag, const long long* __restrict__ words,
                        long long* __restrict__ out, int n, int nwords, int width,
                        int log_lanes, int span) {
  const int lanes = 1 << log_lanes;
  const int q = threadIdx.x & (lanes - 1);
  const int e = blockIdx.x * (kSelectThreads >> log_lanes) + (threadIdx.x >> log_lanes);
  const bool live = e < n;
  const bool last = q == lanes - 1;
  const unsigned long long k64 = live && last ? key[e] : 0ull;
  const long long* row = words + static_cast<long long>(e) * nwords;
  const int begin = min(q * span, nwords);
  const int end = live ? min(begin + span, nwords) : begin;
  uint32_t x[K];
  load_span<K, kVec>(row, begin, end, x);
  // the draw's uniform, folded in the last lane while the words fly
  const uint32_t bits = last ? lane_bits(stream_hash(k64, counter), tag, 0) : 0u;
  int count = span_count<K>(x);
  for (int c0 = begin + K; c0 < end; c0 += K) {  // spans of more than K words
    load_span<K, kVec>(row, c0, end, x);
    count += span_count<K>(x);
  }
  // the segment's inclusive scan of the counts: the total in its last lane
  int incl = count;
  for (int d = 1; d < lanes; d <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, d, lanes);
    if (q >= d) incl += y;
  }
  int r = -1;  // the rank of the drawn bit; -1: no legal action
  if (last && incl > 0) {
    const float u = __fmul_rn(static_cast<float>(bits >> 9), 1.0f / 8388608.0f);
    r = min(static_cast<int>(__fmul_rn(u, static_cast<float>(incl))), incl - 1);
  }
  r = __shfl_sync(kAll, r, lanes - 1, lanes);
  if (!live) return;
  if (r < 0) {
    if (q == 0) out[e] = 0;
    return;
  }
  int rem = r - (incl - count);  // the rank inside this lane's span
  if (rem < 0 || rem >= count) return;  // another lane's span holds it
  int c0 = begin;
  if (span > K) {  // read the span again up to the K words holding the rank
    for (;; c0 += K) {
      load_span<K, kVec>(row, c0, end, x);
      const int c = span_count<K>(x);
      if (rem < c) break;
      rem -= c;
    }
  }
  // the word holding it: the first whose running count passes rem
  int k = 0;
  int prev = 0;
  uint32_t word = 0;
#pragma unroll
  for (int u = 0, acc = 0; u < K; ++u) {
    const int c = __popc(x[u]);
    if (acc <= rem && rem < acc + c) {
      k = u;
      prev = acc;
      word = x[u];
    }
    acc += c;
  }
  // the (rem - prev)-th set bit of the word: 5-step binary search on prefix
  // popcounts, as rank_select_bit
  rem -= prev;
  int pos = 0;
  for (int half = 16; half > 0; half >>= 1) {
    const int c = __popc(word & (((1u << half) - 1u) << pos));
    if (rem >= c) {
      rem -= c;
      pos += half;
    }
  }
  out[e] = static_cast<long long>(c0 + k) * width + pos;
}

}  // namespace

// key (N,) i64; counter (N,) i32 or null, then counter0 is every env's
// counter; tag < 2^16; 1 <= width <= 2^16; out (N, width) i32, contiguous,
// 16-byte aligned; N * width < 2^31 - 2^8.
extern "C" int bp_deal(const void* key, const void* counter, uint32_t counter0, int tag,
                       int width, int num_pieces, void* out, int n, void* stream) {
  const long long total = static_cast<long long>(n) * width;
  if (tag < 0 || tag >= (1 << 16) || width < 1 || width > (1 << 16) || num_pieces < 1 ||
      n < 0 || total > INT_MAX - 256 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int blocks = (n + kDealEnvs - 1) / kDealEnvs;
    deal_kernel<<<blocks, kDealEnvs, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(key), static_cast<const int32_t*>(counter),
        counter0, static_cast<uint32_t>(tag), width, static_cast<uint32_t>(num_pieces),
        static_cast<int32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Envs a block of the argmax draw: 64, halved while their rows pass 48 KB
// of shared memory (one env's row of 2^16 bytes takes more, by opt-in).
static int argmax_envs(int actions) {
  int envs = kArgmaxEnvs;
  while (envs > 1 && bit_rows::smem_bytes(0, static_cast<long long>(envs) * actions) >
                         kStaticSmem) {
    envs /= 2;
  }
  return envs;
}

// Threads an env of the argmax draw, from A: timed at 1, 2 and 4 in turns
// on an H100 on the four presets at N = 49152, one was fastest at A = 100,
// four at A = 300 and 768 (word rows), two at A = 243 (rows staged).
static int argmax_lanes(int actions) {
  return actions <= 128 ? 1 : actions % 4 != 0 ? 2 : 4;
}

using ArgmaxKernel = void (*)(const unsigned long long*, uint32_t, uint32_t, const uint8_t*,
                              long long*, int, int);

// key (N,) i64; mask (N, A) bool, contiguous, at any address; out (N,) i64;
// tag < 2^16; 1 <= A <= 2^16.
extern "C" int bp_uniform_legal(const void* key, uint32_t counter, int tag,
                                const void* mask, void* out, int n, int actions,
                                void* stream) {
  if (tag < 0 || tag >= (1 << 16) || actions < 1 || actions > (1 << 16) || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const bool word_rows = actions % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
    const int lanes = argmax_lanes(actions);
    const int envs = word_rows ? kArgmaxEnvs : argmax_envs(actions);
    const int smem =
        word_rows ? 0 : bit_rows::smem_bytes(0, static_cast<long long>(envs) * actions);
    // word rows take 1 or 4 threads an env, staged rows any of 1, 2 and 4
    const ArgmaxKernel kernel =
        word_rows ? (lanes == 4 ? uniform_legal_kernel<false, 4> : uniform_legal_kernel<false, 1>)
                  : (lanes == 4   ? uniform_legal_kernel<true, 4>
                     : lanes == 2 ? uniform_legal_kernel<true, 2>
                                  : uniform_legal_kernel<true, 1>);
    if (smem > kStaticSmem) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<(n + envs - 1) / envs, envs * lanes, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(key), counter, static_cast<uint32_t>(tag),
        static_cast<const uint8_t*>(mask), static_cast<long long*>(out), n, actions);
  }
  return static_cast<int>(cudaGetLastError());
}

// Threads an env of B2w, as log2, from the row's S*H words: the least
// power of two L with L * kSpanWords >= S*H, at most a warp, kSpanWords 8
// words a lane where they load as 16-byte pairs (`vec`), else 12.  Timed
// on an H100 at every width in turns (chip_measure.py --parts draws): the
// fastest width, or within 1% of it, on the presets and on rows of 33,
// 108, 130 and 512 words; a lane of 2 words was up to 2.5x slower.
static int select_log_lanes(int nwords, bool vec) {
  const int span = vec ? 8 : 12;
  int log = 0;
  while (log < 5 && (span << log) < nwords) ++log;
  return log;
}

using SelectKernel = void (*)(const unsigned long long*, uint32_t, uint32_t, const long long*,
                              long long*, int, int, int, int, int);

template <bool kVec>
static SelectKernel select_kernel(int span) {
  return span <= 2    ? words_select_kernel<2, kVec>
         : span <= 4  ? words_select_kernel<4, kVec>
         : span <= 8  ? words_select_kernel<8, kVec>
         : span <= 16 ? words_select_kernel<16, kVec>
                      : words_select_kernel<kMaxSpan, kVec>;
}

static int launch_select(const void* key, uint32_t counter, int tag, const void* words,
                         void* out, int n, int nwords, int width, int log_lanes,
                         cudaStream_t stream) {
  if (tag < 0 || tag >= (1 << 16) || nwords < 1 || width < 1 || width > 32 || n < 0 ||
      n > INT_MAX - kSelectThreads || log_lanes < 0 || log_lanes > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    // 16-byte loads where every row and every span starts on a 16-byte
    // boundary: an even S*H on an aligned base, an even span
    const bool vec = nwords % 2 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
    const int lanes = 1 << log_lanes;
    int span = (nwords + lanes - 1) / lanes;
    span += vec ? span & 1 : 0;
    const SelectKernel kernel = vec ? select_kernel<true>(span) : select_kernel<false>(span);
    const int envs = kSelectThreads >> log_lanes;  // envs a block
    kernel<<<(n + envs - 1) / envs, kSelectThreads, 0, stream>>>(
        static_cast<const unsigned long long*>(key), counter, static_cast<uint32_t>(tag),
        static_cast<const long long*>(words), static_cast<long long*>(out), n, nwords, width,
        log_lanes, span);
  }
  return static_cast<int>(cudaGetLastError());
}

// key (N,) i64; words (N, nwords) i64 holding u32 row words, contiguous, at
// any 8-byte aligned address; out (N,) i64; width the board's W (the
// action is word * W + bit); tag < 2^16; N < 2^31 - 2^8.
extern "C" int bp_words_select(const void* key, uint32_t counter, int tag,
                               const void* words, void* out, int n, int nwords,
                               int width, void* stream) {
  const bool vec = nwords % 2 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  return launch_select(key, counter, tag, words, out, n, nwords, width,
                       select_log_lanes(nwords, vec), static_cast<cudaStream_t>(stream));
}

// B2w with its segment chosen: `lanes` threads an env, a power of two from
// 1 to 32; bp_words_select's other arguments.  The measurements and phase
// 1 hold every width bit-equal and time them in turns.
extern "C" int bp_words_select_lanes(const void* key, uint32_t counter, int tag,
                                     const void* words, void* out, int n, int nwords,
                                     int width, int lanes, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_select(key, counter, tag, words, out, n, nwords, width, __builtin_ctz(lanes),
                       static_cast<cudaStream_t>(stream));
}
