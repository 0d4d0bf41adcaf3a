// The packed step's tail (B10): termination, truncation, the score, the
// auto-reset and both (N, H, W) u8 board views, in one launch; and its second
// entry, the packed board unpack.  No Pallas source: the JAX package runs all
// of it in jnp, in `VecBlockPuzzle.step` (blockpuzzle_tpu/env/core.py:1056-1118:
// `terminated = ~any(mask)` at :1056, the auto-reset at :1078-1103 with
// `_empty_board_mask` at :573, the new state at :1108-1116), and unpacks row
// words in `_unpack_board` (:482) through `board_obs` (:649), which XLA fuses
// into its one step program.  The plain versions are `tail_plain` and
// `unpack_words` (kernels/tail.py, kernels/packed.py), the port's torch code
// for the same tail.
//
// What `bp_packed_tail` computes, per env, bit for bit as the plain version:
//   terminated = !any(mask row of S*HW bools);
//   reward'    = terminated ? reward + terminal_penalty : reward (one float
//                add, the penalty rounded to float first, as torch does);
//   steps_next = steps + 1; truncated = max_steps > 0 && steps_next >= max_steps;
//   done       = terminated || truncated; score_next = score + reward';
//   counter'   = rng_counter + 1 (32-bit wrap);
// and with `auto_reset`: a done env's board is zero, its hand the reset deal,
// its mask each reset slot's row of the empty-board legal table (an id
// outside [0, P) reads row P, which is zero), its steps, score (+0.0) and
// streak zero; `final_board` unpacks `words_next` for every env.  The board
// view is the unpacked board of the new state.  Without `auto_reset` the
// kernel writes only the flags, the scalars and one board view: the step
// hands back its inputs for the rest.
//
// Bound on the H100: device memory.  Per env on 10x10, S = 1, auto-reset on:
// in H int64 words, S*HW mask bools and seven 4-byte scalars or ids (208 B);
// out H int64 words, three HW-byte views (board, final board, mask) and ten
// flags, scalars or ids (414 B): 622 B an env, 30.57 MB at N = 49152, 9.13 us
// at 3.35 TB/s, with the 2 KB table aside.  The unpack reads H int64 words
// and writes HW bytes an env: 180 B on 10x10, 2.64 us.
//
// Design: nothing crosses an env, so the envs are cut into tiles of `envs`
// (kernels/tail.py `tail_ring`: 64 on 10x10, fewer on tall boards) and a grid
// of a few persistent blocks an SM (occupancy permitting) walks them, block b
// taking tiles b, b + gridDim.x, ...  Every input a tile needs -- its mask
// span (S*HW bytes an env), its int64 row words, its rewards, steps, scores,
// counters and, with auto-reset, its hands, streaks and reset deals -- is read
// from device memory once, into a ring of `stages` stages of shared memory:
// lane i of warp 0 issues input i's 1-D bulk copy
// (`cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes`) of the
// 16-byte chunks that cover the tile's bytes and lie inside the tensor, onto
// the stage's mbarrier; only where a tensor starts or ends off a 16-byte
// boundary do its bytes there (at most 15 a side, on tiles within 15 envs of
// either end) go by plain loads, after the wait.  A byte at address x of an
// input lands at x - from in its slot, `from` being the tile's first address
// rounded down to 16, so a stage keeps every input's 16-byte alignment (as
// bit_rows.cuh `stage_bytes`), and a slot holds `span_stride` of the tile's
// bytes.  While tile t is decided and stored, the copies of the block's next
// stages - 1 tiles are in flight.
//   Phase B (a segment of 256 / `envs` lanes an env, rounded down to a power
//   of two up to 32): the env's mask bytes, read as the staged 32-bit words,
//   masked at the span's ends, OR'ed by the lanes and by one
//   `__reduce_or_sync` over the segment: terminated; done from it and the
//   staged steps, in the env's flag byte; the lanes write the env's rows
//   (cut to W columns) and, with auto-reset, its view rows (zero where
//   done) and its new int64 words (the staged word or 0, bits above W kept),
//   and a done env's lanes write its reset slots' table rows over its
//   staged mask, then a proxy fence (the stage's next bulk copies write
//   those bytes again).  One __syncthreads.
//   Phase C (a thread an env): the flags and scalars from the flag bytes and
//   the staged ones, stored coalesced.  Phase D, with no barrier between:
//   the mask output as aligned 16-byte vectors of the staged mask (the
//   output lies at the input's offsets, so its vectors line up with the
//   stage's), the board views by `bit_rows::store_span` of the staged rows.
//   A __syncthreads frees the stage for the copies of the block's tile
//   stages - 1 ahead.
// `bp_packed_unpack` keeps the tail's former design: a block a tile of `envs` envs
// (kernels/tail.py `unpack_block_envs`), its rows staged by plain loads, then
// `store_span`.  Offsets into the outputs are 64 bits; a tile's spans keep
// `small_div` and `wide_div` in their ranges (checked at launch).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#include "bit_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEnvs = 128;       // envs a tile (kernels/tail.py MAX_TILE)
constexpr int kMaxStages = 3;       // tiles a ring holds (kernels/tail.py STAGES)
constexpr int kBlocksPerSm = 4;     // resident blocks an SM unless asked, occupancy permitting
constexpr int kSmem = 48 * 1024;    // shared memory a launch gets without opting in
constexpr int kSmallDiv = 1 << 21;  // bit_rows::small_div takes q < 2^21
constexpr int kMaxDevices = 64;

using bit_rows::kAll;
using bit_rows::small_div;

// The inputs a tile stages, in the order of their slots in a stage; the last
// three only with auto-reset.
enum Input { kMask, kWords, kReward, kSteps, kScore, kCounter, kQueue, kStreak, kReset, kInputs };

// One input as the kernel reads it: env e's bytes are [e * stride, e * stride
// + len) from `base` (the reset deals' rows lie `reset_stride` ids apart,
// every other input's back to back, stride == len); [a0, a1) are the
// tensor's whole 16-byte chunks, the only ones a bulk copy reads.  No input
// is staged where `base` is null.
struct Source {
  const uint8_t* base;
  uintptr_t a0, a1;
  int stride, len;
};

// Shared memory of a block, in bytes from its start: the ring's mbarriers,
// the tile's flag bytes (bit 0 terminated, bit 1 done), its rows and view
// rows as 32-bit words cut to W columns, then `stages` stages of `stage`
// bytes, input i's slot at `slot[i]` of a stage (-1: not staged).
// kernels/tail.py `tail_layout` mirrors it.
struct Layout {
  int flags, rows, view, ring, stage;
  int slot[kInputs];
  long long bytes;
};

struct TailArgs {
  Source in[kInputs];
  const uint8_t* table;
  uint8_t* terminated;
  uint8_t* truncated;
  float* reward_out;
  float* score_next;
  int32_t* steps_next;
  int32_t* counter_out;
  uint8_t* board_view;
  uint8_t* final_board;
  long long* words_out;
  int32_t* queue_out;
  uint8_t* mask_out;
  int32_t* steps_out;
  float* score_out;
  int32_t* streak_out;
  int n, height, width, queue_size, num_pieces, max_steps, auto_reset, reset_stride;
  int envs, stages, seg;  // envs a tile, stages a ring, lanes an env
  float terminal_penalty;
  Layout lay;
};

constexpr long long pad16(long long x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t row_bits(int width) {
  return width < 32 ? (1u << width) - 1u : kAll;
}

// -- the ring's copies and barriers ------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// The stage's one arrival, and the bytes its copies will bring.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t at = smem_addr(bar);
  uint32_t ok = 0;
  while (!ok) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(at), "r"(parity)
        : "memory");
  }
}

// Orders this thread's shared-memory accesses by plain loads and stores
// before the bulk copies issued after it.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint8_t* dst, uintptr_t src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tile_of(const TailArgs& a, int tile, int& first, int& count) {
  first = tile * a.envs;
  count = min(a.envs, a.n - first);
}

// Input `i` of `a`, for a lane that picks it at run time.
__device__ __forceinline__ Source source(const TailArgs& a, int i) {
  Source s{nullptr, 0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kInputs; ++k) {
    if (k == i) s = a.in[k];
  }
  return s;
}

// A tile's bytes of one input, as addresses: [x0, x1); `from`, x0 rounded
// down to 16, lands at the slot's start.
struct Span {
  uintptr_t x0, x1, from;
};

__device__ __forceinline__ Span tile_span(const Source& s, int first, int count) {
  Span p;
  p.x0 = reinterpret_cast<uintptr_t>(s.base) + static_cast<long long>(first) * s.stride;
  p.x1 = p.x0 + static_cast<long long>(count - 1) * s.stride + s.len;
  p.from = p.x0 & ~uintptr_t{15};
  return p;
}

// Warp 0: the bulk copies of tile `tile` into `stage`, on `bar`, lane i
// copying input i's chunks that cover the tile's bytes inside the tensor;
// lane 0 posts their bytes on the barrier with its one arrival.
__device__ __forceinline__ void issue_tile(const TailArgs& a, int tile, uint8_t* stage,
                                           uint64_t* bar) {
  const int lane = threadIdx.x % 32;
  int first, count;
  tile_of(a, tile, first, count);
  const Source s = source(a, lane);
  uintptr_t b0 = 0, b1 = 0, from = 0;
  int slot = 0;
  if (s.base != nullptr) {
    const Span p = tile_span(s, first, count);
    const uintptr_t up = (p.x1 + 15) & ~uintptr_t{15};
    b0 = p.from > s.a0 ? p.from : s.a0;
    b1 = up < s.a1 ? up : s.a1;
    from = p.from;
    for (int k = 0; k < kInputs; ++k) {
      if (k == lane) slot = a.lay.slot[k];
    }
  }
  const uint32_t bytes = b0 < b1 ? static_cast<uint32_t>(b1 - b0) : 0u;
  const uint32_t tx = __reduce_add_sync(kAll, bytes);
  if (lane == 0) {
    fence_async_proxy();
    bar_expect(bar, tx);
  }
  if (bytes) bulk_copy(stage + slot + (b0 - from), b0, bytes, bar);
}

// Every thread, on a tile within 15 envs of either end of the batch: the
// tile's bytes that no bulk copy brought (a tensor's first and last bytes
// off a 16-byte boundary, at most 15 a side), by plain loads, then a
// __syncthreads.  Elsewhere every byte lies in a whole chunk.
__device__ __forceinline__ void stage_ragged(const TailArgs& a, int first, int count,
                                             uint8_t* stage) {
  if (first >= 15 && a.n - first - count >= 15) return;
#pragma unroll
  for (int i = 0; i < kInputs; ++i) {
    const Source& s = a.in[i];
    if (s.base == nullptr) continue;
    const Span p = tile_span(s, first, count);
    const int lo = p.x0 < s.a0 ? static_cast<int>((p.x1 < s.a0 ? p.x1 : s.a0) - p.x0) : 0;
    const uintptr_t hi0 = p.x0 > s.a1 ? p.x0 : s.a1;
    const int hi = p.x1 > s.a1 ? static_cast<int>(p.x1 - hi0) : 0;
    uint8_t* slot = stage + a.lay.slot[i];
    const int t = threadIdx.x;
    if (t < lo) slot[p.x0 + t - p.from] = *reinterpret_cast<const uint8_t*>(p.x0 + t);
    if (t >= 16 && t - 16 < hi) {
      slot[hi0 + (t - 16) - p.from] = *reinterpret_cast<const uint8_t*>(hi0 + (t - 16));
    }
  }
  fence_async_proxy();
  __syncthreads();
}

// Input i's staged bytes of the tile: env e's at the result + e * stride.
__device__ __forceinline__ uint8_t* staged(const TailArgs& a, int i, uint8_t* stage,
                                           int first) {
  const uint32_t x0 = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(a.in[i].base)) +
                      static_cast<uint32_t>(first) * static_cast<uint32_t>(a.in[i].stride);
  return stage + a.lay.slot[i] + (x0 & 15u);
}

// The parts of the tail a build does: all of them in the step's kernel; the
// measurement entry `bp_packed_tail_parts` launches builds without some, to
// time each part on top of the ring's loads.  kFlags: termination (the mask
// OR) and done; kMaskOut: the new mask; kBoards: the rows, both board views
// and the new int64 words; kScalars: the flags and scalar outputs.
enum Part { kFlags = 1, kMaskOut = 2, kBoards = 4, kScalars = 8, kAllParts = 15 };

template <int kParts>
__global__ void __launch_bounds__(kThreads) packed_tail_kernel(const TailArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout& L = a.lay;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* flags = smem + L.flags;
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem + L.rows);
  uint32_t* view = reinterpret_cast<uint32_t*>(smem + L.view);
  uint8_t* ring = smem + L.ring;
  const int ntiles = (a.n + a.envs - 1) / a.envs;
  const int height = a.height, width = a.width, s_n = a.queue_size;
  const int hw = height * width;
  const int span = s_n * hw;  // an env's mask bytes
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // a segment of `seg` lanes an env: env threadIdx.x / seg of the tile
  const int seg = a.seg, e = threadIdx.x / seg, g = lane % seg;
  const unsigned seg_lanes = seg == 32 ? kAll : ((1u << seg) - 1u) << (lane - g);
  const uint32_t keep = row_bits(width);
  const float inv_hw = __frcp_rn(static_cast<float>(hw));

  if (threadIdx.x == 0) {
    for (int r = 0; r < a.stages; ++r) bar_init(&bars[r]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  if (warp == 0) {
    for (int k = 0; k + 1 < a.stages; ++k) {
      const int t = blockIdx.x + k * gridDim.x;
      if (t < ntiles) issue_tile(a, t, ring + k * L.stage, &bars[k]);
    }
  }
  __syncthreads();

  for (int i = 0, tile = blockIdx.x; tile < ntiles; ++i, tile += gridDim.x) {
    if (warp == 0) {  // the tile stages - 1 ahead, into the stage freed last
      const int ahead = tile + (a.stages - 1) * gridDim.x;
      const int r = (i + a.stages - 1) % a.stages;
      if (ahead < ntiles) issue_tile(a, ahead, ring + r * L.stage, &bars[r]);
    }
    const int r = i % a.stages;
    uint8_t* stage = ring + r * L.stage;
    bar_wait(&bars[r], static_cast<uint32_t>((i / a.stages) & 1));
    int first, count;
    tile_of(a, tile, first, count);
    stage_ragged(a, first, count, stage);
    uint8_t* m = staged(a, kMask, stage, first);
    const int m_at = static_cast<int>(m - stage - L.slot[kMask]);  // the tile's first mask byte

    // -- phase B: a segment an env ---------------------------------------------
    if (kParts != 0 && e < count) {
      const long long env = static_cast<long long>(first) + e;
      const int32_t* steps = reinterpret_cast<const int32_t*>(staged(a, kSteps, stage, first));
      const int32_t* reset =
          reinterpret_cast<const int32_t*>(staged(a, kReset, stage, first)) +
          static_cast<long long>(e) * a.reset_stride;  // env e's reset deal (with auto-reset)
      const int32_t st = static_cast<int32_t>(static_cast<uint32_t>(steps[e]) + 1u);
      const bool trunc = a.max_steps > 0 && st >= a.max_steps;
      bool term = false, done = false;
      if (kParts & kFlags) {
        // the env's staged mask as 32-bit words, masked at the span's ends
        const uint32_t* mw = reinterpret_cast<const uint32_t*>(stage + L.slot[kMask]);
        const int start = m_at + e * span, end = start + span;
        uint32_t acc = 0;
        for (int w = (start >> 2) + g; 4 * w < end; w += seg) {
          uint32_t v = mw[w];
          const int before = start - 4 * w;  // bytes of the word before the span
          const int inside = end - 4 * w;    // bytes of the word up to the span's end
          if (before > 0) v &= kAll << (8 * before);
          if (inside < 4) v &= kAll >> (8 * (4 - inside));
          acc |= v;
        }
        term = __reduce_or_sync(seg_lanes, acc) == 0;
        done = term || trunc;
        if (g == 0) flags[e] = static_cast<uint8_t>(term | (done << 1));
      }
      if ((kParts & kMaskOut) && a.auto_reset && done) {
        // the new mask: each reset slot's table row, over the staged one; the
        // stage's next bulk copies write these bytes again, so a proxy fence
        uint8_t* me = m + e * span;
#pragma unroll 4
        for (int j = g; j < span; j += seg) {
          const int s = small_div(j, inv_hw);
          const int32_t id = reset[s];
          const int p = id >= 0 && id < a.num_pieces ? id : a.num_pieces;
          me[j] = a.table[static_cast<long long>(p) * hw + (j - s * hw)];
        }
        fence_async_proxy();
      }
      if (kParts & kBoards) {
        const long long* w64 =
            reinterpret_cast<const long long*>(staged(a, kWords, stage, first)) + e * height;
        for (int j = g; j < height; j += seg) {
          const uint32_t x = static_cast<uint32_t>(w64[j]) & keep;
          rows[e * height + j] = x;
          if (a.auto_reset) {
            view[e * height + j] = done ? 0u : x;
            a.words_out[env * height + j] = done ? 0 : w64[j];
          }
        }
      }
    }
    __syncthreads();

    // -- phase C: a thread an env, the flags and scalars ------------------------
    for (int e = threadIdx.x; (kParts & kScalars) && e < count; e += kThreads) {
      const long long env = static_cast<long long>(first) + e;
      const bool term = flags[e] & 1, done = flags[e] >> 1;
      const float rw = reinterpret_cast<const float*>(staged(a, kReward, stage, first))[e];
      const float r = term ? __fadd_rn(rw, a.terminal_penalty) : rw;
      const int32_t st = static_cast<int32_t>(
          static_cast<uint32_t>(
              reinterpret_cast<const int32_t*>(staged(a, kSteps, stage, first))[e]) + 1u);
      const float sc =
          __fadd_rn(reinterpret_cast<const float*>(staged(a, kScore, stage, first))[e], r);
      const int32_t c = reinterpret_cast<const int32_t*>(staged(a, kCounter, stage, first))[e];
      a.terminated[env] = term;
      a.truncated[env] = a.max_steps > 0 && st >= a.max_steps;
      a.reward_out[env] = r;
      a.score_next[env] = sc;
      a.steps_next[env] = st;
      a.counter_out[env] = static_cast<int32_t>(static_cast<uint32_t>(c) + 1u);
      if (a.auto_reset) {
        const int32_t* queue3 =
            reinterpret_cast<const int32_t*>(staged(a, kQueue, stage, first)) + e * s_n;
        const int32_t* reset =
            reinterpret_cast<const int32_t*>(staged(a, kReset, stage, first)) +
            static_cast<long long>(e) * a.reset_stride;
        const int32_t streak =
            reinterpret_cast<const int32_t*>(staged(a, kStreak, stage, first))[e];
        a.steps_out[env] = done ? 0 : st;
        a.score_out[env] = done ? 0.0f : sc;
        a.streak_out[env] = done ? 0 : streak;
        for (int s = 0; s < s_n; ++s) a.queue_out[env * s_n + s] = done ? reset[s] : queue3[s];
      }
    }

    // -- phase D: the flat spans ---------------------------------------------
    const long long at = static_cast<long long>(first) * hw;
    if ((kParts & kMaskOut) && a.auto_reset) {
      // the mask and mask_out are 16-byte aligned: byte lo + head starts a
      // vector of both, and of the stage
      const long long lo = static_cast<long long>(first) * span;
      const int bytes = count * span;
      const int head = min(static_cast<int>((16 - (lo & 15)) & 15), bytes);
      const int nvec = (bytes - head) / 16;
      uint8_t* o = a.mask_out + lo;
      for (int v = threadIdx.x; v < nvec; v += kThreads) {
        const int q = head + 16 * v;
        *reinterpret_cast<uint4*>(o + q) = *reinterpret_cast<const uint4*>(m + q);
      }
      for (int j = threadIdx.x; j < bytes - 16 * nvec; j += kThreads) {
        const int q = j < head ? j : j + 16 * nvec;
        o[q] = m[q];
      }
    }
    if ((kParts & kBoards) && a.auto_reset) {
      bit_rows::store_span(rows, a.final_board, at, count * hw, width);
      bit_rows::store_span(view, a.board_view, at, count * hw, width);
    } else if (kParts & kBoards) {
      bit_rows::store_span(rows, a.board_view, at, count * hw, width);
    }
    __syncthreads();  // the stage, flags and rows are free for the next tile
  }
}

// The unpack's staging: the tile's row words into `rows`, each cut to its W
// columns, by plain loads.
__device__ __forceinline__ void stage_rows(const long long* __restrict__ words, uint32_t* rows,
                                           long long first, int count, int height,
                                           int width) {
  const uint32_t keep = row_bits(width);
  const long long* w = words + first * height;
  for (int i = threadIdx.x; i < count * height; i += blockDim.x) {
    rows[i] = static_cast<uint32_t>(w[i]) & keep;
  }
}

__global__ void __launch_bounds__(kThreads)
    packed_unpack_kernel(const long long* __restrict__ words, uint8_t* __restrict__ out, int n,
                         int height, int width, int envs) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem);
  const long long first = static_cast<long long>(blockIdx.x) * envs;
  const int count = static_cast<int>(min(static_cast<long long>(envs), n - first));
  const int hw = height * width;
  stage_rows(words, rows, first, count, height, width);
  __syncthreads();
  bit_rows::store_span(rows, out, first * hw, count * hw, width);
}

// kernels/tail.py `tail_layout`.  Sizes past INT_MAX give a `bytes` no card has.
Layout tail_layout(int envs, int height, int stages, const Source (&in)[kInputs]) {
  Layout l{};
  long long at = pad16(8LL * stages);
  l.flags = static_cast<int>(at);
  at += pad16(envs);
  l.rows = static_cast<int>(at);
  at += pad16(4LL * envs * height);
  l.view = static_cast<int>(at);
  at += pad16(4LL * envs * height);
  l.ring = static_cast<int>(at);
  long long stage = 0;
  for (int i = 0; i < kInputs; ++i) {
    l.slot[i] = -1;
    if (in[i].base == nullptr) continue;
    const long long span = (envs - 1LL) * in[i].stride + in[i].len;
    if (span > INT_MAX / 4) {
      l.bytes = LLONG_MAX;
      return l;
    }
    l.slot[i] = static_cast<int>(stage);
    stage += bit_rows::span_stride(span);
  }
  l.stage = static_cast<int>(std::min(stage, static_cast<long long>(INT_MAX)));
  l.bytes = stage > INT_MAX / 4 ? LLONG_MAX : at + stages * stage;
  return l;
}

// Lanes an env in phase B (kernels/tail.py `tail_segment`): as many as the
// block's threads give each of `envs` envs, a power of two up to a warp.
int tail_segment(int envs) {
  int seg = 32;
  while (seg > 1 && seg * envs > kThreads) seg /= 2;
  return seg;
}

// A tile's spans within the divisions' ranges: the mask span and the row
// words under 2^21 (`small_div`), the board bytes times W under 2^32
// (`store_span`'s `wide_div`).
bool tile_fits(int envs, int height, int width, int queue_size) {
  const long long hw = static_cast<long long>(height) * width;
  return envs >= 1 && envs <= kMaxEnvs && envs * hw * queue_size < kSmallDiv &&
         static_cast<long long>(envs) * height < kSmallDiv && envs * hw * width <= UINT_MAX;
}

// The unpack's shared memory: the tile's row words.
long long unpack_smem(int envs, int height) { return 4LL * envs * height; }

// What a card offers the tail kernel, read once a device; the occupancy of
// the last shared-memory size asked.
struct Card {
  int sms = 0, optin = 0;
  bool opted = false;
  long long occ_smem = -1;
  int occ = 0;
};
std::mutex g_cards_lock;
Card g_cards[kMaxDevices];

// The grid: `blocks_per_sm` blocks an SM, or (0) as many as are resident at
// once up to kBlocksPerSm; at most a block a tile.  0 where the card cannot
// take the launch's shared memory.
int tail_grid(long long smem, int ntiles, int blocks_per_sm, cudaError_t& err) {
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return 0;
  if (dev < 0 || dev >= kMaxDevices) {
    err = cudaErrorInvalidDevice;
    return 0;
  }
  std::lock_guard<std::mutex> lock(g_cards_lock);
  Card& c = g_cards[dev];
  if (c.sms == 0) {
    err = cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) {
      c.sms = 0;
      return 0;
    }
  }
  if (smem > c.optin) {
    err = cudaErrorInvalidValue;
    return 0;
  }
  if (smem > kSmem && !c.opted) {
    err = cudaFuncSetAttribute(packed_tail_kernel<kAllParts>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               c.optin);
    if (err != cudaSuccess) return 0;
    c.opted = true;
  }
  int per_sm = blocks_per_sm;
  if (per_sm <= 0) {
    if (c.occ_smem != smem) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.occ, packed_tail_kernel<kAllParts>,
                                                          kThreads,
                                                          static_cast<size_t>(smem));
      if (err != cudaSuccess) return 0;
      c.occ_smem = smem;
    }
    per_sm = std::min(kBlocksPerSm, c.occ);
    if (per_sm < 1) {
      err = cudaErrorInvalidValue;
      return 0;
    }
  }
  return static_cast<int>(std::min(static_cast<long long>(ntiles),
                                   static_cast<long long>(per_sm) * c.sms));
}

template <int kParts>
void launch_parts(const TailArgs& a, int blocks, cudaStream_t stream) {
  if (kParts != kAllParts && a.lay.bytes > kSmem) {
    cudaFuncSetAttribute(packed_tail_kernel<kParts>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(a.lay.bytes));
  }
  packed_tail_kernel<kParts><<<blocks, kThreads, static_cast<size_t>(a.lay.bytes), stream>>>(a);
}

int tail_launch(
    const void* words, const void* mask, const void* reward, const void* queue3,
    const void* reset, const void* steps, const void* score, const void* streak,
    const void* counter, const void* table, void* terminated, void* truncated,
    void* reward_out, void* score_next, void* steps_next, void* counter_out, void* board_view,
    void* final_board, void* words_out, void* queue_out, void* mask_out, void* steps_out,
    void* score_out, void* streak_out, int n, int height, int width, int queue_size,
    int num_pieces, int max_steps, float terminal_penalty, int auto_reset, int reset_stride,
    int envs, int stages, int blocks_per_sm, int parts, void* stream) {
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(mask) |
                            reinterpret_cast<uintptr_t>(board_view) |
                            (auto_reset ? reinterpret_cast<uintptr_t>(mask_out) |
                                              reinterpret_cast<uintptr_t>(final_board)
                                        : 0);
  if (height < 1 || width < 1 || width > 32 || queue_size < 1 || num_pieces < 1 ||
      stages < 1 || stages > kMaxStages || blocks_per_sm < 0 ||
      (parts != 0 && parts != kFlags && parts != (kFlags | kScalars) &&
       parts != (kFlags | kMaskOut) && parts != (kFlags | kBoards) && parts != kAllParts) ||
      !tile_fits(envs, height, width, queue_size) || (aligned & 15) != 0 ||
      (auto_reset && reset_stride < queue_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TailArgs a{};
  const int span = queue_size * height * width;
  // input -> (base, stride, len); the tensor's whole 16-byte chunks from them
  const auto source = [n](const void* base, int stride, int len) {
    const uintptr_t g = reinterpret_cast<uintptr_t>(base);
    const uintptr_t end = g + (n - 1LL) * stride + len;
    return Source{static_cast<const uint8_t*>(base), (g + 15) & ~uintptr_t{15},
                  end & ~uintptr_t{15}, stride, len};
  };
  const Source none{nullptr, 0, 0, 0, 0};
  a.in[kMask] = source(mask, span, span);
  a.in[kWords] = source(words, 8 * height, 8 * height);
  a.in[kReward] = source(reward, 4, 4);
  a.in[kSteps] = source(steps, 4, 4);
  a.in[kScore] = source(score, 4, 4);
  a.in[kCounter] = source(counter, 4, 4);
  a.in[kQueue] = auto_reset ? source(queue3, 4 * queue_size, 4 * queue_size) : none;
  a.in[kStreak] = auto_reset ? source(streak, 4, 4) : none;
  a.in[kReset] = auto_reset ? source(reset, 4 * reset_stride, 4 * queue_size) : none;
  const auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  a.table = u8(table);
  a.terminated = static_cast<uint8_t*>(terminated);
  a.truncated = static_cast<uint8_t*>(truncated);
  a.reward_out = static_cast<float*>(reward_out);
  a.score_next = static_cast<float*>(score_next);
  a.steps_next = static_cast<int32_t*>(steps_next);
  a.counter_out = static_cast<int32_t*>(counter_out);
  a.board_view = static_cast<uint8_t*>(board_view);
  a.final_board = static_cast<uint8_t*>(final_board);
  a.words_out = static_cast<long long*>(words_out);
  a.queue_out = static_cast<int32_t*>(queue_out);
  a.mask_out = static_cast<uint8_t*>(mask_out);
  a.steps_out = static_cast<int32_t*>(steps_out);
  a.score_out = static_cast<float*>(score_out);
  a.streak_out = static_cast<int32_t*>(streak_out);
  a.n = n;
  a.height = height;
  a.width = width;
  a.queue_size = queue_size;
  a.num_pieces = num_pieces;
  a.max_steps = max_steps;
  a.auto_reset = auto_reset;
  a.reset_stride = reset_stride;
  a.envs = envs;
  a.stages = stages;
  a.terminal_penalty = terminal_penalty;
  a.seg = tail_segment(envs);
  a.lay = tail_layout(envs, height, stages, a.in);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int ntiles = static_cast<int>((n + envs - 1LL) / envs);
  cudaError_t err = cudaSuccess;
  const int blocks = tail_grid(a.lay.bytes, ntiles, blocks_per_sm, err);
  if (blocks < 1) return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (parts) {
    case 0: launch_parts<0>(a, blocks, st); break;
    case kFlags: launch_parts<kFlags>(a, blocks, st); break;
    case kFlags | kScalars: launch_parts<kFlags | kScalars>(a, blocks, st); break;
    case kFlags | kMaskOut: launch_parts<kFlags | kMaskOut>(a, blocks, st); break;
    case kFlags | kBoards: launch_parts<kFlags | kBoards>(a, blocks, st); break;
    default: launch_parts<kAllParts>(a, blocks, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words (N, H) i64 (the packed apply's output); mask (N, S*HW) bool, 16-byte
// aligned; reward, score (N,) f32; queue3, reset (N, S) i32; steps, streak,
// counter (N,) i32; table (P + 1, HW) bool, row P zero.  Outputs: terminated,
// truncated (N,) bool; reward_out, score_next (N,) f32; steps_next,
// counter_out (N,) i32; board_view (N, H, W) u8; with auto_reset also
// final_board (N, H, W) u8, words_out (N, H) i64, queue_out (N, S) i32,
// mask_out (N, S*HW) bool (16-byte aligned), steps_out, streak_out (N,) i32
// and score_out (N,) f32, none of which is read or written without it (reset
// and streak neither).  The reset deals' rows lie `reset_stride` ids apart
// (the step's are the second half of its (N, 2S) deal).  Tiles of `envs`
// envs in a ring of `stages` (1 to 3) stages, `blocks_per_sm` persistent
// blocks an SM (0: as many as are resident at once, up to 4); W <= 32.
extern "C" int bp_packed_tail_ring(
    const void* words, const void* mask, const void* reward, const void* queue3,
    const void* reset, const void* steps, const void* score, const void* streak,
    const void* counter, const void* table, void* terminated, void* truncated,
    void* reward_out, void* score_next, void* steps_next, void* counter_out, void* board_view,
    void* final_board, void* words_out, void* queue_out, void* mask_out, void* steps_out,
    void* score_out, void* streak_out, int n, int height, int width, int queue_size,
    int num_pieces, int max_steps, float terminal_penalty, int auto_reset, int reset_stride,
    int envs, int stages, int blocks_per_sm, void* stream) {
  return tail_launch(words, mask, reward, queue3, reset, steps, score, streak, counter, table,
                     terminated, truncated, reward_out, score_next, steps_next, counter_out,
                     board_view, final_board, words_out, queue_out, mask_out, steps_out,
                     score_out, streak_out, n, height, width, queue_size, num_pieces, max_steps,
                     terminal_penalty, auto_reset, reset_stride, envs, stages, blocks_per_sm,
                     kAllParts, stream);
}

// For measurement only: `bp_packed_tail_ring` built with only some of the
// tail's parts (`parts`: 0, kFlags, kFlags | kScalars, kFlags | kMaskOut,
// kFlags | kBoards or all, 15), on the same grid; the parts left out write
// nothing.
extern "C" int bp_packed_tail_parts(
    const void* words, const void* mask, const void* reward, const void* queue3,
    const void* reset, const void* steps, const void* score, const void* streak,
    const void* counter, const void* table, void* terminated, void* truncated,
    void* reward_out, void* score_next, void* steps_next, void* counter_out, void* board_view,
    void* final_board, void* words_out, void* queue_out, void* mask_out, void* steps_out,
    void* score_out, void* streak_out, int n, int height, int width, int queue_size,
    int num_pieces, int max_steps, float terminal_penalty, int auto_reset, int reset_stride,
    int envs, int stages, int blocks_per_sm, int parts, void* stream) {
  return tail_launch(words, mask, reward, queue3, reset, steps, score, streak, counter, table,
                     terminated, truncated, reward_out, score_next, steps_next, counter_out,
                     board_view, final_board, words_out, queue_out, mask_out, steps_out,
                     score_out, streak_out, n, height, width, queue_size, num_pieces, max_steps,
                     terminal_penalty, auto_reset, reset_stride, envs, stages, blocks_per_sm,
                     parts, stream);
}

// The tail's first entry, whose arguments it keeps (an earlier build and this
// one take the same call): tiles of `envs` envs in the
// deepest ring (up to 3 stages) that the card's shared memory takes, the
// default grid.
extern "C" int bp_packed_tail(const void* words, const void* mask, const void* reward,
                              const void* queue3, const void* reset, const void* steps,
                              const void* score, const void* streak, const void* counter,
                              const void* table, void* terminated, void* truncated,
                              void* reward_out, void* score_next, void* steps_next,
                              void* counter_out, void* board_view, void* final_board,
                              void* words_out, void* queue_out, void* mask_out,
                              void* steps_out, void* score_out, void* streak_out, int n,
                              int height, int width, int queue_size, int num_pieces,
                              int max_steps, float terminal_penalty, int auto_reset,
                              int reset_stride, int envs, void* stream) {
  int err = 0;
  for (int stages = kMaxStages; stages >= 1; --stages) {
    err = tail_launch(words, mask, reward, queue3, reset, steps, score, streak, counter, table,
                      terminated, truncated, reward_out, score_next, steps_next, counter_out,
                      board_view, final_board, words_out, queue_out, mask_out, steps_out,
                      score_out, streak_out, n, height, width, queue_size, num_pieces, max_steps,
                      terminal_penalty, auto_reset, reset_stride, envs, stages, 0, kAllParts,
                      stream);
    if (err != static_cast<int>(cudaErrorInvalidValue)) return err;
  }
  return err;
}

// words (N, H) i64 -> out (N, H, W) u8 (16-byte aligned): cell (r, c) is bit
// c of word r.  `envs` envs a block; W <= 32.
extern "C" int bp_packed_unpack(const void* words, void* out, int n, int height, int width,
                                int envs, void* stream) {
  if (height < 1 || width < 1 || width > 32 || !tile_fits(envs, height, width, 1) ||
      unpack_smem(envs, height) > kSmem || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const long long blocks = (static_cast<long long>(n) + envs - 1) / envs;
    packed_unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, unpack_smem(envs, height),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(words), static_cast<uint8_t*>(out), n, height, width,
        envs);
  }
  return static_cast<int>(cudaGetLastError());
}
