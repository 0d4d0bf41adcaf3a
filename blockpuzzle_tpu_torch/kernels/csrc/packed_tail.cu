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
// Design: nothing crosses an env, so a block owns a tile of `envs` envs (the
// wrapper's `tail_block_envs`: 128 on 10x10, fewer on tall boards so that the
// tile's row words fit 16 KB of shared memory) and 256 threads; no shape
// needs a kernel of its own.
//   Phase A: the tile's row words go to shared memory as 32-bit words (each
//   masked to its W columns); the tile's mask span, S*HW bytes an env, is read
//   as aligned 16-byte vectors (the bytes before the first boundary and after
//   the last one by one, a span of 100 bytes an env starting on no boundary),
//   and every nonzero byte sets its env's `legal` flag in shared memory: one
//   store where the vector lies in one env, byte by byte where it straddles
//   two.  Then one thread an env decides terminated and done, writes the
//   env's flags and scalars (coalesced), and stages `done` and each reset
//   slot's table row in shared memory.
//   Phase B: flat spans.  The mask output takes each aligned vector of the
//   input (the output lies at the same offsets, so its vectors line up) and,
//   where a byte belongs to a done env, that env's table byte in its place;
//   the board views are `bit_rows::store_span` of the staged rows ("byte q is
//   bit q % W of rows[q / W]", 16-byte vectors through `spread4`, any byte
//   offset), first `final_board`, then, with the done envs' rows zeroed, the
//   view of the new board.  The int64 words of the new board are the input
//   words, read again (an L2 hit), or 0.
// `bp_packed_unpack` is phase B alone: stage the tile's rows, `store_span`.
// Offsets into the outputs are 64 bits; a tile's spans keep `small_div` and
// `wide_div` in their ranges (checked at launch).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bit_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEnvs = 128;       // envs a tile (kernels/tail.py MAX_TILE)
constexpr int kSmem = 48 * 1024;    // shared memory a launch gets without opting in
constexpr int kSmallDiv = 1 << 21;  // bit_rows::small_div takes q < 2^21

using bit_rows::small_div;

__device__ __forceinline__ uint32_t row_bits(int width) {
  return width < 32 ? (1u << width) - 1u : bit_rows::kAll;
}

// byte j (0..15) of the vector x
__device__ __forceinline__ uint32_t byte_of(const uint4& x, int j) {
  const uint32_t w = j < 4 ? x.x : j < 8 ? x.y : j < 12 ? x.z : x.w;
  return (w >> (8 * (j & 3))) & 0xffu;
}

__device__ __forceinline__ void set_byte(uint4& x, int j, uint32_t b) {
  uint32_t& w = j < 4 ? x.x : j < 8 ? x.y : j < 12 ? x.z : x.w;
  const int s = 8 * (j & 3);
  w = (w & ~(0xffu << s)) | (b << s);
}

// The tile's row words into `rows`, each cut to its W columns.
__device__ __forceinline__ void stage_rows(const long long* __restrict__ words, uint32_t* rows,
                                           long long first, int count, int height,
                                           int width) {
  const uint32_t keep = row_bits(width);
  const long long* w = words + first * height;
  for (int i = threadIdx.x; i < count * height; i += blockDim.x) {
    rows[i] = static_cast<uint32_t>(w[i]) & keep;
  }
}

// The table byte that a done env's mask holds at byte `at` of its S*HW.
__device__ __forceinline__ uint8_t table_byte(const uint8_t* __restrict__ table,
                                              const int32_t* pidx, int e, int at, int hw,
                                              int queue_size, float inv_hw) {
  const int s = small_div(at, inv_hw);
  return table[static_cast<long long>(pidx[e * queue_size + s]) * hw + (at - s * hw)];
}

__global__ void __launch_bounds__(kThreads)
    packed_tail_kernel(const long long* __restrict__ words, const uint8_t* __restrict__ mask,
                       const float* __restrict__ reward, const int32_t* __restrict__ queue3,
                       const int32_t* __restrict__ reset, const int32_t* __restrict__ steps,
                       const float* __restrict__ score, const int32_t* __restrict__ streak,
                       const int32_t* __restrict__ counter, const uint8_t* __restrict__ table,
                       uint8_t* __restrict__ terminated_out, uint8_t* __restrict__ truncated_out,
                       float* __restrict__ reward_out, float* __restrict__ score_next,
                       int32_t* __restrict__ steps_next, int32_t* __restrict__ counter_out,
                       uint8_t* __restrict__ board_view, uint8_t* __restrict__ final_board,
                       long long* __restrict__ words_out, int32_t* __restrict__ queue_out,
                       uint8_t* __restrict__ mask_out, int32_t* __restrict__ steps_out,
                       float* __restrict__ score_out, int32_t* __restrict__ streak_out, int n,
                       int height, int width, int queue_size, int num_pieces, int max_steps,
                       float terminal_penalty, int auto_reset, long long reset_stride,
                       int envs) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem);                   // envs * H
  int32_t* pidx = reinterpret_cast<int32_t*>(rows + envs * height);     // envs * S
  uint8_t* legal = reinterpret_cast<uint8_t*>(pidx + envs * queue_size);  // envs
  uint8_t* done = legal + envs;                                         // envs
  const long long first = static_cast<long long>(blockIdx.x) * envs;
  const int count = static_cast<int>(min(static_cast<long long>(envs), n - first));
  const int hw = height * width;
  const int span = queue_size * hw;  // an env's mask bytes

  // -- phase A: rows, the legal flags, the per-env decisions ---------------
  stage_rows(words, rows, first, count, height, width);
  for (int e = threadIdx.x; e < count; e += blockDim.x) legal[e] = 0;
  __syncthreads();
  const long long lo = first * span;
  const int bytes = count * span;
  const float inv_span = __frcp_rn(static_cast<float>(span));
  const uint8_t* m = mask + lo;
  // the mask and mask_out are 16-byte aligned: byte lo + head starts a vector of both
  const int head = min(static_cast<int>((16 - (lo & 15)) & 15), bytes);
  const int nvec = (bytes - head) / 16;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int q = head + 16 * v;
    const uint4 x = *reinterpret_cast<const uint4*>(m + q);
    if ((x.x | x.y | x.z | x.w) == 0) continue;
    const int e0 = small_div(q, inv_span);
    if (e0 == small_div(q + 15, inv_span)) {
      legal[e0] = 1;
      continue;
    }
    for (int j = 0; j < 16; ++j) {
      if (byte_of(x, j)) legal[small_div(q + j, inv_span)] = 1;
    }
  }
  for (int j = threadIdx.x; j < bytes - 16 * nvec; j += blockDim.x) {
    const int q = j < head ? j : j + 16 * nvec;
    if (m[q]) legal[small_div(q, inv_span)] = 1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const long long env = first + e;
    const bool term = legal[e] == 0;
    const float r = term ? __fadd_rn(reward[env], terminal_penalty) : reward[env];
    const int32_t st = static_cast<int32_t>(static_cast<uint32_t>(steps[env]) + 1u);
    const bool trunc = max_steps > 0 && st >= max_steps;
    const bool d = term || trunc;
    const float sc = __fadd_rn(score[env], r);
    terminated_out[env] = term;
    truncated_out[env] = trunc;
    reward_out[env] = r;
    score_next[env] = sc;
    steps_next[env] = st;
    counter_out[env] = static_cast<int32_t>(static_cast<uint32_t>(counter[env]) + 1u);
    done[e] = d;
    if (auto_reset) {
      steps_out[env] = d ? 0 : st;
      score_out[env] = d ? 0.0f : sc;
      streak_out[env] = d ? 0 : streak[env];
      for (int s = 0; s < queue_size; ++s) {
        const long long at = env * queue_size + s;
        const int32_t fresh = reset[env * reset_stride + s];
        queue_out[at] = d ? fresh : queue3[at];
        pidx[e * queue_size + s] = fresh >= 0 && fresh < num_pieces ? fresh : num_pieces;
      }
    }
  }
  __syncthreads();

  // -- phase B: the flat spans --------------------------------------------
  if (auto_reset) {
    const float inv_hw = __frcp_rn(static_cast<float>(hw));
    uint8_t* o = mask_out + lo;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      const int q = head + 16 * v;
      uint4 x = *reinterpret_cast<const uint4*>(m + q);
      const int e0 = small_div(q, inv_span);
      if (e0 != small_div(q + 15, inv_span) || done[e0]) {
        for (int j = 0; j < 16; ++j) {
          const int e = small_div(q + j, inv_span);
          if (done[e]) {
            set_byte(x, j, table_byte(table, pidx, e, q + j - e * span, hw, queue_size,
                                      inv_hw));
          }
        }
      }
      *reinterpret_cast<uint4*>(o + q) = x;
    }
    for (int j = threadIdx.x; j < bytes - 16 * nvec; j += blockDim.x) {
      const int q = j < head ? j : j + 16 * nvec;
      const int e = small_div(q, inv_span);
      o[q] = done[e] ? table_byte(table, pidx, e, q - e * span, hw, queue_size, inv_hw) : m[q];
    }
    bit_rows::store_span(rows, final_board, first * hw, count * hw, width);
    const float inv_h = __frcp_rn(static_cast<float>(height));
    const long long* w = words + first * height;
    for (int i = threadIdx.x; i < count * height; i += blockDim.x) {
      words_out[first * height + i] = done[small_div(i, inv_h)] ? 0 : w[i];
    }
    __syncthreads();  // the final board's store has read the rows
    for (int i = threadIdx.x; i < count * height; i += blockDim.x) {
      if (done[small_div(i, inv_h)]) rows[i] = 0;
    }
    __syncthreads();
  }
  bit_rows::store_span(rows, board_view, first * hw, count * hw, width);
}

__global__ void __launch_bounds__(kThreads)
    packed_unpack_kernel(const long long* __restrict__ words, uint8_t* __restrict__ out, int n,
                         int height, int width, int envs) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem);
  const long long first = static_cast<long long>(blockIdx.x) * envs;
  const int count = static_cast<int>(min(static_cast<long long>(envs), n - first));
  const int hw = height * width;
  stage_rows(words, rows, first, count, height, width);
  __syncthreads();
  bit_rows::store_span(rows, out, first * hw, count * hw, width);
}

// Shared memory of a tile of `envs` envs (kernels/tail.py tail_smem_bytes):
// the row words, each reset slot's table row index, the legal and done flags.
long long tail_smem(int envs, int height, int queue_size) {
  return static_cast<long long>(envs) * (4LL * height + 4LL * queue_size + 2);
}

// A tile's spans within the divisions' ranges: the mask span and the row
// words under 2^21 (`small_div`), the board bytes times W under 2^32
// (`store_span`'s `wide_div`).
bool tile_fits(int envs, int height, int width, int queue_size) {
  const long long hw = static_cast<long long>(height) * width;
  return envs >= 1 && envs <= kMaxEnvs && tail_smem(envs, height, queue_size) <= kSmem &&
         envs * hw * queue_size < kSmallDiv && static_cast<long long>(envs) * height < kSmallDiv &&
         envs * hw * width <= UINT_MAX;
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
// (the step's are the second half of its (N, 2S) deal).  `envs` envs a
// block; W <= 32.
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
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(mask) |
                            reinterpret_cast<uintptr_t>(board_view) |
                            (auto_reset ? reinterpret_cast<uintptr_t>(mask_out) |
                                              reinterpret_cast<uintptr_t>(final_board)
                                        : 0);
  if (height < 1 || width < 1 || width > 32 || queue_size < 1 || num_pieces < 1 ||
      !tile_fits(envs, height, width, queue_size) || (aligned & 15) != 0 ||
      (auto_reset && reset_stride < queue_size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const long long blocks = (static_cast<long long>(n) + envs - 1) / envs;
    packed_tail_kernel<<<static_cast<unsigned>(blocks), kThreads,
                         tail_smem(envs, height, queue_size),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(words), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(reward), static_cast<const int32_t*>(queue3),
        static_cast<const int32_t*>(reset), static_cast<const int32_t*>(steps),
        static_cast<const float*>(score), static_cast<const int32_t*>(streak),
        static_cast<const int32_t*>(counter), static_cast<const uint8_t*>(table),
        static_cast<uint8_t*>(terminated), static_cast<uint8_t*>(truncated),
        static_cast<float*>(reward_out), static_cast<float*>(score_next),
        static_cast<int32_t*>(steps_next), static_cast<int32_t*>(counter_out),
        static_cast<uint8_t*>(board_view), static_cast<uint8_t*>(final_board),
        static_cast<long long*>(words_out), static_cast<int32_t*>(queue_out),
        static_cast<uint8_t*>(mask_out), static_cast<int32_t*>(steps_out),
        static_cast<float*>(score_out), static_cast<int32_t*>(streak_out), n, height, width,
        queue_size, num_pieces, max_steps, terminal_penalty, auto_reset, reset_stride, envs);
  }
  return static_cast<int>(cudaGetLastError());
}

// words (N, H) i64 -> out (N, H, W) u8 (16-byte aligned): cell (r, c) is bit
// c of word r.  `envs` envs a block, as the tail's; W <= 32.
extern "C" int bp_packed_unpack(const void* words, void* out, int n, int height, int width,
                                int envs, void* stream) {
  if (height < 1 || width < 1 || width > 32 || !tile_fits(envs, height, width, 1) ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const long long blocks = (static_cast<long long>(n) + envs - 1) / envs;
    packed_unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 4LL * envs * height,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(words), static_cast<uint8_t*>(out), n, height, width,
        envs);
  }
  return static_cast<int>(cudaGetLastError());
}
