// The counter-based 32-bit hash of the port's random streams on the card:
// the one source of `env/rng.py`'s arithmetic for the draw kernels
// (draws.cu), so that the deal and both policy draws cannot drift apart.
//
// A draw is a pure function of (key, counter, tag, lane):
//
//     h    = mix32(lo(key) ^ 0x243F6A88)
//     h    = mix32(h ^ hi(key))
//     h    = mix32(h ^ counter)
//     bits = mix32(h ^ ((tag << 16) | lane))
//
// `mix32` is a lowbias32-style xorshift-multiply bijection.  `env/rng.py`
// emulates its wrapping 32-bit products in int64 (`_mul32`); here they are
// plain `uint32_t` multiplies.  The key is the env's int64 stream key (its
// low and high words), the counter the state's int32 `rng_counter` read as
// `uint32_t` (the same bits as `.to(int64) & MASK32` of a wrapped value).
//
// A lane < 2^16 leaves the high half of mix32's input alone, so the first
// xorshift of `lane_bits` is the stream's own, done once a draw:
// lane_bits(h, tag, lane) == seeded_bits(lane_seed(h, tag), lane), seven
// operations a lane (one XOR and `mix32_tail`) after four a stream.
#pragma once

#include <cstdint>

// mix32 after its first xorshift
__device__ __forceinline__ uint32_t mix32_tail(uint32_t x) {
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0xD35A2D97u;
  return x ^ (x >> 15);
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  return mix32_tail(x ^ (x >> 16));
}

// The per-(env, counter) fold of the key and the counter: every lane of
// one draw starts from it.
__device__ __forceinline__ uint32_t stream_hash(uint64_t key, uint32_t counter) {
  uint32_t h = mix32(static_cast<uint32_t>(key) ^ 0x243F6A88u);
  h = mix32(h ^ static_cast<uint32_t>(key >> 32));
  return mix32(h ^ counter);
}

// Lane `lane` (< 2^16) of stream `tag` (< 2^16): one uniform u32.
__device__ __forceinline__ uint32_t lane_bits(uint32_t h, uint32_t tag, uint32_t lane) {
  return mix32(h ^ ((tag << 16) | lane));
}

// The lanes' common part of stream `tag` at fold `h`: mix32's first
// xorshift of h ^ (tag << 16).
__device__ __forceinline__ uint32_t lane_seed(uint32_t h, uint32_t tag) {
  const uint32_t x = h ^ (tag << 16);
  return x ^ (x >> 16);
}

// lane_bits(h, tag, lane) for lane < 2^16, from seed = lane_seed(h, tag).
__device__ __forceinline__ uint32_t seeded_bits(uint32_t seed, uint32_t lane) {
  return mix32_tail(seed ^ lane);
}
