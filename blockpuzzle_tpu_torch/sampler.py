"""Uniform-legal random policies: the samplers of the JAX bench's rollout.

``UniformLegalSampler`` is the bench's default: an iid u32 draw per action;
``where(mask, bits | 1, 0)`` keeps every legal draw above the illegal
zeros, and the argmax picks a legal action uniformly (ties, at odds of
~2**-32, go to the first index, in torch as in JAX).  ``WordsSampler`` is
its ``BP_BENCH_SAMPLER=words`` mode: one uniform per env and a rank-select
over the packed legal words (``env/words.py``).  Plain torch; their hand
kernel is ROADMAP.md B2.
"""

from __future__ import annotations

import torch

from blockpuzzle_tpu_torch.env import rng
from blockpuzzle_tpu_torch.env.words import legal_words, sample_uniform_legal


def uniform_legal(mask: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(N,) int64 actions from an (N, A) bool mask and (N, A) u32 draws
    (held in int64).  A row with no legal action gives action 0."""
    return torch.where(mask, bits | 1, 0).argmax(dim=1)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) from u32 draws (held in int64): the top
    23 bits as the mantissa, ``float32(bits >> 9) * 2**-23``, bit for bit
    what ``jax.random.uniform`` makes of the same u32 bits."""
    return (bits >> 9).to(torch.float32) * 2.0 ** -23


class UniformLegalSampler:
    """Policy draws from their own stream (``rng.TAG_POLICY``) of per-env
    keys, one counter value per call, so the actions depend only on the
    seed and the masks, on any device.  ``env_offset`` is the global index
    of the first env, as in ``VecBlockPuzzle.init``."""

    def __init__(self, seed: int, num_envs: int, device, env_offset: int = 0) -> None:
        self.key = rng.stream_keys(seed, num_envs, device, env_offset)
        self.counter = 0

    def __call__(self, mask: torch.Tensor) -> torch.Tensor:
        bits = rng.bits(self.key, self.counter, rng.TAG_POLICY, mask.shape[1])
        self.counter += 1
        return uniform_legal(mask, bits)


class WordsSampler:
    """Uniform-legal actions of a packed engine from its legal words: one
    u32 per env and call from the ``rng.TAG_POLICY`` stream (one counter
    value per call, so the actions depend only on the seed and the boards,
    on any device), made a uniform as JAX makes one, then
    ``sample_uniform_legal``.  ``env_offset`` as in
    ``UniformLegalSampler``."""

    def __init__(self, seed: int, num_envs: int, device, env_offset: int = 0) -> None:
        self.key = rng.stream_keys(seed, num_envs, device, env_offset)
        self.counter = 0

    def uniform(self) -> torch.Tensor:
        """The call's (N,) float32 uniforms (one counter value)."""
        bits = rng.bits(self.key, self.counter, rng.TAG_POLICY, 1)[:, 0]
        self.counter += 1
        return uniform_from_bits(bits)

    def __call__(self, env, board: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        return sample_uniform_legal(
            legal_words(env, board, queue), self.uniform(), env.cfg.width)
