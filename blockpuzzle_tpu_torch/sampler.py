"""Uniform-legal random policy: the sampler of the JAX bench's rollout.

An iid u32 draw per action; ``where(mask, bits | 1, 0)`` keeps every legal
draw above the illegal zeros, and the argmax picks a legal action uniformly
(ties, at odds of ~2**-32, go to the first index, in torch as in JAX).
Plain torch; its hand kernel is ROADMAP.md B2.
"""

from __future__ import annotations

import torch

from blockpuzzle_tpu_torch.env import rng


def uniform_legal(mask: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(N,) int64 actions from an (N, A) bool mask and (N, A) u32 draws
    (held in int64).  A row with no legal action gives action 0."""
    return torch.where(mask, bits | 1, 0).argmax(dim=1)


class UniformLegalSampler:
    """Policy draws from their own stream (``rng.TAG_POLICY``) of per-env
    keys, one counter value per call, so the actions depend only on the
    seed and the masks, on any device."""

    def __init__(self, seed: int, num_envs: int, device) -> None:
        self.key = rng.stream_keys(seed, num_envs, device)
        self.counter = 0

    def __call__(self, mask: torch.Tensor) -> torch.Tensor:
        bits = rng.bits(self.key, self.counter, rng.TAG_POLICY, mask.shape[1])
        self.counter += 1
        return uniform_legal(mask, bits)
