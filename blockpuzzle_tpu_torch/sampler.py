"""Uniform-legal random policies: the samplers of the JAX bench's rollout.

``UniformLegalSampler`` is the bench's default: an iid u32 draw per action
and an argmax over the legal ones (``kernels/draws.py`` ``uniform_legal``).
``WordsSampler`` is its ``BP_BENCH_SAMPLER=words`` mode: one uniform per
env and a rank-select over the packed legal words (``env/words.py``).  Each
call is one launch of its draw kernel (``UniformLegalKernel``,
``WordsSelectKernel``) on the card, its plain version on the CPU.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from blockpuzzle_tpu_torch.env import rng
from blockpuzzle_tpu_torch.env.words import legal_words
from blockpuzzle_tpu_torch.kernels.draws import (
    UniformLegalKernel,
    WordsSelectKernel,
    uniform_from_bits,
    uniform_legal,
)

__all__ = ["UniformLegalSampler", "WordsSampler", "policy_kernels",
           "uniform_from_bits", "uniform_legal"]


@functools.cache
def policy_kernels(device: torch.device) -> Tuple[UniformLegalKernel, WordsSelectKernel]:
    """The draw kernels' wrappers that every sampler on ``device`` shares,
    so that a run's policy draws are one launch count a device."""
    return UniformLegalKernel(device), WordsSelectKernel(device)


class UniformLegalSampler:
    """Policy draws from their own stream (``rng.TAG_POLICY``) of per-env
    keys, one counter value per call, so the actions depend only on the
    seed and the masks, on any device.  ``env_offset`` is the global index
    of the first env, as in ``VecBlockPuzzle.init``."""

    def __init__(self, seed: int, num_envs: int, device, env_offset: int = 0) -> None:
        self.key = rng.stream_keys(seed, num_envs, device, env_offset)
        self.counter = 0
        self.kernel = policy_kernels(self.key.device)[0]

    def __call__(self, mask: torch.Tensor) -> torch.Tensor:
        actions = self.kernel(self.key, self.counter, mask)
        self.counter += 1
        return actions


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
        self.kernel = policy_kernels(self.key.device)[1]

    def select(self, words: torch.Tensor, width: int) -> torch.Tensor:
        """(N,) actions from (N, S*H) legal row words of a board ``width``
        cells wide: the call's draw (one counter value) and the
        rank-select."""
        actions = self.kernel(self.key, self.counter, words, width)
        self.counter += 1
        return actions

    def __call__(self, env, board: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        return self.select(legal_words(env, board, queue), env.cfg.width)
