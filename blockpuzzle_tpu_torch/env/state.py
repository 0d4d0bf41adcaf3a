"""Batched environment state and timestep, as dataclasses of tensors.

Same fields and dtypes as ``blockpuzzle_tpu/env/state.py``, except that
``base_key`` holds (N,) int64 stream seeds for the port's counter-based
generator (``env/rng.py``) in place of JAX's typed PRNG keys, and that a
packed board's row words are int64 in place of uint32 (torch's CPU uint32
has no shifts), holding the same integers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass
class EnvState:
    """Per-env game state, leading axis N.

    Attributes:
      board: the engine's native layout: (N, H) int64 row words on a
        packed engine (bit w of word r is cell (r, w); each word < 2**32),
        or (N, H*W) uint8 flat cells on a u8 engine.  ``board_obs`` gives
        the (N, H, W) uint8 view of either.
      queue: (N, S) int32 piece ids; ``num_pieces`` is the empty-slot
        sentinel.
      base_key: (N,) int64 per-env stream seeds; never change.
      rng_counter: (N,) int32 monotone per-env draw counter.  NEVER reset
        (auto-reset would otherwise replay the same piece stream every
        episode).
      steps: (N,) int32 steps in the current episode (reset on episode end).
      score: (N,) float32 return accumulated in the current episode.
      streak: (N,) int32 consecutive-clear counter (``cfg.streak_bonus``
        mechanic; stays all-zero when the knob is 0.0).
    """

    board: torch.Tensor
    queue: torch.Tensor
    base_key: torch.Tensor
    rng_counter: torch.Tensor
    steps: torch.Tensor
    score: torch.Tensor
    streak: torch.Tensor

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "EnvState":
        return EnvState(
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )


@dataclasses.dataclass
class TimeStep:
    """Output of one batched step: obs + reward/done + info, all (N, ...).

      board: (N, H, W) uint8
      queue: (N, S) int32
      action_mask: (N, S*H*W) bool
      piece_planes: (N, S, H, W) uint8 rendering of the hand, present only
        when ``EnvConfig.obs_planes`` is set (None otherwise).
    """

    board: torch.Tensor
    queue: torch.Tensor
    action_mask: torch.Tensor
    reward: torch.Tensor       # (N,) float32
    terminated: torch.Tensor   # (N,) bool — game over (no legal placement)
    truncated: torch.Tensor    # (N,) bool — max_steps horizon hit
    info: Dict[str, Any]       # lines_cleared, legal, episode_return, ...
    piece_planes: Any = None

    @property
    def done(self) -> torch.Tensor:
        return torch.logical_or(self.terminated, self.truncated)

    @property
    def obs(self) -> Dict[str, torch.Tensor]:
        out = {
            "board": self.board,
            "queue": self.queue,
            "action_mask": self.action_mask,
        }
        if self.piece_planes is not None:
            out["piece_planes"] = self.piece_planes
        return out
