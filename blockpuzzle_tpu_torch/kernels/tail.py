"""The step's tail (B10): a CUDA kernel for packed boards
(``csrc/packed_tail.cu``) and its plain version.

From the hand mask onward, ``VecBlockPuzzle.step`` decides game over
(``terminated = ~any(mask)``), the terminal penalty, truncation, the score
and, with auto-reset, the reset of every finished env; and it unpacks the
board twice into (N, H, W) uint8 views (``info["final_board"]`` and the
timestep's board).  No Pallas source: the JAX package runs all of it in
jnp (``blockpuzzle_tpu/env/core.py:1056-1118``, ``_unpack_board`` at
``:482``), which XLA fuses into its one step program.  ``tail_plain`` is that
torch code, which the u8 engine's step runs as it is; on packed boards
``PackedTailKernel`` launches one kernel for all of it, and its second entry,
``unpack``, unpacks row words for ``board_obs`` (``init``, the resets, the
learners' ``observe``, ``legal_all_pieces``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build
from blockpuzzle_tpu_torch.kernels.packed import unpack_words

# envs a block of the tail and unpack kernels, and the shared memory their
# row words, reset rows and flags may take (csrc/packed_tail.cu)
MAX_TILE = 128
TILE_SMEM = 16 * 1024
SMEM_LIMIT = 48 * 1024


def tail_block_envs(cfg: EnvConfig) -> int:
    """Envs a block (a tile) of the tail and unpack kernels: as many as fit
    ``TILE_SMEM`` of shared memory (``tail_smem_bytes``), at most
    ``MAX_TILE`` and at least one.  Computed once per wrapper."""
    per_env = tail_smem_bytes(cfg, 1)
    return max(1, min(MAX_TILE, TILE_SMEM // per_env))


def tail_smem_bytes(cfg: EnvConfig, envs: int) -> int:
    """Shared memory of a tile of ``envs`` envs: H row words, S reset-row
    indices and two flags an env."""
    return envs * (4 * cfg.height + 4 * cfg.queue_size + 2)


class Tail(NamedTuple):
    """What the tail gives the step: the timestep's flags, reward and board
    view, the info's ``episode_return`` (``score_next``), ``episode_length``
    (``steps_next``) and ``final_board`` (None without auto-reset), and the
    new state's fields.  Without auto-reset ``board_out``, ``queue_out``,
    ``mask_out``, ``steps_out``, ``score_out`` and ``streak_out`` are the
    tail's inputs ``words_next``, ``queue3``, ``mask``, ``steps_next``,
    ``score_next`` and ``streak_next``."""

    terminated: torch.Tensor
    truncated: torch.Tensor
    reward: torch.Tensor
    score_next: torch.Tensor
    steps_next: torch.Tensor
    rng_counter: torch.Tensor
    board: torch.Tensor
    final_board: Optional[torch.Tensor]
    board_out: torch.Tensor
    queue_out: torch.Tensor
    mask_out: torch.Tensor
    steps_out: torch.Tensor
    score_out: torch.Tensor
    streak_out: torch.Tensor


def tail_plain(
    board_next: torch.Tensor,
    mask: torch.Tensor,
    reward: torch.Tensor,
    queue3: torch.Tensor,
    reset_deals: Optional[torch.Tensor],
    steps: torch.Tensor,
    score: torch.Tensor,
    streak_next: torch.Tensor,
    rng_counter: torch.Tensor,
    auto_reset: bool,
    cfg: EnvConfig,
    empty_legal: torch.Tensor,
    board_obs: Callable[[torch.Tensor], torch.Tensor],
) -> Tail:
    """The step's tail in torch, in the JAX step's order, on either board
    layout: ``board_obs`` gives the (N, H, W) uint8 view of ``board_next``'s
    layout, ``empty_legal`` is the (P + 1, HW) bool empty-board legal table
    whose row P is zero (an id outside ``[0, P)`` reads it)."""
    terminated = ~mask.any(dim=1)
    reward = torch.where(terminated, reward + cfg.terminal_penalty, reward)
    steps_next = steps + 1
    if cfg.max_steps > 0:
        # independent of `terminated`: both flags are set when the game
        # ends exactly at the horizon
        truncated = steps_next >= cfg.max_steps
    else:
        truncated = torch.zeros_like(terminated)
    done = terminated | truncated
    score_next = score + reward
    final_board = None
    if auto_reset:
        num_pieces = empty_legal.shape[0] - 1
        in_set = (reset_deals >= 0) & (reset_deals < num_pieces)
        idx = torch.where(in_set, reset_deals, num_pieces).to(torch.int64)
        dcol = done[:, None]
        board_out = torch.where(dcol, torch.zeros_like(board_next), board_next)
        queue_out = torch.where(dcol, reset_deals, queue3)
        mask_out = torch.where(dcol, empty_legal[idx].reshape(mask.shape[0], -1), mask)
        steps_out = torch.where(done, 0, steps_next).to(torch.int32)
        score_out = torch.where(done, 0.0, score_next)
        streak_out = torch.where(done, 0, streak_next).to(torch.int32)
        # pre-reset ("final") observation, identical to the live obs for
        # envs that are not done
        final_board = board_obs(board_next)
    else:
        board_out, queue_out, mask_out = board_next, queue3, mask
        steps_out, score_out = steps_next, score_next
        streak_out = streak_next
    return Tail(terminated, truncated, reward, score_next, steps_next, rng_counter + 1,
                board_obs(board_out), final_board, board_out, queue_out, mask_out,
                steps_out, score_out, streak_out)


def empty_legal_table(cfg: EnvConfig) -> np.ndarray:
    """(P + 1, HW) bool: the legal anchors of each piece on an empty board,
    a zero row at the sentinel P."""
    t = rules.tables_for(cfg)
    return np.concatenate([t.valid.reshape(t.num_pieces, cfg.num_cells),
                           np.zeros((1, cfg.num_cells), bool)])


class PackedTailKernel:
    """Config-bound step tail on packed boards on one device, the card
    unless asked for another, with two entries (``csrc/packed_tail.cu``):

    ``__call__(words_next (N, H) int64, mask (N, S*HW) bool, reward (N,)
    float32, queue3 (N, S) int32, reset_deals (N, S) int32 or None,
    steps (N,) int32, score (N,) float32, streak_next (N,) int32,
    rng_counter (N,) int32, auto_reset) -> Tail`` (``reset_deals`` may be
    None without auto-reset, and a view of rows of a wider tensor, as the
    step's half of its (N, 2S) deal), and ``unpack(words (N, H) int64) ->
    (N, H, W) uint8``.  For CPU tensors each runs its plain version (``tail_plain``
    with ``unpack_words``; ``unpack_words``); for CUDA tensors it launches
    its kernel or raises.  ``launches`` counts the tail's launches,
    ``unpack_launches`` the unpack's.  ``envs`` is the kernels' tile
    (``tail_block_envs``).  Every output is a fresh tensor but for those a
    step without auto-reset hands back (``Tail``).
    """

    name = "packed_tail"

    def __init__(self, cfg: EnvConfig, device="cuda"):
        if cfg.width > 32:
            raise ValueError("packed boards need width <= 32")
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.num_pieces = rules.tables_for(cfg).num_pieces
        self.empty_legal = torch.as_tensor(empty_legal_table(cfg), device=self.device)
        self.envs = tail_block_envs(cfg)
        self.launches = self.unpack_launches = 0

    def plain(self, words_next, mask, reward, queue3, reset_deals, steps, score,
              streak_next, rng_counter, auto_reset) -> Tail:
        return tail_plain(words_next, mask, reward, queue3, reset_deals, steps, score,
                          streak_next, rng_counter, auto_reset, self.cfg,
                          self.empty_legal, self.plain_unpack)

    def plain_unpack(self, words: torch.Tensor) -> torch.Tensor:
        return unpack_words(words, self.cfg.width)

    def _check_launch(self, tensors, rows=()) -> None:
        """Raise unless the card takes these inputs: a CUDA device,
        ``tensors`` contiguous, ``rows`` with contiguous rows, a tile that
        fits a plain launch's shared memory."""
        if self.device.type != "cuda":
            raise ValueError(f"no packed tail kernel for device {self.device}")
        if not all(t.is_contiguous() for t in tensors) or any(
                t.stride(1) != 1 for t in rows):
            raise ValueError("the packed tail's inputs must be contiguous")
        if tail_smem_bytes(self.cfg, self.envs) > SMEM_LIMIT:
            raise ValueError(f"a {self.cfg.height}-row board's tile does not fit "
                             "the packed tail kernel's shared memory")

    def _check_words(self, words: torch.Tensor) -> int:
        n = words.shape[0]
        if words.device != self.device:
            raise ValueError(f"words on {words.device}, kernel tables on {self.device}")
        if words.shape != (n, self.cfg.height) or words.dtype != torch.int64:
            raise ValueError(f"words must be (N, {self.cfg.height}) int64")
        return n

    def __call__(self, words_next, mask, reward, queue3, reset_deals, steps, score,
                 streak_next, rng_counter, auto_reset) -> Tail:
        cfg = self.cfg
        n = self._check_words(words_next)
        s = cfg.queue_size
        specs = {"mask": (mask, (n, s * cfg.num_cells), torch.bool),
                 "reward": (reward, (n,), torch.float32),
                 "queue3": (queue3, (n, s), torch.int32),
                 "steps": (steps, (n,), torch.int32),
                 "score": (score, (n,), torch.float32),
                 "streak_next": (streak_next, (n,), torch.int32),
                 "rng_counter": (rng_counter, (n,), torch.int32)}
        if auto_reset:
            specs["reset_deals"] = (reset_deals, (n, s), torch.int32)
        for what, (t, shape, dtype) in specs.items():
            if not isinstance(t, torch.Tensor) or t.device != self.device:
                raise ValueError(f"{what} must be a tensor on {self.device}")
            if t.shape != shape or t.dtype != dtype:
                raise ValueError(f"{what} must be {shape} {dtype}")
        if self.device.type == "cpu":
            return self.plain(words_next, mask, reward, queue3, reset_deals, steps, score,
                              streak_next, rng_counter, auto_reset)
        ins = [words_next] + [t for k, (t, _, _) in specs.items() if k != "reset_deals"]
        self._check_launch(ins, [reset_deals] if auto_reset else [])
        if mask.data_ptr() % 16:  # read as 16-byte vectors
            raise ValueError("the mask must start on a 16-byte boundary")
        dev = self.device

        def new(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        view = (n, cfg.height, cfg.width)
        # terminated, truncated, reward, score_next, steps_next, rng_counter,
        # board: always written; the new state's fields only with auto-reset
        first = [new(n, torch.bool), new(n, torch.bool), new(n, torch.float32),
                 new(n, torch.float32), new(n, torch.int32), new(n, torch.int32),
                 new(view, torch.uint8)]
        if auto_reset:
            rest = [new(view, torch.uint8), torch.empty_like(words_next),
                    torch.empty_like(queue3), torch.empty_like(mask), new(n, torch.int32),
                    new(n, torch.float32), new(n, torch.int32)]
            reset = (reset_deals.data_ptr(), streak_next.data_ptr(), reset_deals.stride(0))
        else:
            rest = [None, words_next, queue3, mask, first[4], first[3], streak_next]
            reset = (None, None, s)
        reset_ptr, streak_ptr, reset_stride = reset
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = _build.library().bp_packed_tail(
                words_next.data_ptr(), mask.data_ptr(), reward.data_ptr(),
                queue3.data_ptr(), reset_ptr, steps.data_ptr(), score.data_ptr(),
                streak_ptr, rng_counter.data_ptr(), self.empty_legal.data_ptr(),
                *(t.data_ptr() for t in first),
                *(t.data_ptr() if auto_reset else None for t in rest),
                n, cfg.height, cfg.width, s, self.num_pieces, cfg.max_steps,
                ctypes.c_float(cfg.terminal_penalty), int(auto_reset), reset_stride,
                self.envs, stream)
        _build.check(err, "bp_packed_tail")
        self.launches += 1
        return Tail(*first, *rest)

    def unpack(self, words: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n = self._check_words(words)
        if self.device.type == "cpu":
            return self.plain_unpack(words)
        self._check_launch([words])
        out = torch.empty((n, cfg.height, cfg.width), dtype=torch.uint8, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_packed_unpack(
                words.data_ptr(), out.data_ptr(), n, cfg.height, cfg.width, self.envs,
                stream)
        _build.check(err, "bp_packed_unpack")
        self.unpack_launches += 1
        return out
