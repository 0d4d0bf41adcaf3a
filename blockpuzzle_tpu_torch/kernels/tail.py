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
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build
from blockpuzzle_tpu_torch.kernels.packed import unpack_words

# the tail kernel's tiles and ring (csrc/packed_tail.cu): envs a tile at
# most, threads a block, the largest tile a ring aims at, the mask bytes a
# lane reads at most in the tile a ring aims at, stages a ring, the shared
# memory a block aims at (so that four fit an H100's SM) and the most a
# block may opt in to there
MAX_TILE = 128
THREADS = 256
TILE = 64
LANE_BYTES = 32
STAGES = 3
RING_SMEM = 56 * 1024
SMEM_LIMIT = 232448
# the unpack kernel's tile in 16 KB (``unpack_block_envs``), under a plain
# launch's 48 KB
UNPACK_SMEM = 16 * 1024
UNPACK_LIMIT = 48 * 1024
# the inputs a tile stages, in the order of their slots in a stage; the
# last three only with auto-reset
INPUTS = ("mask", "words", "reward", "steps", "score", "counter", "queue3", "streak",
          "reset")


class Layout(NamedTuple):
    """A tail block's shared memory (csrc/packed_tail.cu ``Layout``), bytes
    from its start: the ring's mbarriers, then the tile's flag bytes, rows
    and view rows, then ``stages`` stages of ``stage`` bytes from ``ring``,
    input ``k``'s slot at ``slots[k]`` of a stage; ``bytes`` in all."""

    flags: int
    rows: int
    view: int
    ring: int
    stage: int
    slots: dict
    bytes: int


def pad16(x: int) -> int:
    return -(-x // 16) * 16


def span_stride(span: int) -> int:
    """bit_rows.cuh ``span_stride``: a slot for ``span`` staged bytes that
    start up to 15 bytes past a 16-byte boundary, padded to the next one."""
    return (span + 32 + 15) // 16 * 16


def tail_sources(cfg: EnvConfig, reset_stride: Optional[int]) -> dict:
    """input -> (stride, len): env e's bytes of it are ``[e * stride, e *
    stride + len)``; the reset deals' rows lie ``reset_stride`` ids apart.
    Without auto-reset (``reset_stride`` None) the last three are not read."""
    s, span = cfg.queue_size, cfg.queue_size * cfg.num_cells
    src = {"mask": (span, span), "words": (8 * cfg.height, 8 * cfg.height),
           "reward": (4, 4), "steps": (4, 4), "score": (4, 4), "counter": (4, 4)}
    if reset_stride is not None:
        src.update(queue3=(4 * s, 4 * s), streak=(4, 4), reset=(4 * reset_stride, 4 * s))
    return src


def tail_layout(cfg: EnvConfig, envs: int, stages: int,
                reset_stride: Optional[int] = None) -> Layout:
    """csrc/packed_tail.cu ``tail_layout``: a block's shared memory at a tile
    of ``envs`` envs and a ring of ``stages``, with auto-reset where
    ``reset_stride`` is given."""
    at = pad16(8 * stages)
    offsets = []
    for size in (envs, 4 * envs * cfg.height, 4 * envs * cfg.height):
        offsets.append(at)
        at += pad16(size)
    slots, stage = {}, 0
    for name, (stride, length) in tail_sources(cfg, reset_stride).items():
        slots[name] = stage
        stage += span_stride((envs - 1) * stride + length)
    return Layout(*offsets, at, stage, slots, at + stages * stage)


def tail_smem_bytes(cfg: EnvConfig, envs: int, stages: int,
                    reset_stride: Optional[int] = None) -> int:
    """Shared memory of a tail block (``tail_layout``)."""
    return tail_layout(cfg, envs, stages, reset_stride).bytes


def tail_tile(cfg: EnvConfig) -> int:
    """The tile the tail kernel aims at on ``cfg``'s boards: the largest
    power of two up to ``TILE`` envs that leaves an env enough lanes
    (``tail_segment``) for each to read at most ``LANE_BYTES`` of its S*HW
    mask bytes, or a warp an env where none does."""
    span = cfg.queue_size * cfg.num_cells
    envs = TILE
    while tail_segment(envs) < 32 and span > LANE_BYTES * tail_segment(envs):
        envs //= 2
    return envs


def tail_ring(cfg: EnvConfig) -> Optional[Tuple[int, int]]:
    """(envs a tile, stages a ring) of the tail kernel on ``cfg``'s boards,
    for the step's call (auto-reset, reset deals 2S ids apart): tiles of
    ``tail_tile`` envs in the deepest ring of up to ``STAGES`` that fits
    ``RING_SMEM``; where none does, the deepest ring whose tile of one env
    fits ``RING_SMEM``, else ``SMEM_LIMIT``, with as many envs as fit it;
    None where one env in one stage does not fit the limit (the kernel
    refuses the board).  Computed once per wrapper."""
    stride, tile = 2 * cfg.queue_size, tail_tile(cfg)
    for stages in range(STAGES, 0, -1):
        if tail_smem_bytes(cfg, tile, stages, stride) <= RING_SMEM:
            return tile, stages
    for budget in (RING_SMEM, SMEM_LIMIT):
        for stages in range(STAGES, 0, -1):
            fits = [e for e in range(1, tile + 1)
                    if tail_smem_bytes(cfg, e, stages, stride) <= budget]
            if fits:
                return max(fits), stages
    return None


def tail_segment(envs: int) -> int:
    """Lanes an env in the tail kernel's phase B (csrc/packed_tail.cu
    ``tail_segment``): as many as a block's 256 threads give each of
    ``envs`` envs, a power of two up to a warp."""
    seg = 32
    while seg > 1 and seg * envs > THREADS:
        seg //= 2
    return seg


def unpack_block_envs(cfg: EnvConfig) -> int:
    """Envs a block of the unpack kernel: the tile both kernels took before
    the tail's ring, kept so that the unpack runs as it did -- as many envs
    as fit ``UNPACK_SMEM`` with H row words, S reset-row indices and two
    flag bytes each, at most ``MAX_TILE`` and at least one."""
    per_env = 4 * cfg.height + 4 * cfg.queue_size + 2
    return max(1, min(MAX_TILE, UNPACK_SMEM // per_env))


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
    ``unpack_launches`` the unpack's.  The tail runs tiles of ``envs`` envs
    through a ring of ``stages`` (``tail_ring``; both 0 where no tile fits,
    and a launch raises) on ``blocks_per_sm`` persistent blocks an SM (0:
    the kernel's choice from the card's occupancy); the unpack takes tiles
    of ``unpack_envs`` (``unpack_block_envs``).  Every output is a fresh
    tensor but for those a step without auto-reset hands back (``Tail``).
    """

    name = "packed_tail"

    def __init__(self, cfg: EnvConfig, device="cuda"):
        if cfg.width > 32:
            raise ValueError("packed boards need width <= 32")
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.num_pieces = rules.tables_for(cfg).num_pieces
        self.empty_legal = torch.as_tensor(empty_legal_table(cfg), device=self.device)
        self.envs, self.stages = tail_ring(cfg) or (0, 0)
        self.blocks_per_sm = 0
        self.unpack_envs = unpack_block_envs(cfg)
        self.launches = self.unpack_launches = 0

    def plain(self, words_next, mask, reward, queue3, reset_deals, steps, score,
              streak_next, rng_counter, auto_reset) -> Tail:
        return tail_plain(words_next, mask, reward, queue3, reset_deals, steps, score,
                          streak_next, rng_counter, auto_reset, self.cfg,
                          self.empty_legal, self.plain_unpack)

    def plain_unpack(self, words: torch.Tensor) -> torch.Tensor:
        return unpack_words(words, self.cfg.width)

    def _check_launch(self, tensors, rows=(), smem=0, limit=SMEM_LIMIT) -> None:
        """Raise unless the card takes these inputs: a CUDA device,
        ``tensors`` contiguous, ``rows`` with contiguous rows, ``smem``
        bytes of shared memory a block within ``limit``."""
        if self.device.type != "cuda":
            raise ValueError(f"no packed tail kernel for device {self.device}")
        if not all(t.is_contiguous() for t in tensors) or any(
                t.stride(1) != 1 for t in rows):
            raise ValueError("the packed tail's inputs must be contiguous")
        if not 0 < smem <= limit:
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
        stride = reset_deals.stride(0) if auto_reset else None
        smem = tail_smem_bytes(cfg, self.envs, self.stages, stride) if self.envs else 0
        self._check_launch(ins, [reset_deals] if auto_reset else [], smem)
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
            err = _build.library().bp_packed_tail_ring(
                words_next.data_ptr(), mask.data_ptr(), reward.data_ptr(),
                queue3.data_ptr(), reset_ptr, steps.data_ptr(), score.data_ptr(),
                streak_ptr, rng_counter.data_ptr(), self.empty_legal.data_ptr(),
                *(t.data_ptr() for t in first),
                *(t.data_ptr() if auto_reset else None for t in rest),
                n, cfg.height, cfg.width, s, self.num_pieces, cfg.max_steps,
                ctypes.c_float(cfg.terminal_penalty), int(auto_reset), reset_stride,
                self.envs, self.stages, self.blocks_per_sm, stream)
        _build.check(err, "bp_packed_tail_ring")
        self.launches += 1
        return Tail(*first, *rest)

    def unpack(self, words: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n = self._check_words(words)
        if self.device.type == "cpu":
            return self.plain_unpack(words)
        self._check_launch([words], smem=4 * self.unpack_envs * cfg.height,
                           limit=UNPACK_LIMIT)
        out = torch.empty((n, cfg.height, cfg.width), dtype=torch.uint8, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_packed_unpack(
                words.data_ptr(), out.data_ptr(), n, cfg.height, cfg.width,
                self.unpack_envs, stream)
        _build.check(err, "bp_packed_unpack")
        self.unpack_launches += 1
        return out
