"""Batched BlockPuzzle engine in PyTorch: init/reset/partial_reset/step.

The port of ``blockpuzzle_tpu/env/core.py`` ``VecBlockPuzzle``, on both
board layouts, with the hand CUDA kernels of ``kernels/``:

* ``state_impl="packed"`` (the default where rows fit a 32-bit word):
  boards are (N, H) row words, held as int64 (``kernels/packed.py``).
  ``PackedApplyKernel`` tests, places and clears the chosen action;
  ``PackedMaskKernel`` builds the hand mask; ``PackedTailKernel`` does the
  rest of the step in one launch (game over, truncation, auto-reset and
  both board views) and unpacks boards for ``board_obs``.
* ``state_impl="u8"``: boards are (N, H*W) uint8 cells.  ``MaskKernel``
  builds the hand mask; ``backend="pallas"`` tests, places and clears the
  chosen action in ``ApplyKernel``; ``backend="jnp"`` and ``"hybrid"`` do
  the collision test and the masked place in torch and the clear in
  ``ClearScanKernel`` (``clear_scan``); the rest of the step is the
  torch code of ``kernels/tail.py`` ``tail_plain``.

On both, every deal (the step's refill and auto-reset draw, ``init``,
``reset`` and ``partial_reset``) is one launch of ``DealKernel``.

``legal_all_pieces`` is ``LegalityKernel`` on u8 cells (packed boards are
unpacked first).  The layouts and backends give the same bits, and one
``step`` body serves them all: only the apply block, the mask and the tail
differ.
Everything around the kernels is plain torch on the engine's device, and
one step never waits for the device (no ``.item()``, no branch on tensor
values).

Deals come from the counter-based streams of ``env/rng.py`` (``DealKernel``
on the card, ``rng.deal`` on the CPU); comparisons with JAX inject the
deal stream through ``deal_override``, as the JAX engine's parity mode
does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.env import rng
from blockpuzzle_tpu_torch.env.state import EnvState, TimeStep
from blockpuzzle_tpu_torch.kernels import (
    ApplyKernel,
    ClearScanKernel,
    DealKernel,
    LegalityKernel,
    MaskKernel,
    PackedApplyKernel,
    PackedMaskKernel,
    PackedTailKernel,
    _build,
    tail_plain,
)
from blockpuzzle_tpu_torch.kernels.collision import place_and_clear
from blockpuzzle_tpu_torch.kernels.packed import pack_words
from blockpuzzle_tpu_torch.kernels.tail import empty_legal_table

BACKENDS = ("pallas", "jnp", "hybrid")
STATE_IMPLS = ("packed", "u8")


class VecBlockPuzzle:
    """Vectorized BlockPuzzle over a batched board tensor: (N, H) int64 row
    words (``state_impl="packed"``) or (N, H*W) uint8 cells (``"u8"``).

    The instance holds the configuration, its tables on ``device`` and the
    kernel wrappers (``deal_kernel``, ``mask_kernel``, ``apply_kernel``,
    ``clear_kernel``, ``legal_kernel``, and, where rows fit a 32-bit word,
    ``packed_apply_kernel``, ``packed_mask_kernel`` and
    ``packed_tail_kernel``); the methods are functions of the state they
    are given.

    On u8 boards ``backend`` picks how ``step`` applies the chosen action:
    ``"pallas"`` through the apply kernel, as the JAX engine's
    ``backend="pallas"`` does; ``"jnp"`` and ``"hybrid"`` through the torch
    collision test and the clear kernel, as the JAX u8 jnp step does.  The
    JAX engine's ``"hybrid"`` differs from its ``"jnp"`` only in the mask,
    which is the mask kernel on every backend here, so the two run the same
    code.  Packed boards need ``backend="jnp"`` and ``width <= 32``;
    ``state_impl=None`` picks them where both hold, as the JAX engine does.
    """

    def __init__(
        self, cfg: EnvConfig, device="cuda", backend="jnp", state_impl=None
    ) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if state_impl is None:
            state_impl = "packed" if cfg.width <= 32 and backend == "jnp" else "u8"
        if state_impl not in STATE_IMPLS:
            raise ValueError(f"unknown state_impl {state_impl!r}")
        if state_impl == "packed":
            if cfg.width > 32:
                raise ValueError("state_impl='packed' needs width <= 32")
            if backend != "jnp":
                raise ValueError("state_impl='packed' supports backend='jnp'")
        self.cfg = cfg
        self.backend = backend
        self.state_impl = state_impl
        self._packed = state_impl == "packed"
        self.device = _build.resolve_device(device)
        t = rules.tables_for(cfg)
        self.num_pieces = t.num_pieces
        self.empty_id = t.num_pieces
        self.num_actions = cfg.num_actions()
        hw = cfg.num_cells
        # attrs rows: [h, w, cells, dr1, dc1, h1, w1, dr2, dc2, h2, w2]; a
        # zero row at the empty sentinel P gives it a zero cover
        attrs = np.concatenate(
            [t.piece_h[:, None], t.piece_w[:, None], t.piece_cells[:, None],
             t.piece_rects], axis=1,
        )
        attrs = np.concatenate([attrs, np.zeros((1, 11), attrs.dtype)])
        self._attrs = torch.as_tensor(attrs, dtype=torch.int32, device=self.device)
        # legal anchors on an EMPTY board per piece, zero row at P
        self._empty_legal = torch.as_tensor(empty_legal_table(cfg), device=self.device)
        cells = torch.arange(hw, dtype=torch.int32, device=self.device)
        self._row_idx = (cells // cfg.width)[None, :]                  # (1, HW)
        self._col_idx = (cells % cfg.width)[None, :]                   # (1, HW)
        self._slot_iota = torch.arange(
            cfg.queue_size, dtype=torch.int32, device=self.device
        )[None, :]                                                     # (1, S)
        # piece planes: (P + 1, HW) with an all-zero row at the sentinel P
        planes = np.concatenate(
            [rules.piece_plane_table(cfg), np.zeros((1, hw), np.uint8)]
        )
        self._plane_table = torch.as_tensor(planes, device=self.device)
        self.deal_kernel = DealKernel(self.num_pieces, self.device)
        self.mask_kernel = MaskKernel(cfg, self.device)
        self.apply_kernel = ApplyKernel(cfg, self.device)
        self.clear_kernel = ClearScanKernel(cfg, self.device)
        self.legal_kernel = LegalityKernel(cfg, self.device)
        self.packed_apply_kernel = self.packed_mask_kernel = None
        self.packed_tail_kernel = None
        if cfg.width <= 32:
            self.packed_apply_kernel = PackedApplyKernel(cfg, self.device)
            self.packed_mask_kernel = PackedMaskKernel(cfg, self.device)
            self.packed_tail_kernel = PackedTailKernel(cfg, self.device)

    # ------------------------------------------------------------------
    # tables and masks
    # ------------------------------------------------------------------

    def _piece_index(self, pid: torch.Tensor) -> torch.Tensor:
        """int64 row index into the sentinel-padded tables: ids outside
        ``[0, P)`` select the zero row, as JAX's all-zero one-hot does."""
        in_set = (pid >= 0) & (pid < self.num_pieces)
        return torch.where(in_set, pid, self.num_pieces).to(torch.int64)

    def action_mask(self, board: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        """(N, S*HW) bool legal-action mask for the current hand, from the
        engine's native board layout."""
        if self._packed:
            return self.packed_mask_kernel(board, queue)
        return self.mask_kernel(board, queue)

    def legal_all_pieces(self, board: torch.Tensor) -> torch.Tensor:
        """(N, P, HW) bool: legality of every piece at every anchor (the
        legality kernel on u8 cells; packed boards are unpacked first).  An
        inspection surface, not on the step."""
        if self._packed:
            board = self.board_obs(board).reshape(board.shape[0], -1)
        return self.legal_kernel(board)

    def clear_scan(self, board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Simultaneous full-line (and region) clear of (N, HW) u8 boards:
        (cleared (N, HW) u8, k (N,) i32 lines and regions cleared).  Every
        full line is found before any is cleared (the clear kernel)."""
        return self.clear_kernel(board)

    def _empty_board_mask(self, queue: torch.Tensor) -> torch.Tensor:
        """Action mask for a fresh (empty) board: a table lookup."""
        n = queue.shape[0]
        return self._empty_legal[self._piece_index(queue)].reshape(n, -1)

    def piece_planes(self, queue: torch.Tensor) -> torch.Tensor:
        """(N, S, H, W) uint8: each slot's piece at the board's top-left
        corner, all-zero for an empty slot (``EnvConfig.obs_planes``)."""
        n = queue.shape[0]
        return self._plane_table[self._piece_index(queue)].view(
            n, self.cfg.queue_size, self.cfg.height, self.cfg.width)

    def _maybe_planes(self, queue: torch.Tensor):
        return self.piece_planes(queue) if self.cfg.obs_planes else None

    def _pack_board(self, board: torch.Tensor) -> torch.Tensor:
        """(N, HW) uint8 cells -> (N, H) int64 row words."""
        return pack_words(board.view(-1, self.cfg.height, self.cfg.width))

    def board_obs(self, board: torch.Tensor) -> torch.Tensor:
        """(N, H, W) uint8 board view (for policies) of either layout: packed
        row words through the tail kernel's ``unpack``."""
        if self._packed:
            return self.packed_tail_kernel.unpack(board)
        return board.view(board.shape[0], self.cfg.height, self.cfg.width)

    def encode_board(self, cells) -> torch.Tensor:
        """(N, H*W) or (N, H, W) cells -> the engine's native board on its
        device; any nonzero cell reads as occupied, in both layouts."""
        cells = torch.as_tensor(cells, device=self.device)
        cells = (cells != 0).to(torch.uint8).reshape(-1, self.cfg.num_cells)
        return self._pack_board(cells) if self._packed else cells

    def _as_queue(self, deals) -> torch.Tensor:
        return torch.as_tensor(deals, device=self.device).to(torch.int32)

    def _fresh_timestep(
        self, board: torch.Tensor, queue: torch.Tensor, mask: torch.Tensor,
        episode_return: torch.Tensor, episode_length: torch.Tensor,
    ) -> TimeStep:
        n = board.shape[0]
        zeros_b = torch.zeros(n, dtype=torch.bool, device=self.device)
        return TimeStep(
            board=self.board_obs(board),
            queue=queue,
            action_mask=mask,
            reward=torch.zeros(n, dtype=torch.float32, device=self.device),
            terminated=zeros_b,
            truncated=zeros_b,
            info={
                "lines_cleared": torch.zeros(n, dtype=torch.int32, device=self.device),
                "legal": zeros_b,
                "episode_return": episode_return,
                "episode_length": episode_length,
            },
            piece_planes=self._maybe_planes(queue),
        )

    # ------------------------------------------------------------------
    # init / reset
    # ------------------------------------------------------------------

    def _empty_boards(self, n: int) -> torch.Tensor:
        if self._packed:
            return torch.zeros((n, self.cfg.height), dtype=torch.int64,
                               device=self.device)
        return torch.zeros((n, self.cfg.num_cells), dtype=torch.uint8,
                           device=self.device)

    def init(
        self, seed: int, num_envs: int, deal_override=None, env_offset: int = 0
    ) -> Tuple[EnvState, TimeStep]:
        """Fresh batched state + initial timestep.

        Args:
          seed: root of the per-env streams (``rng.stream_keys``).
          num_envs: N.
          deal_override: optional (N, S) int32 initial hand (parity mode).
          env_offset: global index of the first env: a data-parallel rank
            holding envs ``[env_offset, env_offset + N)`` gets those rows
            of the unsharded state.
        """
        dev = self.device
        base_key = rng.stream_keys(seed, num_envs, dev, env_offset)
        if deal_override is None:
            queue = self.deal_kernel(base_key, 0, rng.TAG_RESET, self.cfg.queue_size)
        else:
            queue = self._as_queue(deal_override)
        zeros_i = torch.zeros(num_envs, dtype=torch.int32, device=dev)
        state = EnvState(
            board=self._empty_boards(num_envs),
            queue=queue,
            base_key=base_key,
            rng_counter=torch.ones(num_envs, dtype=torch.int32, device=dev),
            steps=zeros_i,
            score=torch.zeros(num_envs, dtype=torch.float32, device=dev),
            streak=zeros_i,
        )
        ts = self._fresh_timestep(
            state.board, queue, self._empty_board_mask(queue), state.score,
            zeros_i,
        )
        return state, ts

    def reset(self, state: EnvState) -> Tuple[EnvState, TimeStep]:
        """Manual full reset of every env (auto-reset usually suffices)."""
        queue = self.deal_kernel(
            state.base_key, state.rng_counter, rng.TAG_RESET, self.cfg.queue_size)
        new = state.replace(
            board=torch.zeros_like(state.board),
            queue=queue,
            rng_counter=state.rng_counter + 1,
            steps=torch.zeros_like(state.steps),
            score=torch.zeros_like(state.score),
            streak=torch.zeros_like(state.streak),
        )
        ts = self._fresh_timestep(
            new.board, queue, self._empty_board_mask(queue), new.score,
            new.steps,
        )
        return new, ts

    def partial_reset(
        self, state: EnvState, reset_mask: torch.Tensor
    ) -> Tuple[EnvState, TimeStep]:
        """Re-initialize ONLY the envs flagged in ``reset_mask`` ((N,) bool).

        Masked envs get a cleared board, a fresh tag-1 deal from their own
        stream and zeroed steps/score/streak; unmasked envs pass through
        untouched.  ``rng_counter`` advances for ALL envs, so unmasked envs
        skip a draw rather than ever replaying one.
        """
        m = torch.as_tensor(reset_mask, device=self.device).to(torch.bool)
        mcol = m[:, None]
        fresh = self.deal_kernel(
            state.base_key, state.rng_counter, rng.TAG_RESET, self.cfg.queue_size)
        queue = torch.where(mcol, fresh, state.queue)
        new = state.replace(
            board=torch.where(mcol, torch.zeros_like(state.board), state.board),
            queue=queue,
            rng_counter=state.rng_counter + 1,
            steps=torch.where(m, 0, state.steps),
            score=torch.where(m, 0.0, state.score),
            streak=torch.where(m, 0, state.streak),
        )
        # full mask (unmasked envs keep occupied boards); unmasked envs are
        # mid-episode, so the info reports their live stats
        ts = self._fresh_timestep(
            new.board, queue, self.action_mask(new.board, queue), new.score,
            new.steps,
        )
        return new, ts

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    def _cover_cells(
        self, attrs: torch.Tensor, r: torch.Tensor, c: torch.Tensor
    ) -> torch.Tensor:
        """(N, HW) uint8 footprint of the chosen action: the union of <= 2
        rectangles, from broadcast index compares."""

        def in_rect(j):
            dr, dc = attrs[:, 3 + 4 * j, None], attrs[:, 4 + 4 * j, None]
            rh, rw = attrs[:, 5 + 4 * j, None], attrs[:, 6 + 4 * j, None]
            r0 = r[:, None] + dr
            c0 = c[:, None] + dc
            return (
                (self._row_idx >= r0) & (self._row_idx < r0 + rh)
                & (self._col_idx >= c0) & (self._col_idx < c0 + rw)
            )

        return (in_rect(0) | in_rect(1)).to(torch.uint8)

    def step(
        self,
        state: EnvState,
        action: torch.Tensor,
        deal_override=None,
        auto_reset: bool = True,
    ) -> Tuple[EnvState, TimeStep]:
        """One lockstep transition for all N envs.

        Args:
          state: current EnvState.
          action: (N,) flat actions (slot * H*W + row * W + col).
          deal_override: optional (N, S) int32 dealt-piece STREAM for this
            step in deal order (parity mode); sentinel ``num_pieces`` where
            the oracle dealt nothing.
          auto_reset: re-initialize finished envs in the same pass.
        """
        cfg = self.cfg
        s = cfg.queue_size
        action = torch.as_tensor(action, device=self.device).to(torch.int32)

        # -- decode + footprint ------------------------------------------
        # Out-of-range actions are illegal no-ops (a batched step cannot
        # raise for one env).
        in_range = (action >= 0) & (action < self.num_actions)
        action_c = action.clamp(0, self.num_actions - 1)
        slot = action_c // cfg.num_cells
        cell = action_c % cfg.num_cells
        slot_onehot = self._slot_iota == slot[:, None]                # (N, S)
        pid = state.queue.gather(1, slot[:, None].to(torch.int64))[:, 0]
        slot_filled = pid < self.num_pieces
        r = cell // cfg.width
        c = cell % cfg.width
        attrs = self._attrs[self._piece_index(pid)]                   # (N, 11)
        ph, pw, cells_placed = attrs[:, 0], attrs[:, 1], attrs[:, 2]
        valid_a = in_range & slot_filled & (r + ph <= cfg.height) & (
            c + pw <= cfg.width
        )

        # -- collision check + masked place + clear (kernels) -------------
        if self._packed:
            board_next, k, legal = self.packed_apply_kernel(
                state.board, attrs, r, c, valid_a
            )
        else:
            cover_row = self._cover_cells(attrs, r, c)
            if self.backend == "pallas":
                board_next, k, legal = self.apply_kernel(
                    state.board, cover_row, valid_a
                )
            else:
                board_next, k, legal = place_and_clear(
                    state.board, cover_row, valid_a, self.clear_scan
                )

        # -- reward: same float32 operations in the same order as JAX -----
        kf = k.to(torch.float32)
        bonus = cfg.line_base * kf * (kf + 1.0) * 0.5
        reward = torch.where(
            legal,
            cfg.cell_reward * cells_placed.to(torch.float32) + bonus,
            cfg.illegal_penalty,
        )
        # streak: consecutive clearing placements pay
        # streak_bonus * (streak - 1); a legal non-clearing placement
        # resets it; illegal no-ops leave it unchanged
        if cfg.streak_bonus:
            cleared_now = legal & (k > 0)
            streak_next = torch.where(
                cleared_now,
                state.streak + 1,
                torch.where(legal, 0, state.streak),
            ).to(torch.int32)
            reward = torch.where(
                cleared_now,
                reward + cfg.streak_bonus * (streak_next - 1).to(torch.float32),
                reward,
            )
        else:
            streak_next = state.streak

        # -- queue consume + refill --------------------------------------
        consumed = slot_onehot & legal[:, None]
        queue2 = torch.where(consumed, self.empty_id, state.queue).to(torch.int32)
        empty = queue2 == self.empty_id                               # (N, S)
        if cfg.refill_batch:
            refill_slots = empty & empty.all(dim=1, keepdim=True)
        else:
            refill_slots = empty
        reset_deals = None
        if deal_override is None:
            both = self.deal_kernel(state.base_key, state.rng_counter, rng.TAG_STEP,
                                    2 * s)
            deals, reset_deals = both[:, :s], both[:, s:]
        else:
            deals = self._as_queue(deal_override)
        # refilled slots take the deal stream in ascending slot order.  The
        # positions come from a static S-loop of short row sums: torch's
        # cumsum over a last dim of 1 or 3 took 0.31 ms of a 2.3 ms step at
        # N = 49152 on the H100.
        if s == 1:
            deal_vals = deals
        else:
            refill_i = refill_slots.to(torch.int64)
            pos = torch.stack(
                [refill_i[:, : j + 1].sum(dim=1) for j in range(s)], dim=1
            ) - 1
            deal_vals = deals.gather(1, pos.clamp(min=0))
        queue3 = torch.where(refill_slots, deal_vals, queue2)

        # -- mask (kernel), then the tail: termination, truncation, score,
        # auto-reset and both board views (one kernel on packed boards) --
        mask = self.action_mask(board_next, queue3)
        if auto_reset and reset_deals is None:  # parity mode with auto-reset
            reset_deals = self.deal_kernel(
                state.base_key, state.rng_counter, rng.TAG_RESET, s)
        tail = self.packed_tail_kernel if self._packed else self._u8_tail
        out = tail(board_next, mask, reward, queue3, reset_deals, state.steps,
                   state.score, streak_next, state.rng_counter, auto_reset)

        info = {
            "lines_cleared": k,
            "legal": legal,
            "episode_return": out.score_next,
            "episode_length": out.steps_next,
            "streak": streak_next,
        }
        if auto_reset:
            # pre-reset ("final") observation, identical to the live obs
            # for envs that are not done
            info["final_board"] = out.final_board
            info["final_queue"] = queue3
            info["final_action_mask"] = mask
            if cfg.obs_planes:
                info["final_piece_planes"] = self.piece_planes(queue3)

        new_state = EnvState(
            board=out.board_out,
            queue=out.queue_out,
            base_key=state.base_key,
            rng_counter=out.rng_counter,
            steps=out.steps_out,
            score=out.score_out,
            streak=out.streak_out,
        )
        ts = TimeStep(
            board=out.board,
            queue=out.queue_out,
            action_mask=out.mask_out,
            reward=out.reward,
            terminated=out.terminated,
            truncated=out.truncated,
            info=info,
            piece_planes=self._maybe_planes(out.queue_out),
        )
        return new_state, ts

    def _u8_tail(self, *args):
        """The u8 step's tail: ``tail_plain`` on its cells."""
        return tail_plain(*args, self.cfg, self._empty_legal, self.board_obs)
