"""CPU oracle environment: one game on a numpy board with Python RNG.

A copy of ``blockpuzzle_tpu/oracle/env.py`` without the gymnasium base
class and spaces: the same ``reset(seed=, options=) -> (obs, info)``,
``step -> (obs, reward, terminated, truncated, info)`` and
``legal_action_mask`` semantics, on the port's ``config`` and ``rules``.

Semantics:
  * action id = slot * H * W + row * W + col; anchor = piece bbox top-left.
  * legal iff slot non-empty, in-bounds, and zero overlap with occupied cells.
  * illegal action: no-op, reward = cfg.illegal_penalty, episode continues.
  * after a legal placement, ALL simultaneously full rows + cols (+ regions,
    if cfg.region_clear) are computed first, then cleared at once.
  * reward = cfg.cell_reward * cells_placed + line_bonus(k) with
    k = number of full rows + cols (+ regions).
  * piece dealing: one ``Random.randrange(num_pieces)`` per refilled slot, in
    ascending slot order.  refill_batch=False refills the consumed slot
    immediately; refill_batch=True refills all slots only once all are empty.
  * game over (terminated) when no queued piece fits anywhere.
  * truncation after cfg.max_steps steps (0 = never).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig, default_config


class BlockPuzzleOracleEnv:
    """Single BlockPuzzle environment (CPU, NumPy board, Python RNG)."""

    def __init__(
        self,
        cfg: Optional[EnvConfig] = None,
        render_mode: Optional[str] = None,
        **overrides: Any,
    ) -> None:
        if cfg is None:
            cfg = default_config()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.cfg = cfg
        self.tables = rules.tables_for(cfg)
        # raw piece grids (the spec itself): the oracle computes legality
        # from these, independent of the engine's derived cover/valid tables
        self._grids = rules.piece_grids(cfg.piece_set)
        self.render_mode = render_mode

        h, w, s = cfg.height, cfg.width, cfg.queue_size
        self._empty_id = self.tables.num_pieces
        self.board = np.zeros((h, w), dtype=np.uint8)
        self.queue = np.full(s, self._empty_id, dtype=np.int32)
        self._rng = random.Random()
        self.score = 0.0
        self.steps = 0
        self.lines_cleared_total = 0
        self.streak = 0

    # -- RNG / dealing ------------------------------------------------------

    def _deal(self) -> int:
        """One RNG draw = one dealt piece. Draw order is the parity contract."""
        return self._rng.randrange(self.tables.num_pieces)

    def _refill(self) -> None:
        if self.cfg.refill_batch:
            if np.all(self.queue == self._empty_id):
                for i in range(self.cfg.queue_size):
                    self.queue[i] = self._deal()
        else:
            for i in range(self.cfg.queue_size):
                if self.queue[i] == self._empty_id:
                    self.queue[i] = self._deal()

    # -- placement / clear core --------------------------------------------

    def can_place(self, piece_id: int, r: int, c: int) -> bool:
        grid = self._grids[piece_id]
        ph, pw = grid.shape
        if r < 0 or c < 0 or r + ph > self.cfg.height or c + pw > self.cfg.width:
            return False
        window = self.board[r : r + ph, c : c + pw]
        return not np.any(window & grid)

    def legal_action_mask(self) -> np.ndarray:
        """(queue_size * H * W,) bool mask over the flat action space, from
        sliding-window overlap counts on the raw piece grids (independent
        of the engine's derived tables).  Identical piece ids across slots
        compute once."""
        cfg = self.cfg
        hw = cfg.num_cells
        mask = np.zeros(cfg.num_actions(), dtype=bool)
        per_pid: Dict[int, np.ndarray] = {}
        for slot in range(cfg.queue_size):
            pid = int(self.queue[slot])
            if pid == self._empty_id:
                continue
            row = per_pid.get(pid)
            if row is None:
                row = self._piece_legal_row(pid)
                per_pid[pid] = row
            mask[slot * hw : (slot + 1) * hw] = row
        return mask

    def _piece_legal_row(self, pid: int) -> np.ndarray:
        """(H*W,) bool legality of piece ``pid`` at every anchor."""
        cfg = self.cfg
        grid = self._grids[pid]
        ph, pw = grid.shape
        windows = np.lib.stride_tricks.sliding_window_view(
            self.board, (ph, pw)
        )  # (H-ph+1, W-pw+1, ph, pw)
        overlap = np.einsum("rcij,ij->rc", windows, grid)
        row = np.zeros((cfg.height, cfg.width), dtype=bool)
        row[: overlap.shape[0], : overlap.shape[1]] = overlap == 0
        return row.reshape(-1)

    def _place(self, piece_id: int, r: int, c: int) -> int:
        grid = self._grids[piece_id]
        ph, pw = grid.shape
        self.board[r : r + ph, c : c + pw] |= grid
        return int(grid.sum())

    def _clear(self) -> int:
        """Simultaneous clear of all full rows + cols (+ regions). Returns k."""
        cfg = self.cfg
        full_rows = np.where(self.board.all(axis=1))[0]
        full_cols = np.where(self.board.all(axis=0))[0]
        k = len(full_rows) + len(full_cols)
        region_cells: List[Tuple[int, int]] = []
        if cfg.region_clear:
            rs = cfg.region_size
            for br in range(cfg.height // rs):
                for bc in range(cfg.width // rs):
                    block = self.board[
                        br * rs : (br + 1) * rs, bc * rs : (bc + 1) * rs
                    ]
                    if block.all():
                        k += 1
                        region_cells.append((br, bc))
        # compute the full set first, then clear all at once (simultaneity)
        self.board[full_rows, :] = 0
        self.board[:, full_cols] = 0
        if cfg.region_clear:
            rs = cfg.region_size
            for br, bc in region_cells:
                self.board[br * rs : (br + 1) * rs, bc * rs : (bc + 1) * rs] = 0
        return k

    # -- reset / step -------------------------------------------------------

    def _get_obs(self) -> Dict[str, np.ndarray]:
        obs = {"board": self.board.copy(), "queue": self.queue.copy()}
        if self.cfg.obs_planes:
            cfg = self.cfg
            planes = np.zeros(
                (cfg.queue_size, cfg.height, cfg.width), dtype=np.uint8
            )
            for s in range(cfg.queue_size):
                pid = int(self.queue[s])
                if pid != self._empty_id:
                    g = self._grids[pid]
                    planes[s, : g.shape[0], : g.shape[1]] = g
            obs["piece_planes"] = planes
        return obs

    def _get_info(
        self, mask: Optional[np.ndarray] = None, **extra: Any
    ) -> Dict[str, Any]:
        info = {
            "action_mask": self.legal_action_mask() if mask is None else mask,
            "score": self.score,
            "lines_cleared_total": self.lines_cleared_total,
            "streak": self.streak,
        }
        info.update(extra)
        return info

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Reset.  ``options`` may override the fresh state:

          * ``options["board"]``: (H, W) 0/1 array — initial occupancy
            (replaces the empty board).
          * ``options["queue"]``: (S,) piece ids (``num_pieces`` = empty
            slot) — initial hand (replaces the dealt one; the RNG deal
            draws still happen first, so the deal stream is independent of
            whether an override is supplied).
        """
        if seed is not None:
            self._rng = random.Random(seed)
        self.board[:] = 0
        self.queue[:] = self._empty_id
        self.score = 0.0
        self.steps = 0
        self.lines_cleared_total = 0
        self.streak = 0
        self._refill()
        if options:
            unknown = set(options) - {"board", "queue"}
            if unknown:
                raise ValueError(f"unknown reset options: {sorted(unknown)}")
            if "board" in options:
                board = np.asarray(options["board"], dtype=np.uint8)
                if board.shape != self.board.shape:
                    raise ValueError(
                        f"options['board'] shape {board.shape} != "
                        f"{self.board.shape}"
                    )
                if np.any(board > 1):
                    # non-binary cells would make can_place (bitwise &) and
                    # legal_action_mask (overlap counts) disagree
                    raise ValueError("options['board'] cells must be 0/1")
                self.board[:] = board
            if "queue" in options:
                queue = np.asarray(options["queue"], dtype=np.int32)
                if queue.shape != self.queue.shape:
                    raise ValueError(
                        f"options['queue'] shape {queue.shape} != "
                        f"{self.queue.shape}"
                    )
                if np.any((queue < 0) | (queue > self._empty_id)):
                    raise ValueError("options['queue'] ids out of range")
                self.queue[:] = queue
        return self._get_obs(), self._get_info()

    def step(
        self, action: int
    ) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        cfg = self.cfg
        action = int(action)
        if not 0 <= action < cfg.num_actions():
            raise ValueError(f"action {action} out of range")
        slot, r, c = rules.decode_action(cfg, action)
        pid = int(self.queue[slot])

        legal = pid != self._empty_id and self.can_place(pid, r, c)
        lines = 0
        if legal:
            cells = self._place(pid, r, c)
            lines = self._clear()
            self.lines_cleared_total += lines
            reward = cfg.cell_reward * cells + rules.line_bonus(cfg, lines)
            # Woodoku-style streak (the counter stays 0 when disabled):
            # consecutive clearing placements pay streak_bonus * (streak -
            # 1); a non-clearing placement resets the streak (illegal no-ops
            # leave it unchanged)
            if cfg.streak_bonus:
                if lines > 0:
                    self.streak += 1
                    reward += cfg.streak_bonus * (self.streak - 1)
                else:
                    self.streak = 0
            self.queue[slot] = self._empty_id
            self._refill()
        else:
            reward = cfg.illegal_penalty

        self.steps += 1
        mask = self.legal_action_mask()  # one mask: termination + info
        terminated = not mask.any()
        if terminated:
            reward += cfg.terminal_penalty
        truncated = cfg.max_steps > 0 and self.steps >= cfg.max_steps
        self.score += reward
        obs = self._get_obs()
        info = self._get_info(mask=mask, legal=legal, lines_cleared=lines)
        return obs, float(reward), terminated, truncated, info

    # -- rendering ----------------------------------------------------------

    def render(self):
        if self.render_mode == "rgb_array":
            return self._render_rgb()
        text = self._render_ansi()
        if self.render_mode == "human":
            print(text)
            return None
        return text

    def _render_ansi(self) -> str:
        rows = ["".join("█" if v else "·" for v in row) for row in self.board]
        queue_txt = " ".join(
            "-" if q == self._empty_id else str(int(q)) for q in self.queue
        )
        return (
            "\n".join(rows)
            + f"\nqueue: [{queue_txt}]  score: {self.score:.1f}  steps: {self.steps}"
        )

    def _render_rgb(self, scale: int = 16) -> np.ndarray:
        h, w = self.cfg.height, self.cfg.width
        img = np.zeros((h, w, 3), dtype=np.uint8)
        img[self.board == 0] = (24, 24, 32)
        img[self.board == 1] = (90, 170, 255)
        return np.kron(img, np.ones((scale, scale, 1), dtype=np.uint8))

    def close(self) -> None:
        pass
