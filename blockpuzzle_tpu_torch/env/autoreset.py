"""The three Gymnasium autoreset conventions over the batched engine.

Everything ``blockpuzzle_tpu/vector_env.py`` does except the spaces and the
numpy boundary, on device tensors and without gymnasium, so that a machine
without gymnasium (the card's) runs it too; ``vector_env.py`` puts the
Gymnasium surface on top.  Modes (the strings of ``MODES``):

* ``"same_step"``: the engine auto-resets in the step; a finished env
  presents the reset observation, and the pre-reset one as
  ``final_board``/``final_queue`` (``final_planes`` with
  ``cfg.obs_planes``).
* ``"next_step"``: a finished env presents its final observation; on the
  next step its action is ignored (reward 0, both done flags False) and it
  presents the reset observation (``next_step_combine``).
* ``"disabled"``: no automatic reset; finished envs are frozen, their step
  a bit-exact no-op but for ``rng_counter``, their death-time done flags
  presented again, until ``reset(options={"reset_mask": ...})`` re-deals
  them (``disabled_combine``).

Seeds go through ``rng.stream_keys``, so a given seed deals other pieces
than JAX's ``jax.random.key(seed)``.  ``step`` never waits for the device:
no ``.item()`` and no branch on a tensor's value.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from blockpuzzle_tpu_torch.env.core import VecBlockPuzzle
from blockpuzzle_tpu_torch.env.state import EnvState, TimeStep

MODES = ("same_step", "next_step", "disabled")


def _w(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-env where: the (N,) predicate broadcast over a's trailing dims."""
    return torch.where(p.view(p.shape + (1,) * (a.dim() - 1)), a, b)


def raw_from_ts(ts: TimeStep) -> Dict[str, torch.Tensor]:
    """The engine's observation fields that the combines carry."""
    raw = {"board": ts.board, "queue": ts.queue, "mask": ts.action_mask}
    if ts.piece_planes is not None:
        raw["planes"] = ts.piece_planes
    return raw


def next_step_combine(new_state: EnvState, new_ts: TimeStep, old_state: EnvState,
                      old_raw: Dict[str, torch.Tensor], pending: torch.Tensor):
    """NEXT_STEP: substitute held-back resets for ``pending`` envs.

    Pending envs (finished on the previous step) did not really take this
    step: their pre-step state, which the fused auto-reset already
    re-initialized, is restored whole, ``rng_counter`` included, so the
    discarded transition's draws are made again later; they present the
    reset observation with reward 0 and both done flags False.  Envs that
    finish in this step present their final (pre-reset) observation.
    Returns (state, raw observation carried to the next combine, presented
    fields, done_now)."""
    done_now = new_ts.done & ~pending
    info = new_ts.info
    state = new_state.replace(
        board=_w(pending, old_state.board, new_state.board),
        queue=_w(pending, old_state.queue, new_state.queue),
        rng_counter=torch.where(pending, old_state.rng_counter, new_state.rng_counter),
        steps=torch.where(pending, old_state.steps, new_state.steps),
        score=torch.where(pending, old_state.score, new_state.score),
        streak=torch.where(pending, old_state.streak, new_state.streak),
    )
    new_raw = raw_from_ts(new_ts)
    final = {"board": info["final_board"], "queue": info["final_queue"],
             "mask": info["final_action_mask"]}
    if "planes" in old_raw:
        final["planes"] = info["final_piece_planes"]
    raw = {k: _w(pending, old_raw[k], new_raw[k]) for k in old_raw}
    presented = {k: _w(pending, old_raw[k], _w(done_now, final[k], new_raw[k]))
                 for k in old_raw}
    presented["reward"] = torch.where(pending, 0.0, new_ts.reward)
    presented["terminated"] = new_ts.terminated & ~pending
    presented["truncated"] = new_ts.truncated & ~pending
    presented["lines_cleared"] = torch.where(pending, 0, info["lines_cleared"])
    presented["episode_return"] = torch.where(pending, 0.0, info["episode_return"])
    presented["streak"] = torch.where(pending, 0, info["streak"])
    return state, raw, presented, done_now


def disabled_combine(new_state: EnvState, new_ts: TimeStep, old_state: EnvState,
                     old_raw: Dict[str, torch.Tensor], dead: torch.Tensor,
                     dterm: torch.Tensor, dtrunc: torch.Tensor):
    """DISABLED: freeze envs that already finished.

    Without this the engine would recompute ``terminated`` from a dead
    env's empty mask and apply ``terminal_penalty`` again every step, and a
    dead env under ``max_steps`` would count towards a false truncation.
    Dead envs restore their pre-step state whole but ``rng_counter``, which
    keeps advancing (the counter only grows; its draws go unused while
    frozen), present reward 0 and the done flags recorded at death.
    Returns (state, raw observation, presented fields, dead, its
    terminated and its truncated flags)."""
    state = new_state.replace(
        board=_w(dead, old_state.board, new_state.board),
        queue=_w(dead, old_state.queue, new_state.queue),
        steps=torch.where(dead, old_state.steps, new_state.steps),
        score=torch.where(dead, old_state.score, new_state.score),
        streak=torch.where(dead, old_state.streak, new_state.streak),
    )
    new_raw = raw_from_ts(new_ts)
    raw = {k: _w(dead, old_raw[k], new_raw[k]) for k in old_raw}
    info = new_ts.info
    term_out = torch.where(dead, dterm, new_ts.terminated)
    trunc_out = torch.where(dead, dtrunc, new_ts.truncated)
    presented = dict(raw)
    presented["reward"] = torch.where(dead, 0.0, new_ts.reward)
    presented["terminated"] = term_out
    presented["truncated"] = trunc_out
    presented["lines_cleared"] = torch.where(dead, 0, info["lines_cleared"])
    presented["episode_return"] = torch.where(dead, old_state.score,
                                              info["episode_return"])
    presented["streak"] = torch.where(dead, old_state.streak, info["streak"])
    dead_out = dead | term_out | trunc_out
    return state, raw, presented, dead_out, term_out, trunc_out


def to_host(fields: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Numpy copies of the presented fields: the Gymnasium surface's
    boundary."""
    return {k: v.cpu().numpy() for k, v in fields.items()}


class AutoresetEnv:
    """N lockstep envs of one engine under one autoreset mode.

    ``reset`` and ``step`` return the presented fields as device tensors:
    ``board`` (N, H, W) uint8, ``queue`` (N, S) int32, ``mask`` (N, A)
    bool and, with ``cfg.obs_planes``, ``planes`` (N, S, H, W) uint8; a
    step adds ``reward``, ``terminated``, ``truncated``,
    ``lines_cleared``, ``episode_return`` and ``streak``, and in
    ``"same_step"`` mode ``final_board``, ``final_queue`` (and
    ``final_planes``), equal to the presented fields for envs that did
    not finish.  The carried state is ``state`` and, as in the JAX
    adapter, ``_pending``, ``_raw_obs``, ``_dead``, ``_dead_term`` and
    ``_dead_trunc`` (``carried()``).
    """

    def __init__(self, engine: VecBlockPuzzle, num_envs: int,
                 mode: str = "same_step") -> None:
        if mode not in MODES:
            raise ValueError(f"autoreset mode {mode!r} not one of {list(MODES)}")
        self.engine = engine
        self.cfg = engine.cfg
        self.num_envs = num_envs
        self.mode = mode
        self.state: Optional[EnvState] = None
        self._pending = None     # next_step: envs that finished last step
        self._raw_obs = None     # next_step/disabled: engine obs carried
        self._dead = None        # disabled: envs frozen awaiting reset_mask
        self._dead_term = None   # disabled: terminated flag at death
        self._dead_trunc = None  # disabled: truncated flag at death

    def carried(self) -> Dict[str, torch.Tensor]:
        """The state it carries from step to step, flat."""
        out = {f"state.{k}": v for k, v in vars(self.state).items()}
        out.update({f"raw.{k}": v for k, v in self._raw_obs.items()})
        out.update(pending=self._pending, dead=self._dead,
                   dead_term=self._dead_term, dead_trunc=self._dead_trunc)
        return out

    def reset(self, seed: Optional[int] = None,
              options: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """A full reset from ``seed`` (fresh entropy when None), with
        optional ``options["board"]`` ((N, H, W) or (N, H*W) 0/1 cells)
        and ``options["queue"]`` ((N, S) ids) overriding the fresh state;
        or, with ``options["reset_mask"]`` ((N,) bool) alone and no seed,
        the engine's ``partial_reset`` of the flagged envs."""
        if options and "reset_mask" in options:
            return self._partial_reset(seed, options)
        engine, n = self.engine, self.num_envs
        if seed is None:
            # gymnasium's convention: an unseeded reset draws fresh entropy
            seed = int.from_bytes(os.urandom(4), "little")
        self.state, ts = engine.init(seed, n)
        if options:
            unknown = set(options) - {"board", "queue"}
            if unknown:
                raise ValueError(f"unknown reset options: {sorted(unknown)}")
            board, queue = self.state.board, self.state.queue
            if "board" in options:
                b_host = np.asarray(options["board"], dtype=np.uint8)
                want = ((n, self.cfg.height, self.cfg.width), (n, self.cfg.num_cells))
                if b_host.shape not in want:
                    # a bare reshape would read e.g. a transposed (HW, N)
                    # array as N wrong boards; the oracle raises too
                    raise ValueError(
                        f"options['board'] shape {b_host.shape} not in {want}")
                if np.any(b_host > 1):
                    raise ValueError("options['board'] cells must be 0/1")
                board = engine.encode_board(b_host)
            if "queue" in options:
                q_host = np.asarray(options["queue"], dtype=np.int32)
                if q_host.shape != (n, self.cfg.queue_size):
                    raise ValueError(
                        f"options['queue'] shape {q_host.shape} != "
                        f"{(n, self.cfg.queue_size)}")
                # the oracle's contract: a bogus id would act as a silent
                # dead slot
                if np.any((q_host < 0) | (q_host > engine.empty_id)):
                    raise ValueError("options['queue'] ids out of range")
                queue = torch.as_tensor(q_host, device=engine.device)
            self.state = self.state.replace(board=board, queue=queue)
            ts.board = engine.board_obs(board)
            ts.queue = queue
            ts.action_mask = engine.action_mask(board, queue)
            if self.cfg.obs_planes:
                ts.piece_planes = engine.piece_planes(queue)
        zeros = torch.zeros(n, dtype=torch.bool, device=engine.device)
        self._pending = self._dead = self._dead_term = self._dead_trunc = zeros
        self._raw_obs = raw_from_ts(ts)
        return dict(self._raw_obs)

    def _partial_reset(self, seed, options) -> Dict[str, torch.Tensor]:
        if len(options) > 1:
            raise ValueError(
                "options['reset_mask'] cannot be combined with other reset options")
        if seed is not None:
            raise ValueError(
                "seed= with reset_mask is unsupported: flagged envs re-deal "
                "from their own counter-based streams")
        if self.state is None:
            raise RuntimeError("full reset() required before reset_mask")
        m = np.asarray(options["reset_mask"])
        if m.shape != (self.num_envs,):
            raise ValueError(f"reset_mask shape {m.shape} != {(self.num_envs,)}")
        m_dev = torch.as_tensor(m.astype(bool), device=self.engine.device)
        self.state, ts = self.engine.partial_reset(self.state, m_dev)
        alive = ~m_dev
        if self.mode == "next_step":
            self._pending = self._pending & alive
            self._raw_obs = raw_from_ts(ts)
        elif self.mode == "disabled":
            self._dead = self._dead & alive
            self._dead_term = self._dead_term & alive
            self._dead_trunc = self._dead_trunc & alive
            self._raw_obs = raw_from_ts(ts)
        return raw_from_ts(ts)

    def step(self, actions) -> Dict[str, torch.Tensor]:
        """One step of every env under the mode; ``actions`` (N,) flat ids,
        a tensor or anything ``torch.as_tensor`` takes."""
        if self.state is None:
            raise RuntimeError("call reset() before step()")
        old = self.state
        if self.mode == "next_step":
            new, ts = self.engine.step(old, actions, auto_reset=True)
            self.state, self._raw_obs, out, self._pending = next_step_combine(
                new, ts, old, self._raw_obs, self._pending)
            return out
        if self.mode == "disabled":
            new, ts = self.engine.step(old, actions, auto_reset=False)
            (self.state, self._raw_obs, out, self._dead, self._dead_term,
             self._dead_trunc) = disabled_combine(
                new, ts, old, self._raw_obs, self._dead, self._dead_term,
                self._dead_trunc)
            return out
        self.state, ts = self.engine.step(old, actions, auto_reset=True)
        out = raw_from_ts(ts)
        info = ts.info
        out.update(reward=ts.reward, terminated=ts.terminated, truncated=ts.truncated,
                   lines_cleared=info["lines_cleared"],
                   episode_return=info["episode_return"], streak=info["streak"],
                   final_board=info["final_board"], final_queue=info["final_queue"])
        if ts.piece_planes is not None:
            out["final_planes"] = info["final_piece_planes"]
        return out

    def close(self) -> None:
        self.state = None
