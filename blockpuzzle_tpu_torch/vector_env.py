"""Gymnasium surface of the port: a ``VectorEnv`` over the batched engine and
the single-env ids, as ``blockpuzzle_tpu/vector_env.py`` and
``blockpuzzle_tpu/__init__.py`` give them for the JAX package.

The one module of the port that imports gymnasium; nothing else of the port
imports it, so the engine, the CLIs and ``chip_smoke.py`` run where
gymnasium is missing (the card's machine).  The autoreset conventions live
in ``env/autoreset.py`` on device tensors; this module adds the spaces and
the numpy boundary.

``BlockPuzzleVectorEnv`` takes the JAX adapter's arguments plus
``device`` (default ``"cuda"``).  ``autoreset_mode`` is a
``gymnasium.vector.AutoresetMode`` or its lower-case name.  As in the JAX
adapter, ``infos["final_obs"]`` (SAME_STEP, when an env finished) is a
dict of batched arrays (``{"board": (N, H, W), "queue": (N, S)}``, plus
``"piece_planes"`` with ``cfg.obs_planes``) rather than an (N,) object
array of per-env dicts, beside the flat ``final_board``/``final_queue``
with their ``_``-masks.  A seed deals other pieces than the JAX adapter's
(``env/autoreset.py``).

Importing the module registers ``BlockPuzzleTpuTorch/BlockPuzzle{suffix}-v0``
for every preset (``suffix`` ``""`` for the default, ``-tenten``, ...):
``gymnasium.make`` gives the port's CPU oracle as a ``gymnasium.Env``
(``BlockPuzzleOracleGymEnv``), ``gymnasium.make_vec`` this class.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

import gymnasium
from gymnasium import spaces
from gymnasium.vector import AutoresetMode, VectorEnv
from gymnasium.vector.utils import batch_space

from blockpuzzle_tpu_torch.config import PRESETS, EnvConfig, default_config
from blockpuzzle_tpu_torch.env import make_env
from blockpuzzle_tpu_torch.env.autoreset import AutoresetEnv, to_host
from blockpuzzle_tpu_torch.oracle.env import BlockPuzzleOracleEnv

_OBS = {"board": "board", "queue": "queue", "planes": "piece_planes"}


def observation_spaces(cfg: EnvConfig, num_pieces: int) -> Dict[str, spaces.Box]:
    """One env's observation spaces, those of the JAX oracle and adapter."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    out = {"board": spaces.Box(0, 1, shape=(h, w), dtype=np.uint8),
           # piece id per slot; num_pieces is the empty-slot sentinel
           "queue": spaces.Box(0, num_pieces, shape=(s,), dtype=np.int32)}
    if cfg.obs_planes:
        out["piece_planes"] = spaces.Box(0, 1, shape=(s, h, w), dtype=np.uint8)
    return out


class BlockPuzzleOracleGymEnv(BlockPuzzleOracleEnv, gymnasium.Env):
    """The port's CPU oracle as a ``gymnasium.Env``: its game, with the
    spaces and metadata of ``blockpuzzle_tpu/oracle/env.py``."""

    metadata = {"render_modes": ["ansi", "human", "rgb_array"], "render_fps": 4}

    def __init__(self, cfg: Optional[EnvConfig] = None,
                 render_mode: Optional[str] = None, **overrides: Any) -> None:
        BlockPuzzleOracleEnv.__init__(self, cfg, render_mode, **overrides)
        self.action_space = spaces.Discrete(self.cfg.num_actions())
        self.observation_space = spaces.Dict(
            observation_spaces(self.cfg, self.tables.num_pieces))

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        gymnasium.Env.reset(self, seed=seed)
        return BlockPuzzleOracleEnv.reset(self, seed=seed, options=options)


class BlockPuzzleVectorEnv(VectorEnv):
    """N lockstep BlockPuzzle envs on one device."""

    metadata = {"render_modes": ["rgb_array"], "autoreset_mode": AutoresetMode.SAME_STEP}

    def __init__(
        self,
        num_envs: int = 1024,
        cfg: Optional[EnvConfig] = None,
        backend: str = "jnp",
        render_mode: Optional[str] = None,
        autoreset_mode: "str | AutoresetMode" = "same_step",
        device="cuda",
        **overrides: Any,
    ) -> None:
        self.autoreset = None  # close() may run on an instance that failed here
        if cfg is None:
            cfg = default_config()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if isinstance(autoreset_mode, str):
            try:
                autoreset_mode = AutoresetMode[autoreset_mode.upper()]
            except KeyError:
                raise ValueError(
                    f"autoreset_mode {autoreset_mode!r} not one of "
                    f"{[m.name.lower() for m in AutoresetMode]}") from None
        elif not isinstance(autoreset_mode, AutoresetMode):
            # a value of another type would read as SAME_STEP under false
            # metadata
            raise TypeError(
                f"autoreset_mode must be a str or AutoresetMode, got {autoreset_mode!r}")
        self.cfg = cfg
        self.engine = make_env(cfg, device=device, backend=backend)
        self.num_envs = num_envs
        self.render_mode = render_mode
        self.autoreset_mode = autoreset_mode
        # per instance: wrappers read metadata["autoreset_mode"]
        self.metadata = {**type(self).metadata, "autoreset_mode": autoreset_mode}
        self.autoreset = AutoresetEnv(self.engine, num_envs, autoreset_mode.name.lower())
        self.single_observation_space = spaces.Dict(
            observation_spaces(cfg, self.engine.num_pieces))
        self.single_action_space = spaces.Discrete(cfg.num_actions())
        self.observation_space = batch_space(self.single_observation_space, num_envs)
        self.action_space = batch_space(self.single_action_space, num_envs)
        self._last_board = None  # the presented boards, for render()

    def _obs(self, host: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        obs = {name: host[k] for k, name in _OBS.items() if k in host}
        self._last_board = obs["board"]
        return obs

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        host = to_host(self.autoreset.reset(seed, options))
        return self._obs(host), {"action_mask": host["mask"]}

    def step(self, actions) -> Tuple[
        Dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]
    ]:
        host = to_host(self.autoreset.step(np.asarray(actions)))
        infos: Dict[str, Any] = {
            "action_mask": host["mask"],
            "lines_cleared": host["lines_cleared"],
            "episode_return": host["episode_return"],
            "streak": host["streak"],
        }
        terminated, truncated = host["terminated"], host["truncated"]
        done = terminated | truncated
        if self.autoreset_mode is AutoresetMode.SAME_STEP and done.any():
            # gymnasium's SAME_STEP key, batched...
            infos["final_obs"] = {"board": host["final_board"],
                                  "queue": host["final_queue"]}
            if "final_planes" in host:
                infos["final_obs"]["piece_planes"] = host["final_planes"]
            infos["_final_obs"] = done
            # ...and flat per-field arrays for vectorized consumers
            infos["final_board"] = host["final_board"]
            infos["final_queue"] = host["final_queue"]
            infos["_final_board"] = done
            infos["_final_queue"] = done
        return self._obs(host), host["reward"], terminated, truncated, infos

    def render(self):
        if self.render_mode != "rgb_array" or self._last_board is None:
            return None
        # tile the first <= 16 boards into a grid image
        boards = self._last_board[:16]
        n = boards.shape[0]
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        h, w = self.cfg.height, self.cfg.width
        canvas = np.zeros((rows * (h + 1), cols * (w + 1), 3), dtype=np.uint8)
        for i in range(n):
            r, c = divmod(i, cols)
            img = np.zeros((h, w, 3), np.uint8)
            img[boards[i] == 0] = (24, 24, 32)
            img[boards[i] == 1] = (90, 170, 255)
            canvas[r * (h + 1): r * (h + 1) + h, c * (w + 1): c * (w + 1) + w] = img
        return np.kron(canvas, np.ones((8, 8, 1), dtype=np.uint8))

    def close_extras(self, **kwargs):
        if self.autoreset is not None:
            self.autoreset.close()


def register_gym_envs() -> None:
    """Register ``BlockPuzzleTpuTorch/BlockPuzzle{suffix}-v0`` for every
    preset; ids already registered are left as they are."""
    for name, preset in PRESETS.items():
        suffix = "" if name == "default" else f"-{name}"
        env_id = f"BlockPuzzleTpuTorch/BlockPuzzle{suffix}-v0"
        if env_id in gymnasium.registry:
            continue
        gymnasium.register(
            id=env_id,
            entry_point="blockpuzzle_tpu_torch.vector_env:BlockPuzzleOracleGymEnv",
            vector_entry_point="blockpuzzle_tpu_torch.vector_env:BlockPuzzleVectorEnv",
            kwargs={"cfg": preset()},
        )


register_gym_envs()
