"""Carry a JAX engine state into the port.

The JAX package holds no learned weights on the rollout path; what carries
across is state: a mid-game u8 ``EnvState`` exported field by field with
``np.asarray``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.env import rng
from blockpuzzle_tpu_torch.env.state import EnvState

_FIELDS = {
    "board": torch.uint8,
    "queue": torch.int32,
    "rng_counter": torch.int32,
    "steps": torch.int32,
    "score": torch.float32,
    "streak": torch.int32,
}


def state_from_numpy(
    fields: Mapping[str, np.ndarray], cfg: EnvConfig, device, seed: int
) -> EnvState:
    """The port's ``EnvState`` from numpy copies of a JAX u8 ``EnvState``'s
    fields: board (N, H*W), queue (N, S), rng_counter, steps, score and
    streak (N,).

    JAX's typed ``base_key`` has no counterpart in the port: the stream
    keys come from ``seed`` (``rng.stream_keys``), so the two engines deal
    different pieces from here on unless deals are injected.  The counters
    carry over, so the port's streams still never replay a draw.
    """
    n = np.asarray(fields["board"]).shape[0]
    shapes = {"board": (n, cfg.num_cells), "queue": (n, cfg.queue_size)}
    out = {}
    for name, dtype in _FIELDS.items():
        arr = np.asarray(fields[name])
        want = shapes.get(name, (n,))
        if arr.shape != want:
            raise ValueError(f"{name}: shape {arr.shape}, expected {want}")
        out[name] = torch.tensor(arr, device=device).to(dtype)  # a copy
    return EnvState(base_key=rng.stream_keys(seed, n, device), **out)
