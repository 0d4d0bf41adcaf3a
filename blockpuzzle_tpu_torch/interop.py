"""Carry JAX engine state and learner weights into the port.

Both come across as numpy arrays: a mid-game u8 ``EnvState`` field by
field (``state_from_numpy``), and the parameter tree of a flax
``ActorCritic`` (``params_from_flax``).
"""

from __future__ import annotations

from typing import Dict, Mapping

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


# flax ActorCritic (mlp torso, embed hand) path -> the port's parameter
_FLAX_PARAMS = {
    ("Torso_0", "mlp_0", "kernel"): "torso.mlp_0.weight",
    ("Torso_0", "mlp_0", "bias"): "torso.mlp_0.bias",
    ("Torso_0", "Embed_0", "embedding"): "torso.embed.weight",
    ("Torso_0", "hidden_proj", "kernel"): "torso.hidden_proj.weight",
    ("Torso_0", "hidden_proj", "bias"): "torso.hidden_proj.bias",
    ("MXUDense_0", "kernel"): "policy.weight",
    ("MXUDense_0", "bias"): "policy.bias",
    ("MXUDense_1", "kernel"): "value.weight",
    ("MXUDense_1", "bias"): "value.bias",
}


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A ``learn.networks.ActorCritic`` state dict from the parameter tree
    of a flax ``ActorCritic`` with ``arch="mlp"`` and
    ``queue_mode="embed"`` (with or without its top-level ``"params"``).

    Leaves are read with ``np.asarray``, through ``.value`` where flax
    boxed them (``nn.Partitioned``).  A Dense kernel is (in, out); the
    port's weights are (out, in), so kernels are transposed.  Every one of
    the nine parameters must be present, and no other."""
    tree = params.get("params", params)
    flat = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat[path] = np.asarray(getattr(node, "value", node), np.float32)

    walk(tree, ())
    if set(flat) != set(_FLAX_PARAMS):
        raise ValueError(
            f"not an mlp/embed ActorCritic param tree: {sorted(flat)}"
        )
    return {
        name: torch.tensor(flat[path].T if path[-1] == "kernel" else flat[path])
        for path, name in _FLAX_PARAMS.items()
    }
