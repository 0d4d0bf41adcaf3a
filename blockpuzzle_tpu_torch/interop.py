"""Carry JAX engine state and learner weights into the port.

Both come across as numpy arrays: a mid-game ``EnvState`` of either board
layout field by field (``state_from_numpy``), and the parameter tree of a
flax ``ActorCritic`` (``params_from_flax``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.env import rng
from blockpuzzle_tpu_torch.env.state import EnvState

_FIELDS = {
    "queue": torch.int32,
    "rng_counter": torch.int32,
    "steps": torch.int32,
    "score": torch.float32,
    "streak": torch.int32,
}


def state_from_numpy(
    fields: Mapping[str, np.ndarray], cfg: EnvConfig, device, seed: int,
    state_impl: str = "u8",
) -> EnvState:
    """The port's ``EnvState`` from numpy copies of a JAX ``EnvState``'s
    fields: board, queue (N, S), rng_counter, steps, score and streak (N,).

    ``state_impl`` names the board layout (an engine's ``state_impl``):
    ``"u8"`` takes (N, H*W) cells and gives uint8; ``"packed"`` takes
    JAX's (N, H) uint32 row words and gives the port's int64 words, the
    same integers.  A u8 cell must be 0 or 1, the engine's invariant
    (``env/state.py``), or this raises ``ValueError``: the bit-row kernels
    read a cell as "nonzero" and write 0/1 cells, which equals the JAX
    kernels' byte sums only on such boards.

    JAX's typed ``base_key`` has no counterpart in the port: the stream
    keys come from ``seed`` (``rng.stream_keys``), so the two engines deal
    different pieces from here on unless deals are injected.  The counters
    carry over, so the port's streams still never replay a draw.
    """
    layouts = {"u8": ((cfg.num_cells,), torch.uint8),
               "packed": ((cfg.height,), torch.int64)}
    if state_impl not in layouts:
        raise ValueError(f"unknown state_impl {state_impl!r}")
    board_shape, board_dtype = layouts[state_impl]
    n = np.asarray(fields["board"]).shape[0]
    shapes = {"board": (n, *board_shape), "queue": (n, cfg.queue_size)}
    out = {}
    for name, dtype in {"board": board_dtype, **_FIELDS}.items():
        arr = np.asarray(fields[name])
        want = shapes.get(name, (n,))
        if arr.shape != want:
            raise ValueError(f"{name}: shape {arr.shape}, expected {want}")
        if name == "board" and state_impl == "u8" and ((arr != 0) & (arr != 1)).any():
            raise ValueError("board: a u8 cell is neither 0 nor 1")
        out[name] = torch.tensor(arr, device=device).to(dtype)  # a copy
    return EnvState(base_key=rng.stream_keys(seed, n, device), **out)


def _flax_names(arch: str, queue_mode: str, num_convs: int
                ) -> Dict[Tuple[str, ...], str]:
    """flax ``ActorCritic`` parameter path -> the port's parameter name."""
    names = {
        ("MXUDense_0", "kernel"): "policy.weight",
        ("MXUDense_0", "bias"): "policy.bias",
        ("MXUDense_1", "kernel"): "value.weight",
        ("MXUDense_1", "bias"): "value.bias",
        ("Torso_0", "hidden_proj", "kernel"): "torso.hidden_proj.weight",
        ("Torso_0", "hidden_proj", "bias"): "torso.hidden_proj.bias",
    }
    if arch == "conv":
        for i in range(num_convs):
            names[("Torso_0", f"Conv_{i}", "kernel")] = f"torso.convs.{i}.weight"
            names[("Torso_0", f"Conv_{i}", "bias")] = f"torso.convs.{i}.bias"
    else:
        names[("Torso_0", "mlp_0", "kernel")] = "torso.mlp_0.weight"
        names[("Torso_0", "mlp_0", "bias")] = "torso.mlp_0.bias"
    if queue_mode == "embed":
        names[("Torso_0", "Embed_0", "embedding")] = "torso.embed.weight"
    return names


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A ``learn.networks.ActorCritic`` state dict from the parameter tree
    of a flax ``ActorCritic`` (with or without its top-level ``"params"``).

    The torso is conv if the tree has ``Torso_0/Conv_0``, else mlp; the
    hand is embedded if it has ``Torso_0/Embed_0``, else planes.  Every
    parameter of that architecture must be present, and no other.  Leaves
    are read with ``np.asarray``, through ``.value`` where flax boxed them
    (``nn.Partitioned``).  A Dense kernel is (in, out) and the port's
    weight (out, in); a Conv kernel is (3, 3, in, out) and the port's
    weight (out, in, 3, 3).  Leading axes (a stack of trees) are kept."""
    tree = params.get("params", params)
    flat = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat[path] = np.asarray(getattr(node, "value", node), np.float32)

    walk(tree, ())
    torso = {path[1] for path in flat if path[0] == "Torso_0"}
    arch = "conv" if "Conv_0" in torso else "mlp"
    queue_mode = "embed" if "Embed_0" in torso else "planes"
    num_convs = sum(1 for m in torso if m.startswith("Conv_"))
    names = _flax_names(arch, queue_mode, num_convs)
    if set(flat) != set(names):
        raise ValueError(
            f"not an {arch}/{queue_mode} ActorCritic param tree: {sorted(flat)}"
        )
    out = {}
    for path, name in names.items():
        x = flat[path]
        if path[-1] == "kernel" and path[1].startswith("Conv_"):
            x = np.moveaxis(x, (-4, -3, -2, -1), (-2, -1, -3, -4))
        elif path[-1] == "kernel":
            x = np.swapaxes(x, -1, -2)
        out[name] = torch.tensor(np.ascontiguousarray(x))
    return out
