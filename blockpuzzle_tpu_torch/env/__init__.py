"""Vectorized env engine, PyTorch port."""

from __future__ import annotations

from typing import Optional

import torch

from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.env.core import VecBlockPuzzle
from blockpuzzle_tpu_torch.env.state import EnvState, TimeStep


def make_env(
    cfg: Optional[EnvConfig] = None,
    device="cuda",
    backend: str = "pallas",
    state_impl: str = "u8",
) -> VecBlockPuzzle:
    """The u8-board engine (``state_impl="u8"``) on ``device``.

    ``backend`` is ``"pallas"`` (the chosen action goes through the apply
    kernel), ``"jnp"`` or ``"hybrid"`` (torch collision test, then the
    clear kernel); all three give the same bits (see ``VecBlockPuzzle``).
    The packed layout and piece-plane observations are not ported yet and
    raise ``NotImplementedError`` naming the ROADMAP.md item that brings
    them.
    """
    if cfg is None:
        cfg = EnvConfig()
    if state_impl == "packed":
        raise NotImplementedError(
            "state_impl='packed' is ROADMAP.md A2 (packed engine), with its "
            "fused step kernel B1"
        )
    if state_impl != "u8":
        raise ValueError(f"unknown state_impl {state_impl!r}")
    if cfg.obs_planes:
        raise NotImplementedError("obs_planes is ROADMAP.md A9")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    return VecBlockPuzzle(cfg, device, backend)


__all__ = ["EnvState", "TimeStep", "VecBlockPuzzle", "make_env"]
