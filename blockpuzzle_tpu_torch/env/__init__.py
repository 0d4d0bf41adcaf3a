"""Vectorized env engine, PyTorch port."""

from __future__ import annotations

from typing import Optional

from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.env.core import VecBlockPuzzle
from blockpuzzle_tpu_torch.env.state import EnvState, TimeStep


def make_env(
    cfg: Optional[EnvConfig] = None,
    device="cuda",
    backend: str = "jnp",
    state_impl: Optional[str] = None,
) -> VecBlockPuzzle:
    """The engine on ``device``, with the JAX ``make_env``'s defaults.

    ``state_impl=None`` resolves to ``"packed"`` ((N, H) row words) when
    rows fit a 32-bit word (``width <= 32``) and ``backend == "jnp"``, and
    to ``"u8"`` ((N, H*W) cells) otherwise.  Packed boards need both;
    asking for them otherwise raises ``ValueError``.  On u8 boards
    ``backend`` is ``"pallas"`` (the chosen action goes through the apply
    kernel), ``"jnp"`` or ``"hybrid"`` (torch collision test, then the
    clear kernel).  Every choice gives the same bits (see
    ``VecBlockPuzzle``).  The JAX knobs ``mask_impl``, ``mask_dtype`` and
    ``rng_impl`` change no output and are not ported.
    """
    if cfg is None:
        cfg = EnvConfig()
    return VecBlockPuzzle(cfg, device, backend, state_impl)


__all__ = ["EnvState", "TimeStep", "VecBlockPuzzle", "make_env"]
