"""Counter-based random streams in plain torch integer ops.

Every draw is a pure function of ``(key, counter, tag, lane)``: a chain of
32-bit integer mixes (a lowbias32-style xorshift-multiply hash) with each
input XORed in before a bijective mix.  So a draw never depends on device,
batch layout or call order, and CPU and CUDA give the same bits.

All arithmetic runs in int64 on values below 2**32: CPU ``uint32`` tensors
have no shifts, and a product of two 32-bit values can pass int64's sign
bit, so every product here has one factor below 2**31 (see ``_mul32``) and
is masked back to 32 bits.

The contract follows the JAX engine (``blockpuzzle_tpu/env/core.py``
``_deal_batch``/``_deal_batch2``, ``env/state.py``):
  * ``deal(key, counter, tag, width, P)`` gives uniform ids in ``[0, P)``;
  * the step makes one ``2S``-wide ``TAG_STEP`` draw: refill in ``[:S]``,
    auto-reset in ``[S:]``;
  * ``init``, ``reset`` and ``partial_reset`` draw from ``TAG_RESET``;
  * the policy's u32 draws come from ``TAG_POLICY``;
  * the per-env counter only grows, so no draw is ever replayed.
JAX's ``rbg`` bits cannot be reproduced; comparisons with JAX inject deals
(``deal_override``).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
TAG_STEP = 0
TAG_RESET = 1
TAG_POLICY = 2
_MAX_LANES = 1 << 16


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``0 <= x < 2**32`` without int64 overflow:
    ``c = c' + 2**31`` contributes ``(x & 1) << 31`` beyond ``x * c'``."""
    if c < 1 << 31:
        return (x * c) & MASK32
    return (x * (c & 0x7FFFFFFF) + ((x & 1) << 31)) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Bijective 32-bit integer hash of int64 values in ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = _mul32(x, 0xD35A2D97)
    return x ^ (x >> 15)


def stream_keys(seed: int, num_envs: int, device) -> torch.Tensor:
    """(N,) int64 per-env stream keys from one seed.

    The low 32 bits are a bijection of the env index for a fixed seed, so
    no two envs of one batch share a stream."""
    seed %= 1 << 64
    i = torch.arange(num_envs, dtype=torch.int64, device=device)
    lo = mix32(mix32(i ^ (seed & MASK32) ^ 0x9E3779B9) ^ (seed >> 32))
    hi = mix32(lo ^ 0x85EBCA6B) & 0x7FFFFFFF
    return (hi << 32) | lo


def bits(key: torch.Tensor, counter, tag: int, width: int) -> torch.Tensor:
    """(N, width) int64 holding uniform u32 draws.

    ``counter`` is an (N,) integer tensor or a Python int shared by all
    envs."""
    if not 0 < width <= _MAX_LANES or not 0 <= tag < _MAX_LANES:
        raise ValueError(f"width {width} / tag {tag} out of range")
    if isinstance(counter, torch.Tensor):
        counter = counter.to(torch.int64) & MASK32
    else:
        counter &= MASK32
    h = mix32((key & MASK32) ^ 0x243F6A88)
    h = mix32(h ^ ((key >> 32) & MASK32))
    h = mix32(h ^ counter)
    lanes = (tag << 16) | torch.arange(width, dtype=torch.int64, device=key.device)
    return mix32(h[:, None] ^ lanes[None, :])


def deal(
    key: torch.Tensor, counter, tag: int, width: int, num_pieces: int
) -> torch.Tensor:
    """(N, width) int32 uniform piece ids in ``[0, num_pieces)``:
    ``(u32 * P) >> 32``."""
    return ((bits(key, counter, tag, width) * num_pieces) >> 32).to(torch.int32)
