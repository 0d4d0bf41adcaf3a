"""Packed legal-words mask and the rank-select uniform sampler (serving path).

The port of ``blockpuzzle_tpu/env/words.py``.  A consumer that takes the
legal mask as packed row words (bit ``c`` of word ``s*H + r`` set iff
action ``(s*H + r)*W + c`` is legal) samples a uniform-legal action from
one (N,) uniform and a popcount rank-select over the S*H words, instead of
an (N, A) draw and an argmax over the A = S*H*W bools of the bool mask.

Words are int64 tensors holding u32 values, as the packed board's are
(torch's CPU ``uint32`` has no shifts).  JAX's random bits cannot be
reproduced, so ``sample_uniform_legal`` takes the (N,) float32 uniform in
place of a key (``sampler.WordsSampler`` draws it from the port's own
streams); fed JAX's uniform, it returns JAX's actions.
"""

from __future__ import annotations

import torch

from blockpuzzle_tpu_torch.kernels.packed import pack_words, popcount32


def rank_select_bit(word: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Bit index of the j-th (0-based) set bit of each u32 ``word``.

    5-step binary search on prefix popcounts; callers guarantee ``j <
    popcount(word)``.  Shapes broadcast; the result has ``j``'s dtype."""
    pos = torch.zeros_like(j)
    rem = j
    for width in (16, 8, 4, 2, 1):
        lowmask = ((1 << width) - 1) << pos.to(torch.int64)
        c = popcount32(word & lowmask).to(j.dtype)
        go_high = rem >= c
        rem = torch.where(go_high, rem - c, rem)
        pos = pos + torch.where(go_high, width, 0).to(j.dtype)
    return pos


def sample_uniform_legal(
    words: torch.Tensor, u: torch.Tensor, width: int
) -> torch.Tensor:
    """(N,) int64 uniform-legal flat action ids from (N, S*H) legal row
    words and an (N,) float32 uniform in [0, 1).

    ``a = word_index * W + bit``, the engine's flat (slot, row, col)
    layout.  The rank ``r = min(int32(u * float32(total)), max(total - 1,
    0))`` is JAX's arithmetic: one float32 multiply, truncated toward zero.
    The word holding the r-th legal bit is the number of prefix counts at
    most r; the prefix counts come from a static loop of running sums over
    the S*H columns (``PERF.md`` §6 has the card's times of this and of
    ``torch.cumsum``).  An env with no legal action (a frozen terminal
    state) gets action 0."""
    cnt = popcount32(words)                                      # (N, SH)
    csum = [cnt[:, 0]]
    for k in range(1, cnt.shape[1]):
        csum.append(csum[-1] + cnt[:, k])
    csum = torch.stack(csum, dim=1)                              # (N, SH)
    total = csum[:, -1]
    # the float32 product truncated toward zero: JAX's int32 cast, here in
    # int64 (the product is at most S*H*W)
    r = torch.minimum((u * total.to(torch.float32)).to(torch.int64),
                      (total - 1).clamp_min(0))
    widx = (csum <= r[:, None]).sum(dim=1)
    # with no legal action widx is S*H, one past the last word: gather a
    # word that is there, and pin the action to 0 below
    at = widx.clamp(max=cnt.shape[1] - 1)[:, None]
    word = words.gather(1, at)[:, 0]
    prev = (csum - cnt).gather(1, at)[:, 0]
    bit = rank_select_bit(word, r - prev)
    return torch.where(total > 0, widx * width + bit, 0)


def legal_words(env, board_words: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
    """(N, S*H) int64 packed legal mask of a packed-engine board: the words
    entry of the engine's packed mask kernel (``PackedMaskKernel.words``),
    the same legality as its bool mask; on the CPU that entry's plain
    version.  ``env`` must be a packed-state engine and ``board_words`` its
    native (N, H) int64 board."""
    if env.state_impl != "packed":
        raise ValueError("legal_words needs a packed-state engine")
    return env.packed_mask_kernel.words(board_words, queue)


def pack_bool_mask(
    mask: torch.Tensor, height: int, width: int, queue_size: int
) -> torch.Tensor:
    """(N, S*H*W) bool -> (N, S*H) int64 row words (pow2-weighted sums)."""
    return pack_words(mask.reshape(mask.shape[0], queue_size * height, width))
