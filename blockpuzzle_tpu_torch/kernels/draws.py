"""The main path's random draws: CUDA kernels (``csrc/draws.cu``, on the
hash of ``csrc/hash32.cuh``) and their plain versions.

Every draw is the counter-based hash of ``env/rng.py``, a pure function of
(key, counter, tag, lane), so a kernel and its plain version give the same
bits.  No Pallas source: the JAX package leaves its draws to XLA.

* ``DealKernel`` (B9): ``rng.deal``, the step's ``2S``-wide ``TAG_STEP``
  deal and every ``TAG_RESET`` deal (``init``, ``reset``,
  ``partial_reset``, the parity mode's auto-reset) at the env's own counter
  or at one counter for all.
* ``UniformLegalKernel`` (B2): ``UniformLegalSampler``'s draw, one
  ``TAG_POLICY`` u32 per action, and the argmax of ``uniform_legal``.
* ``WordsSelectKernel`` (B2w): ``WordsSampler``'s draw, one ``TAG_POLICY``
  u32 per env made a uniform (``uniform_from_bits``), and the rank-select
  of ``env/words.py`` ``sample_uniform_legal`` over the legal row words;
  on the card a segment of ``select_lanes`` threads an env, each holding
  its span of the row's words (``select_shape``).

Counters are taken mod 2**32: an int32 ``rng_counter`` that has wrapped
negative draws what its ``uint32`` bits name.
"""

from __future__ import annotations

from typing import Union

import torch

from blockpuzzle_tpu_torch.env import rng
from blockpuzzle_tpu_torch.env.words import sample_uniform_legal
from blockpuzzle_tpu_torch.kernels import _build

Counter = Union[int, torch.Tensor]


def uniform_legal(mask: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(N,) int64 actions from an (N, A) bool mask and (N, A) u32 draws
    (held in int64): ``where(mask, bits | 1, 0)`` keeps every legal draw
    above the illegal zeros, and the argmax picks a legal action uniformly
    (ties, at odds of ~2**-32, go to the first index, in torch as in JAX).
    A row with no legal action gives action 0."""
    return torch.where(mask, bits | 1, 0).argmax(dim=1)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) from u32 draws (held in int64): the top
    23 bits as the mantissa, ``float32(bits >> 9) * 2**-23``, bit for bit
    what ``jax.random.uniform`` makes of the same u32 bits."""
    return (bits >> 9).to(torch.float32) * 2.0 ** -23


def _check_key(key: torch.Tensor, device: torch.device) -> int:
    if key.device != device:
        raise ValueError(f"key on {key.device}, kernel on {device}")
    if key.dim() != 1 or key.dtype != torch.int64:
        raise ValueError("key must be (N,) int64")
    return key.shape[0]


def _check_counter(counter) -> None:
    """The policy draws take one counter for all envs, a Python int."""
    if not isinstance(counter, int):
        raise ValueError(f"counter must be a Python int, got {type(counter).__name__}")


def _launch_ready(device: torch.device, what: str, *tensors: torch.Tensor) -> None:
    """Raise unless ``device`` is a card and ``tensors`` are contiguous."""
    if device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {what} kernel's inputs must be contiguous")


class DealKernel:
    """Uniform piece ids in ``[0, num_pieces)`` from the per-env streams, on
    one device, the card unless asked for another.

    ``__call__(key (N,) int64, counter, tag, width) -> (N, width) int32``,
    ``counter`` an (N,) int32 tensor or a Python int shared by all envs.
    For CPU tensors it runs ``rng.deal``; for CUDA tensors it launches the
    kernel (``launches`` counts those launches) or raises.  The output is
    contiguous, so the step's ``[:, :S]`` and ``[:, S:]`` views read it as
    they read ``rng.deal``'s.
    """

    def __init__(self, num_pieces: int, device="cuda"):
        self.num_pieces = num_pieces
        self.device = _build.resolve_device(device)
        self.launches = 0

    def plain(self, key: torch.Tensor, counter: Counter, tag: int,
              width: int) -> torch.Tensor:
        return rng.deal(key, counter, tag, width, self.num_pieces)

    def __call__(self, key: torch.Tensor, counter: Counter, tag: int,
                 width: int) -> torch.Tensor:
        n = _check_key(key, self.device)
        per_env = isinstance(counter, torch.Tensor)
        if per_env and (counter.device != self.device or counter.shape != (n,)
                        or counter.dtype != torch.int32):
            raise ValueError(f"counter must be an int or an ({n},) int32 tensor "
                             f"on {self.device}")
        if not 0 < width <= rng.MAX_LANES or not 0 <= tag < rng.MAX_LANES:
            raise ValueError(f"width {width} / tag {tag} out of range")
        if self.device.type == "cpu":
            return self.plain(key, counter, tag, width)
        _launch_ready(self.device, "deal", key, *([counter] if per_env else []))
        out = torch.empty((n, width), dtype=torch.int32, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_deal(
                key.data_ptr(), counter.data_ptr() if per_env else None,
                0 if per_env else counter & rng.MASK32, tag, width, self.num_pieces,
                out.data_ptr(), n, stream,
            )
        _build.check(err, "bp_deal")
        self.launches += 1
        return out


class UniformLegalKernel:
    """``UniformLegalSampler``'s draw and argmax on one device, the card
    unless asked for another.

    ``__call__(key (N,) int64, counter: int, mask (N, A) bool) -> (N,)
    int64``: the ``TAG_POLICY`` draws at ``counter`` and ``uniform_legal``.
    The mask may start at any address (a contiguous view of a larger
    mask, such as ``big[1:]``, too).  For CPU tensors it runs that plain
    version; for CUDA tensors it launches the kernel (``launches`` counts
    those launches) or raises.
    """

    def __init__(self, device="cuda"):
        self.device = _build.resolve_device(device)
        self.launches = 0

    def plain(self, key: torch.Tensor, counter: int, mask: torch.Tensor) -> torch.Tensor:
        return uniform_legal(mask, rng.bits(key, counter, rng.TAG_POLICY, mask.shape[1]))

    def __call__(self, key: torch.Tensor, counter: int, mask: torch.Tensor) -> torch.Tensor:
        n = _check_key(key, self.device)
        _check_counter(counter)
        if mask.device != self.device or mask.dtype != torch.bool or mask.dim() != 2 \
                or mask.shape[0] != n or not 0 < mask.shape[1] <= rng.MAX_LANES:
            raise ValueError(f"mask must be ({n}, A) bool on {self.device}, "
                             f"0 < A <= {rng.MAX_LANES}")
        if self.device.type == "cpu":
            return self.plain(key, counter, mask)
        _launch_ready(self.device, "uniform-legal", key, mask)
        out = torch.empty(n, dtype=torch.int64, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_uniform_legal(
                key.data_ptr(), counter & rng.MASK32, rng.TAG_POLICY, mask.data_ptr(),
                out.data_ptr(), n, mask.shape[1], stream,
            )
        _build.check(err, "bp_uniform_legal")
        self.launches += 1
        return out


# words a B2w lane holds in registers at most, and the kernel's instances
# of its register span (csrc/draws.cu ``kMaxSpan``, ``select_kernel``)
MAX_SPAN = 32
SPANS = (2, 4, 8, 16, MAX_SPAN)


def select_lanes(nwords: int, aligned: bool = True) -> int:
    """Threads an env of B2w (csrc/draws.cu ``select_log_lanes``): the least
    power of two L, at most a warp, whose lanes hold the row's S*H words at
    8 a lane where they load as 16-byte pairs (an even S*H on an
    ``aligned`` base), else 12: 2 on the default preset's 10 words, 4 on
    tenten's 30, woodoku's 27 and 33x9's 33, 8 on big's 48."""
    per_lane = 8 if nwords % 2 == 0 and aligned else 12
    lanes = 1
    while lanes < 32 and per_lane * lanes < nwords:
        lanes *= 2
    return lanes


def select_shape(nwords: int, lanes: int, aligned: bool = True):
    """B2w's launch (csrc/draws.cu ``launch_select``) at ``lanes`` threads an
    env: (vec, span, K): 16-byte loads where S*H is even on a 16-byte
    aligned base (``aligned``), lane q's words [q * span, (q + 1) * span)
    with span = ceil(S*H / L), made even for 16-byte loads, and K, the
    least of ``SPANS`` at least the span (``MAX_SPAN`` beyond: such spans
    are walked K words at a time)."""
    vec = nwords % 2 == 0 and aligned
    span = -(-nwords // lanes)
    span += span & 1 if vec else 0
    return vec, span, next((k for k in SPANS if k >= span), MAX_SPAN)


class WordsSelectKernel:
    """``WordsSampler``'s draw and rank-select on one device, the card
    unless asked for another.

    ``__call__(key (N,) int64, counter: int, words (N, S*H) int64, width)
    -> (N,) int64``: one ``TAG_POLICY`` u32 per env at ``counter``, made a
    uniform by ``uniform_from_bits``, then ``sample_uniform_legal`` over the
    legal row words of a board ``width`` cells wide.  For CPU tensors it
    runs that plain version; for CUDA tensors it launches the kernel
    (``launches`` counts those launches) or raises.
    """

    def __init__(self, device="cuda"):
        self.device = _build.resolve_device(device)
        self.launches = 0

    def plain(self, key: torch.Tensor, counter: int, words: torch.Tensor,
              width: int) -> torch.Tensor:
        u = uniform_from_bits(rng.bits(key, counter, rng.TAG_POLICY, 1)[:, 0])
        return sample_uniform_legal(words, u, width)

    def __call__(self, key: torch.Tensor, counter: int, words: torch.Tensor,
                 width: int) -> torch.Tensor:
        n = _check_key(key, self.device)
        _check_counter(counter)
        if words.device != self.device or words.dtype != torch.int64 \
                or words.dim() != 2 or words.shape[0] != n or words.shape[1] < 1:
            raise ValueError(f"words must be ({n}, S*H) int64 on {self.device}")
        if not 0 < width <= 32:
            raise ValueError(f"width {width}: row words take 1 to 32 cells")
        if self.device.type == "cpu":
            return self.plain(key, counter, words, width)
        _launch_ready(self.device, "words-select", key, words)
        out = torch.empty(n, dtype=torch.int64, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            err = _build.library().bp_words_select(
                key.data_ptr(), counter & rng.MASK32, rng.TAG_POLICY, words.data_ptr(),
                out.data_ptr(), n, words.shape[1], width, stream,
            )
        _build.check(err, "bp_words_select")
        self.launches += 1
        return out
