"""Packed-board kernels: CUDA kernels (``csrc/packed_apply.cu``,
``csrc/packed_mask.cu``, ``csrc/packed_tall.cu``) and their plain versions.

The packed engine holds each board as (N, H) row words: bit w of word r is
cell (r, w).  The JAX package keeps them as uint32; the port keeps the same
integers in int64 on every device (torch's CPU uint32 has no shifts, no
``>`` and no ``~``), and the kernels compute in 32-bit registers.  Every
left shift of the plain versions is masked to 32 bits wherever JAX's uint32
would wrap.

These kernels have no Pallas source: the JAX package runs its packed step
in jnp (``blockpuzzle_tpu/env/core.py``) and its legal words in jnp
(``blockpuzzle_tpu/env/words.py``).

Each wrapper picks its kernel by height: one row a lane where H <= 32
(``csrc/packed_apply.cu``, ``csrc/packed_mask.cu``), the tall kernels
where H <= 128 (``csrc/packed_tall.cu``: the apply a warp a board, the mask
and words a segment of threads an env-slot, eight or four anchor rows a
thread), the general kernels above (the same file: the apply a warp an env
and the mask and words a warp an env-slot, each walking the board in
windows of rows): the JAX
engine takes packed state on any board of at most 32 columns, whatever
its height.

* ``PackedApplyKernel``: the chosen action's footprint words
  (``_cover_words``), the overlap test, the masked place and the
  simultaneous clear of every full row, column and region with k counted
  (``_clear_scan_packed``), as the packed branch of ``step`` does.  An
  illegal action is a strict no-op with k = 0.
* ``PackedMaskKernel``: the hand mask from the words
  (``_bitboard_mask_from_words``): anchor (r, c) of slot s is legal iff the
  slot holds a piece, ``c + piece_w <= W`` and, for every footprint word k,
  ``wks_k(r) & ((prow[pid][k] << c) & cmask[c]) == 0``, where ``wks_k(r)``
  ORs board rows ``r + k*fpw + j`` into field j and rows past the bottom
  read as full.  Its second entry, ``words``, gives the same legality as
  (N, S*H) row words (``blockpuzzle_tpu/env/words.py`` ``legal_words``).

``bitboard_tables`` builds the footprint tables of both, as the JAX engine
builds them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels import _build

U32 = 0xFFFFFFFF
# board rows the kernels take: one lane per row, a warp's 32 at most
MAX_ROWS = 32
# rows and columns of the largest piece the bit-row u8 mask and legality
# take (their unrolled loops; csrc/mask.cu, csrc/legality.cu kMaxPiece)
MAX_PIECE = 8
# cells of the widest row the wide u8 mask and clear take: four 32-bit
# words a lane
MAX_WIDE = 128
# cells of the widest row a segment of the xwide u8 kernels holds: ceil(W /
# 32) lanes a board, a lane a word of every row, at most a warp
XWIDE_SEGMENT = 1024
# cells of the widest row the xwide u8 mask, clear, apply and legality
# take: above ``XWIDE_SEGMENT`` one board (or env-slot) a warp, lane l
# holding words l + 32 j of every row, up to four (``csrc/mask.cu``
# ``mask_xwide_kernel``'s and ``csrc/clear.cu`` ``clear_xwide_kernel``'s NJ)
MAX_XWIDE = 4096
# warps a block of the xwide mask and clear: 4 beat 1, 2, 8, 12 and 16 in
# turns on an H100 on most boards of 129 to 1024 cells a row (PERF.md §6),
# their blocks' barriers holding fewer warps waiting than 16 do
XWIDE_WARPS = 4
# warps a block of the xwide apply on boards of more than one window of
# rows (``xwide_windows``): one, whose three barriers (the boards staged,
# the covers ORed over them, the rows cleared) hold no other warp waiting;
# in turns on an H100 it was within 0.6% of 2, 4 and 8 on 40x136 and
# 2.2-8.4% faster than 4 on 33x129, 36x135 r3 and 66x130 (PERF.md §6)
XWIDE_APPLY_WARPS = 1
# rows of the tallest board the tall kernels take (the packed apply, mask
# and words, the u8 mask and clear): four rows a lane, one warp a board;
# taller boards take the general kernels
MAX_TALL = 128
# shared memory a block may opt in to on the H100
SMEM_OPT_IN = 227 * 1024
# anchor rows a thread of the tall packed words entry and of the mask
# (their kernel's ``anchor_rows``); threads a block of the words entry: at
# least ``ANCHOR_THREADS`` (``anchor_launch_shape``; the mask runs the same
# env-slots a block on about half as many), at most ``MAX_ANCHOR_THREADS``
ANCHOR_ROWS = 4
MASK_ANCHOR_ROWS = 8
ANCHOR_THREADS = 256
MAX_ANCHOR_THREADS = 1024
# where the words entry of a board of at most 32 rows takes the tall words
# kernel (``words_kernel_kind``): from WORDS_TALL_FROM rows, and where a
# warp of the bit-row kernel leaves WORDS_TALL_IDLE or more of its lanes
# without a row.  Timed in turns on an H100 (PERF.md §6) the tall kernel
# beat the bit-row one by 1.03-1.39x on 9 rows (5 lanes idle), 16 and 24,
# and lost to it by 1.13-1.49x on 10 (2 idle)
WORDS_TALL_FROM = 16
WORDS_TALL_IDLE = 5


def segments_per_warp(height: int) -> int:
    """Envs (apply, clear) or env-slots (mask) per warp: each takes one
    segment of H lanes, a lane per board row."""
    if not 1 <= height <= MAX_ROWS:
        raise ValueError(f"the packed kernels take 1 <= H <= {MAX_ROWS}")
    return 32 // height


def row_launch_shape(cfg: EnvConfig):
    """(segments a warp, warps a block) of ``cfg``'s row-word kernels (the
    packed ones and the bit-row u8 mask, clear and apply), or None where a row
    does not fit a lane's 32-bit word or the board has more than 32 rows
    (the packed plain versions still run on the CPU; the u8 wrappers pick
    their wide or general kernels); computed once per wrapper, off the
    step's host path."""
    if cfg.height > MAX_ROWS or cfg.width > 32:
        return None
    return segments_per_warp(cfg.height), mask_block_warps(cfg.height, cfg.width)


def wide_launch_shape(cfg: EnvConfig):
    """(segments a warp, warps a block) of the wide u8 mask and clear,
    which hold a row as ceil(W / 32) words, for boards of at most 32 rows
    of 32 < W <= ``MAX_WIDE`` cells; None for any other board.  Computed
    once per wrapper, as ``row_launch_shape``."""
    if cfg.height > MAX_ROWS or not 32 < cfg.width <= MAX_WIDE:
        return None
    return segments_per_warp(cfg.height), mask_block_warps(cfg.height, cfg.width)


def tall_launch_shape(cfg: EnvConfig):
    """(boards a warp, warps a block) of the tall kernels, for boards of
    32 < H <= ``MAX_TALL`` rows of at most ``MAX_WIDE`` cells; None for any
    other board.  A warp holds one board (or env-slot) at a time and takes
    its turns through ``per_warp`` of them, all staged at once: 16 warps and
    the most turns, 4, 2 or 1, whose shared memory fits a block that does
    not opt in to more (48 KB: 33x9 takes 4, so that 64 boards a block and
    256 an SM are in flight, not 64); a board too large for that takes one
    turn and ``tall_block_warps``.  Computed once per wrapper, as
    ``row_launch_shape``."""
    if not MAX_ROWS < cfg.height <= MAX_TALL or cfg.width > MAX_WIDE:
        return None
    return _turns_shape(cfg)


def anchor_launch_shape(cfg: EnvConfig, words: bool = False):
    """(env-slots a block E,) of the tall packed mask and its words entry,
    for packed boards (W <= 32) of 32 < H <= ``MAX_TALL`` rows (``words``:
    the words entry's, on boards of 1 to ``MAX_TALL`` rows); None for any
    other board.  A segment of C = ceil(H / K) threads takes an
    env-slot, thread c its rows c + C j (K = ``ANCHOR_ROWS`` for the words
    entry, ``MASK_ANCHOR_ROWS`` for the mask); E is the fewest env-slots,
    at least ``ANCHOR_THREADS`` threads of the words entry, for which E * H
    * W is a multiple of 16, so that every block's span of the mask starts
    on a 16-byte boundary.  Computed once per wrapper, as
    ``row_launch_shape``."""
    low = 0 if words else MAX_ROWS
    if not low < cfg.height <= MAX_TALL or cfg.width > 32:
        return None
    seg = -(-cfg.height // ANCHOR_ROWS)
    step = 16 // int(np.gcd(cfg.height * cfg.width, 16))
    envs = -(-ANCHOR_THREADS // seg)
    return (-(-envs // step) * step,)


def words_kernel_kind(cfg: EnvConfig) -> str:
    """The kernel kind of the packed words entry on ``cfg``: the packed
    mask's (``packed_kind``), but ``"tall"`` on a board of at most 32 rows
    of ``WORDS_TALL_FROM`` rows or more, or where the bit-row warp leaves
    ``WORDS_TALL_IDLE`` lanes idle (32 mod H), and ``"general"`` where a
    footprint spans more than 32 rows above 32 rows (the packed mask's
    kind on a board too wide for packed words, where no words kernel
    runs)."""
    kind = packed_kind(cfg)
    if cfg.width > 32:
        return kind
    reach = bitboard_tables(cfg)
    if kind == "tall" and reach.nwords * reach.fpw > 32:
        return "general"
    if kind == "rows" and reach.nwords * reach.fpw <= 32 and (
            cfg.height >= WORDS_TALL_FROM or 32 % cfg.height >= WORDS_TALL_IDLE):
        return "tall"
    return kind


def deep_launch_shape(cfg: EnvConfig):
    """(env-slots or envs a warp, warps a block) of the deep u8 mask and
    clear, which walk a board of more than ``MAX_TALL`` rows of at most
    ``MAX_WIDE`` cells in windows of 32 rows, a warp an env-slot (mask) or
    env (clear; its block's shared memory, the cleared rows and the envs'
    boards, is at most the mask's): ``tall_launch_shape``'s choice,
    down to fewer than 4 warps (the most that fit) where a block of 4 does
    not fit what a block may opt in to; None for any other board and where
    not even one warp's board fits (the general kernel takes those).
    Computed once per wrapper, as ``row_launch_shape``."""
    if cfg.height <= MAX_TALL or cfg.width > MAX_WIDE:
        return None
    return _turns_shape(cfg)


def xwide_launch_shape(cfg: EnvConfig, smem_bytes=None, most: int = XWIDE_WARPS):
    """(segments a warp, warps a block) of the xwide u8 mask and clear,
    which give an env-slot (mask) or env (clear) a segment of NW =
    ceil(W / 32) lanes, lane w holding word w of every row, for boards of
    ``MAX_WIDE`` < W <= ``XWIDE_SEGMENT`` cells a row and any height: 32 // NW
    segments a warp (6 on 8x136) and the most warps, at most ``most``
    (``XWIDE_WARPS``), whose block fits what a block may opt in to
    (``smem_bytes``, ``xwide_smem_bytes`` by default; the apply's is
    ``xwide_apply_smem_bytes``; on boards of at most 32 rows 4 warps take at
    most 36 KB, under the 48 KB a launch gets without opting in) and stages
    and stores fewer than 2^21 bytes (``csrc/bit_rows.cuh`` ``small_div``).
    None for any other board, and where not even one warp fits (the
    general kernels take those).  Computed once per wrapper, as
    ``row_launch_shape``."""
    if not MAX_WIDE < cfg.width <= XWIDE_SEGMENT:
        return None
    smem_bytes = smem_bytes or xwide_smem_bytes
    per_warp = 32 // -(-cfg.width // 32)
    for warps in range(most, 0, -1):
        per_block = per_warp * warps
        if (smem_bytes(cfg, per_block) <= SMEM_OPT_IN
                and xwide_staged_envs(cfg, per_block) * cfg.num_cells < 1 << 21):
            return per_warp, warps
    return None


def xwide_staged_envs(cfg: EnvConfig, per_block: int) -> int:
    """The most envs a block of ``per_block`` env-slots of the xwide mask
    reads or stores (a block of the clear stores ``per_block`` envs): at
    most (E + S - 1) / S + 1 envs read where S > 1, E where S = 1."""
    s = cfg.queue_size
    return per_block if s == 1 else max(per_block, (per_block + s - 1) // s + 1)


def xwide_smem_bytes(cfg: EnvConfig, per_block: int) -> int:
    """Shared memory of a block of the xwide u8 mask or clear, the larger
    of the two: the mask's ``per_block`` env-slots' legal rows of NW words,
    then the rows of the envs they read (``bp_mask_xwide``), one array where
    S = 1 (the legal rows written over the board rows they were read from);
    the clear's envs' rows, cleared in place (``bp_clear_xwide``).  No board's bytes are staged (``csrc/bit_rows.cuh``
    ``stage_words``)."""
    s, rows = cfg.queue_size, cfg.height * -(-cfg.width // 32)
    mask = per_block if s == 1 else (per_block + s - 1) // s + 1 + per_block
    return 4 * max(mask, per_block) * rows


def xwide_windows(cfg: EnvConfig) -> bool:
    """Whether the xwide clear and apply walk ``cfg``'s rows in windows of
    32 (32 - 32 mod rs with regions of size rs): boards taller than one
    window (``csrc/clear.cu`` ``xwide``)."""
    return cfg.height > (32 - 32 % cfg.region_size if cfg.region_clear else 32)


def xwide_apply_smem_bytes(cfg: EnvConfig, per_block: int) -> int:
    """Shared memory of a block of the xwide u8 apply (``bp_apply_xwide``):
    on a board of one window its envs' board rows of NW words and as many
    cover rows beside them; on a taller board (``xwide_windows``) their
    placed rows, each board's row words with its cover ORed over them as
    they are staged and then cleared in place, and a word an env marking
    the illegal ones (an overlap found by the cover's atomics, or an
    invalid action), whose input the store copies back."""
    rows = per_block * cfg.height * -(-cfg.width // 32)
    return 4 * (rows + per_block) if xwide_windows(cfg) else 8 * rows


def u8_launch_shape(cfg: EnvConfig):
    """The launch shape of the u8 mask kernel ``cfg``'s board takes (where
    no piece spans more than ``MAX_PIECE`` rows or columns; the clear's is
    ``clear_launch_shape``): the bit-row, wide, tall, deep or xwide kernels'
    shape (above ``XWIDE_SEGMENT`` cells a row the xwide kernel's long-row
    shape, one env-slot a warp, ``xwide_long_launch_shape``), or None where
    the general kernel runs (rows of more than ``MAX_XWIDE`` cells, or a
    deep or xwide board whose one-warp block does not fit)."""
    if long_rows(cfg):
        return xwide_long_launch_shape(cfg, xwide_smem_bytes, XWIDE_WARPS, xwide_staged_envs)
    return (row_launch_shape(cfg) or wide_launch_shape(cfg) or tall_launch_shape(cfg)
            or deep_launch_shape(cfg) or xwide_launch_shape(cfg))


def long_rows(cfg: EnvConfig) -> bool:
    """Whether ``cfg``'s rows pass ``XWIDE_SEGMENT`` cells: where the
    xwide kernels hold a board (or env-slot) in one warp, lane l holding
    words l + 32 j (their long-row instances, ``xwide_long_launch_shape``)."""
    return cfg.width > XWIDE_SEGMENT


def xwide_long_launch_shape(cfg: EnvConfig, smem_bytes, most: int, staged):
    """(1, warps a block) of the xwide kernels on rows of
    ``XWIDE_SEGMENT`` < W <= ``MAX_XWIDE`` cells, any height: one env (the
    clear and apply) or env-slot (the mask and legality) a warp, lane l
    holding words l + 32 j of every row (NJ = ceil(W / 1024) slots a lane),
    and the most warps, at most ``most``, whose block fits what a block may
    opt in to (``smem_bytes``: the mask's ``xwide_smem_bytes``, the clear's
    ``xwide_clear_smem_bytes``, the apply's ``xwide_apply_smem_bytes``) and
    stages and stores fewer than 2^21 bytes (``staged``: the envs a block of
    that many warps stages or stores, the mask's ``xwide_staged_envs``, the
    clear's and apply's ``xwide_warp_envs``).  None for any other board,
    and where not even one warp fits (the general kernels take those).
    Computed once per wrapper, as ``row_launch_shape``."""
    if not XWIDE_SEGMENT < cfg.width <= MAX_XWIDE:
        return None
    for warps in range(most, 0, -1):
        if smem_bytes(cfg, warps) <= SMEM_OPT_IN and staged(cfg, warps) * cfg.num_cells < 1 << 21:
            return 1, warps
    return None


def xwide_warp_envs(cfg: EnvConfig, warps: int) -> int:
    """The envs a block of ``warps`` warps of the long-row xwide clear or
    apply stages and stores: one a warp."""
    return warps


def xwide_clear_smem_bytes(cfg: EnvConfig, per_block: int) -> int:
    """Shared memory of a block of the xwide u8 clear alone: its envs' rows
    of NW words, cleared in place (``bp_clear_xwide``)."""
    return 4 * per_block * cfg.height * -(-cfg.width // 32)


def clear_launch_shape(cfg: EnvConfig):
    """(envs a warp, warps a block) of the u8 clear on ``cfg``, or None
    where its general kernel runs: the mask's shape (``u8_launch_shape``)
    up to ``XWIDE_SEGMENT`` cells a row, and above, up to ``MAX_XWIDE``,
    the long-row xwide shape with the clear's own shared memory and a
    block's envs, one a warp (``XWIDE_WARPS`` warps a block where they
    fit).  Computed once per wrapper, as ``row_launch_shape``."""
    if long_rows(cfg):
        return xwide_long_launch_shape(cfg, xwide_clear_smem_bytes, XWIDE_WARPS,
                                       xwide_warp_envs)
    return u8_launch_shape(cfg)


def apply_launch_shape(cfg: EnvConfig):
    """(envs a warp, warps a block) of the u8 apply on ``cfg``, or None where
    its general kernel runs: the bit-row kernels' shape where H <= 32 and
    W <= 32, the wide ones' where H <= 32 and 32 < W <= ``MAX_WIDE`` (a
    block's two spans, under 2^17 bytes, always fit), the xwide ones' where
    ``MAX_WIDE`` < W <= ``MAX_XWIDE``, at any height, with the
    apply's own shared memory (``xwide_apply_smem_bytes``): the clear's
    shape on a board of one window (its block's two arrays of row words, at
    most 32 KB up to ``XWIDE_SEGMENT`` cells a row, always fit),
    ``XWIDE_APPLY_WARPS`` warps a block on a taller board where one warp
    fits (above ``XWIDE_SEGMENT`` cells one env a warp,
    ``xwide_long_launch_shape``); and on taller boards of at most ``MAX_WIDE`` cells
    a row ``_turns_shape`` with the apply's own shared memory
    (``apply_smem_bytes``: its block stages two spans where the mask stages
    one), so fewer turns or warps where the mask's would not fit.  Computed
    once per wrapper, as ``row_launch_shape``."""
    if cfg.width > MAX_WIDE:
        most = XWIDE_APPLY_WARPS if xwide_windows(cfg) else XWIDE_WARPS
        if long_rows(cfg):
            return xwide_long_launch_shape(cfg, xwide_apply_smem_bytes, most, xwide_warp_envs)
        return xwide_launch_shape(cfg, xwide_apply_smem_bytes, most)
    if cfg.height <= MAX_ROWS:
        return row_launch_shape(cfg) or wide_launch_shape(cfg)
    return _turns_shape(cfg, apply_smem_bytes)


def _turns_shape(cfg: EnvConfig, smem_bytes=None):
    """The tall and deep kernels' (turns a warp, warps a block): 16 warps and
    the most turns, 4, 2 or 1, whose shared memory (``smem_bytes``, the
    masks' ``tall_smem_bytes`` by default) fits 48 KB, else one turn and
    ``tall_block_warps``, or the most warps below 4 that fit
    ``SMEM_OPT_IN``; None where one warp does not."""
    smem_bytes = smem_bytes or tall_smem_bytes
    for per_warp in (4, 2, 1):
        if smem_bytes(cfg, 16 * per_warp) <= 48 * 1024:
            return per_warp, 16
    warps = tall_block_warps(cfg, smem_bytes)
    while warps > 0 and smem_bytes(cfg, warps) > SMEM_OPT_IN:
        warps -= 1
    return (1, warps) if warps else None


def tall_smem_bytes(cfg: EnvConfig, per_block: int) -> int:
    """Shared memory of a block of the tall u8 mask (the larger of the two
    that share the launch shape; the deep mask's alike): ``per_block``
    env-slots' legal rows of ceil(W / 32) words, then the span of the envs
    they read, as ``csrc/bit_rows.cuh`` ``smem_bytes`` lays them out."""
    hw, s = cfg.num_cells, cfg.queue_size
    nrows = per_block * cfg.height * -(-cfg.width // 32)
    span = ((per_block + s - 1) // s + 1) * hw
    return (4 * nrows + 15) // 16 * 16 + span + 32


def apply_smem_bytes(cfg: EnvConfig, per_block: int) -> int:
    """Shared memory of a block of the wide, tall and deep u8 apply
    (``csrc/clear.cu`` ``launch``): ``per_block`` envs' output rows of
    ceil(W / 32) words, then the span of their boards and the span of their
    covers, as ``csrc/bit_rows.cuh`` ``smem_bytes`` lays out two spans."""
    span = per_block * cfg.num_cells
    nrows = per_block * cfg.height * -(-cfg.width // 32)
    return (4 * nrows + 15) // 16 * 16 + (span + 32 + 15) // 16 * 16 + span + 32


def tall_block_warps(cfg: EnvConfig, smem_bytes=None) -> int:
    """Warps a block of the tall kernels where a block of 16 does not fit
    48 KB, one board (or env-slot) each: the fewest, at least 4, for which
    the block's output (warps * H * W bytes) is a multiple of 16 bytes, so
    that every block's span starts on a 16-byte boundary, and whose shared
    memory (``smem_bytes``, ``tall_smem_bytes`` by default) fits what a
    block may opt in to; 4 where none does (the store takes a span at any
    offset)."""
    hw, smem_bytes = cfg.num_cells, smem_bytes or tall_smem_bytes
    return next((w for w in range(4, 17)
                 if w * hw % 16 == 0 and smem_bytes(cfg, w) <= SMEM_OPT_IN), 4)


def mask_block_warps(height: int, width: int) -> int:
    """Warps per block of the mask kernels (and the bit-row clear and
    apply): the
    fewest, and at least 4, for which the block's output (warps * 32 // H
    env-slots of H*W bytes) is a multiple of 16 bytes, so that every
    block's span starts on a 16-byte boundary.  16 warps always are."""
    per_warp = segments_per_warp(height)
    return next(w for w in range(4, 17) if w * per_warp * height * width % 16 == 0)


@dataclasses.dataclass(frozen=True)
class BitboardTables:
    """Host tables of the bitboard formulation (``core.py`` ``__init__``).

    fpw: row fields per 32-bit word (``max(1, 32 // W)``).
    nwords: words per piece footprint (``ceil(max_h / fpw)``).
    prow: (P, nwords) footprint words; word k holds piece rows
      ``k*fpw .. k*fpw + fpw - 1``, each as a W-bit field.
    cmask: (W,) per-anchor-column masks keeping the bits >= c of every
      field, which strips what a left shift by c spills into the next field.
    piece_w: (P,) piece widths.
    """

    fpw: int
    nwords: int
    prow: np.ndarray
    cmask: np.ndarray
    piece_w: np.ndarray


def bitboard_tables(cfg: EnvConfig) -> BitboardTables:
    if cfg.width > 32:
        raise ValueError("packed boards need width <= 32")
    t = rules.tables_for(cfg)
    w = cfg.width
    fpw = max(1, 32 // w)
    nwords = -(-t.max_h // fpw)
    prow = (
        t.pieces.astype(np.uint64) * (1 << np.arange(t.max_w, dtype=np.uint64))
    ).sum(axis=2)                                        # (P, max_h) row masks
    packed = np.zeros((t.num_pieces, nwords), dtype=np.uint64)
    for i in range(t.max_h):
        packed[:, i // fpw] |= prow[:, i] << np.uint64((i % fpw) * w)
    field = np.uint64((1 << w) - 1)
    cmask = np.zeros(w, dtype=np.uint64)
    for c in range(w):
        keep = field & ~np.uint64((1 << c) - 1)
        for j in range(fpw):
            cmask[c] |= keep << np.uint64(j * w)
    return BitboardTables(
        fpw=fpw, nwords=nwords, prow=packed.astype(np.uint32),
        cmask=cmask.astype(np.uint32), piece_w=t.piece_w.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def pack_words(cells: torch.Tensor) -> torch.Tensor:
    """(N, H, W) 0/1 cells -> (N, H) int64 row words."""
    w = cells.shape[-1]
    pow2 = torch.ones(w, dtype=torch.int64, device=cells.device) << torch.arange(
        w, device=cells.device)
    return (cells.to(torch.int64) * pow2).sum(dim=-1)


def unpack_words(words: torch.Tensor, width: int) -> torch.Tensor:
    """(N, H) int64 row words -> (N, H, W) uint8 cells."""
    shift = torch.arange(width, dtype=torch.int64, device=words.device)
    return ((words[:, :, None] >> shift) & 1).to(torch.uint8)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 value in ``[0, 2**32)``, any shape: the SWAR
    count (pairs, nibbles, bytes, then one multiply sums the four bytes
    into the top one; the product stays below 2**57)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


# ---------------------------------------------------------------------------
# chosen-action apply
# ---------------------------------------------------------------------------


def cover_words_plain(
    attrs: torch.Tensor, r: torch.Tensor, c: torch.Tensor, height: int
) -> torch.Tensor:
    """(N, H) int64 footprint words of the chosen action (``_cover_words``):
    each of the <= 2 rectangles of the attrs row ``[h, w, cells, dr1, dc1,
    h1, w1, dr2, dc2, h2, w2]`` is a shifted ``2^rw - 1`` row mask on its
    rows.  A zero rectangle gives zero words."""
    a = attrs.to(torch.int64)
    r, c = r.to(torch.int64)[:, None], c.to(torch.int64)[:, None]
    rows = torch.arange(height, dtype=torch.int64, device=attrs.device)[None, :]
    cover = torch.zeros((attrs.shape[0], height), dtype=torch.int64,
                        device=attrs.device)
    for j in range(2):
        dr, dc, rh, rw = (a[:, 3 + 4 * j + i, None] for i in range(4))
        r0 = r + dr
        rowmask = (((torch.ones_like(rw) << rw) - 1) << (c + dc)) & U32
        inrows = (rows >= r0) & (rows < r0 + rh)
        cover = cover | torch.where(inrows, rowmask, 0)
    return cover


def clear_packed_plain(
    words: torch.Tensor, cfg: EnvConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simultaneous clear on (N, H) int64 words (``_clear_scan_packed``):
    rows equal to ``2^W - 1``, columns set in the AND of all rows (counted
    by popcount), and, with ``region_clear``, every full aligned
    region; all are found on the input, then cleared in one AND-NOT.
    Returns (cleared (N, H) int64, k (N,) int32)."""
    n, h = words.shape
    w = cfg.width
    full = (1 << w) - 1
    full_row = words == full
    colbits = words[:, 0]
    for i in range(1, h):
        colbits = colbits & words[:, i]
    k = full_row.sum(dim=1) + popcount32(colbits)
    clearbits = torch.where(full_row, full, 0) | colbits[:, None]
    if cfg.region_clear:
        rs = cfg.region_size
        bands = []
        for a in range(h // rs):
            band = words[:, a * rs]
            for i in range(1, rs):
                band = band & words[:, a * rs + i]
            regrow = torch.zeros_like(band)
            for b in range(w // rs):
                tile = ((1 << rs) - 1) << (b * rs)
                fullt = (band & tile) == tile
                regrow = regrow | torch.where(fullt, tile, 0)
                k = k + fullt
            bands.append(regrow[:, None].expand(n, rs))
        clearbits = clearbits | torch.cat(bands, dim=1)
    return words & ~clearbits, k.to(torch.int32)


def packed_apply_plain(
    words: torch.Tensor,
    attrs: torch.Tensor,
    r: torch.Tensor,
    c: torch.Tensor,
    valid: torch.Tensor,
    cfg: EnvConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version: the packed branch of the JAX ``step``, in its
    order.  Returns (words_next, k (N,) int32, legal (N,) bool)."""
    cover = cover_words_plain(attrs, r, c, cfg.height)
    overlap = ((words & cover) != 0).any(dim=1)
    legal = valid & ~overlap
    placed = torch.where(legal[:, None], words | cover, words)
    cleared, k = clear_packed_plain(placed, cfg)
    k = torch.where(legal, k, 0).to(torch.int32)
    return torch.where(legal[:, None], cleared, words), k, legal


def packed_kind(cfg: EnvConfig) -> str:
    """The packed kernels a board takes: ``"rows"`` (a lane a row, H <= 32),
    ``"tall"`` (a warp a board, H <= ``MAX_TALL``) or ``"general"``."""
    return ("rows" if cfg.height <= MAX_ROWS else
            "tall" if cfg.height <= MAX_TALL else "general")


# kernel kind -> the suffix of its name (``mask_tall``, ``packed_apply``);
# ``xwide_long``: the xwide kernels' instances on rows of more than
# ``XWIDE_SEGMENT`` cells (``u8_instance``)
SUFFIX = {"rows": "", "wide": "_wide", "tall": "_tall", "deep": "_deep",
          "xwide": "_xwide", "xwide_long": "_xwide_long", "general": "_general"}


def u8_kind(cfg: EnvConfig, shape) -> str:
    """The kind of the u8 kernel a wrapper with launch shape ``shape`` (None:
    the general kernel) picks on ``cfg``: ``"rows"``, ``"wide"``, ``"tall"``,
    ``"deep"`` (above ``MAX_TALL`` rows), ``"xwide"`` (rows of more than
    ``MAX_WIDE`` cells) or ``"general"``: the mask, the clear, the apply
    and the all-pieces legality alike."""
    if shape is None:
        return "general"
    if cfg.width > MAX_WIDE:
        return "xwide"
    if cfg.height > MAX_TALL:
        return "deep"
    if cfg.height > MAX_ROWS:
        return "tall"
    return "wide" if cfg.width > 32 else "rows"


def u8_instance(cfg: EnvConfig, kind: str) -> str:
    """The instance of the u8 mask, clear, apply or legality of ``kind``
    on ``cfg``, which names the wrapper's kernel and counts its launches:
    ``"xwide_long"`` for the xwide kernel on rows of more than
    ``XWIDE_SEGMENT`` cells (one env or env-slot a warp, NJ > 1 words a
    lane; ``xwide_long_launches``), else ``kind``."""
    return "xwide_long" if kind == "xwide" and long_rows(cfg) else kind


def count_launch(kernel, prefix: str = "", kind: str = "") -> None:
    """One more launch on the counter of the kernel the wrapper ``kernel``
    picked (``kind``, its ``kind`` unless given): ``<prefix>launches`` for
    the bit-row kernel, else ``<prefix><kind>_launches``."""
    kind = kind or kernel.kind
    attr = prefix + ("launches" if kind == "rows" else f"{kind}_launches")
    setattr(kernel, attr, getattr(kernel, attr) + 1)


class PackedApplyKernel:
    """Config-bound packed collision + place + clear on one device, the
    card unless asked for another.

    ``__call__(words (N, H) int64, attrs (N, 11) int32, r (N,) int32,
    c (N,) int32, valid (N,) bool) -> (words_next, k, legal)``.  For CPU
    tensors it runs ``packed_apply_plain``; for CUDA tensors it launches a
    kernel or raises.  The kernel is picked here, by height (``kind``,
    ``packed_kind``): the bit-row kernel where H <= 32 (``launches`` counts
    its launches; ``shape`` is its launch shape), the tall kernel where
    H <= 128 (``tall_launches``), the general kernel above
    (``general_launches``: a warp an env over windows of 32 rows, or of
    32 - 32 mod rs with regions of size rs, its placed rows kept in shared
    memory where a warp's 4 H bytes fit, else read again).  ``name`` is the
    picked kernel's.
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        if cfg.width > 32:
            raise ValueError("packed boards need width <= 32")
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.launches = self.tall_launches = self.general_launches = 0
        self.shape = row_launch_shape(cfg)
        self.kind = packed_kind(cfg)
        self.name = "packed_apply" + SUFFIX[self.kind]

    def plain(self, words, attrs, r, c, valid):
        return packed_apply_plain(words, attrs, r, c, valid, self.cfg)

    def __call__(
        self,
        words: torch.Tensor,
        attrs: torch.Tensor,
        r: torch.Tensor,
        c: torch.Tensor,
        valid: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        n = words.shape[0]
        for x in (words, attrs, r, c, valid):
            if x.device != self.device:
                raise ValueError(
                    f"tensor on {x.device}, kernel tables on {self.device}"
                )
        if words.shape != (n, cfg.height) or words.dtype != torch.int64:
            raise ValueError(f"words must be (N, {cfg.height}) int64")
        if attrs.shape != (n, 11) or attrs.dtype != torch.int32:
            raise ValueError("attrs must be (N, 11) int32")
        for x in (r, c):
            if x.shape != (n,) or x.dtype != torch.int32:
                raise ValueError("r and c must be (N,) int32")
        if valid.shape != (n,) or valid.dtype != torch.bool:
            raise ValueError("valid must be (N,) bool")
        if self.device.type == "cpu":
            return self.plain(words, attrs, r, c, valid)
        if self.device.type != "cuda":
            raise ValueError(f"no packed apply kernel for device {self.device}")
        if not all(x.is_contiguous() for x in (words, attrs, r, c, valid)):
            raise ValueError("words, attrs, r, c and valid must be contiguous")
        words_next = torch.empty_like(words)
        k = torch.empty(n, dtype=torch.int32, device=self.device)
        legal = torch.empty(n, dtype=torch.bool, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        region = cfg.region_size if cfg.region_clear else 0
        args = (words.data_ptr(), attrs.data_ptr(), r.data_ptr(), c.data_ptr(),
                valid.data_ptr(), words_next.data_ptr(), k.data_ptr(),
                legal.data_ptr(), n, cfg.height, cfg.width, region)
        shape = self.shape[:1] if self.kind == "rows" else ()  # per_warp
        entry = "bp_" + self.name
        with torch.cuda.device(self.device):
            err = getattr(_build.library(), entry)(*args, *shape, stream)
        _build.check(err, entry)
        count_launch(self)
        return words_next, k, legal


# ---------------------------------------------------------------------------
# hand mask
# ---------------------------------------------------------------------------


def _legal_slots_plain(
    words: torch.Tensor,
    queue: torch.Tensor,
    prow: torch.Tensor,
    piece_w: torch.Tensor,
    cmask: torch.Tensor,
    cfg: EnvConfig,
    max_h: int,
):
    """Each hand slot's (N, H, W) bool anchor legality
    (``_bitboard_legal_slots``), in slot order: the plain versions of the
    bool mask and of the legal words both read it.

    ``prow``: (P + 1, nwords) int64 footprint words and ``piece_w``:
    (P + 1,) int64 widths, each with a zero row for the empty sentinel P;
    ``cmask``: (W,) int64.  Ids outside ``[0, P)`` read as empty slots."""
    n, h = words.shape
    w = cfg.width
    fpw = max(1, 32 // w)
    num_pieces = prow.shape[0] - 1
    padded = torch.cat(
        [words, words.new_full((n, max_h - 1), (1 << w) - 1)], dim=1)
    wks = []
    for k in range(prow.shape[1]):
        wk = torch.zeros_like(words)
        for j in range(fpw):
            i = k * fpw + j
            if i >= max_h:
                break
            wk = wk | ((padded[:, i : i + h] << (j * w)) & U32)
        wks.append(wk)
    cols = torch.arange(w, dtype=torch.int64, device=words.device)
    for s in range(queue.shape[1]):
        pid = queue[:, s]
        idx = torch.where((pid >= 0) & (pid < num_pieces), pid, num_pieces).to(
            torch.int64)
        pr, pw = prow[idx], piece_w[idx]
        acc = torch.zeros((n, h, w), dtype=torch.int64, device=words.device)
        for k, wk in enumerate(wks):
            shifted = ((pr[:, k : k + 1] << cols) & U32) & cmask       # (N, W)
            acc = acc | (wk[:, :, None] & shifted[:, None, :])
        ok_col = cols + pw[:, None] <= w                              # (N, W)
        yield (acc == 0) & ok_col[:, None, :] & (idx < num_pieces)[:, None, None]


def packed_mask_plain(words, queue, prow, piece_w, cmask, cfg: EnvConfig,
                      max_h: int) -> torch.Tensor:
    """Plain torch version (``_bitboard_legal_slots`` with its mask);
    returns (N, S*HW) bool, slot-major then row-major anchor.  Arguments as
    ``_legal_slots_plain``'s."""
    n = words.shape[0]
    return torch.cat(
        [legal.reshape(n, -1) for legal in _legal_slots_plain(
            words, queue, prow, piece_w, cmask, cfg, max_h)], dim=1)


def packed_legal_words_plain(words, queue, prow, piece_w, cmask,
                             cfg: EnvConfig, max_h: int) -> torch.Tensor:
    """Plain torch version of the words entry (``env/words.py``
    ``legal_words``): (N, S*H) int64 row words, bit c of word ``s*H + r``
    set iff anchor (r, c) of slot s is legal, i.e. the bool mask packed a
    row to a word.  Arguments as ``_legal_slots_plain``'s."""
    return torch.cat(
        [pack_words(legal) for legal in _legal_slots_plain(
            words, queue, prow, piece_w, cmask, cfg, max_h)], dim=1)


class PackedMaskKernel:
    """Config-bound packed hand mask on one device, the card unless asked
    for another, with two entries over the same legality
    (``csrc/packed_mask.cu``):

    ``__call__(words (N, H) int64, queue (N, S) int32) -> (N, S*HW) bool``,
    in the order of ``MaskKernel``'s output, and ``words(words, queue) ->
    (N, S*H) int64`` legal row words (``env/words.py`` ``legal_words``).
    For CPU tensors each runs its plain version (``packed_mask_plain``,
    ``packed_legal_words_plain``); for CUDA tensors it launches its kernel
    or raises.  Each entry's kernel is picked here, by height (``kind``, as
    ``PackedApplyKernel``'s; the tall kernels also need the footprint words'
    fields, ``nwords * fpw``, to span at most 32 rows, and every shipped
    piece set's do): the bit-row kernels where H <= 32 (``launches``
    counts the mask kernel's launches, ``words_launches`` the words
    kernel's, which unrolls its band loops on the default and tenten
    footprint;
    the words entry takes the tall kernel where ``words_kernel_kind`` says
    so, from 16 rows and on 9: ``words_kind``, ``words_shape``), the tall
    ones where H <= 128 (``tall_launches``,
    ``words_tall_launches``; both entries one kernel, a segment of threads
    an env-slot, ``MASK_ANCHOR_ROWS`` or ``ANCHOR_ROWS`` anchor rows a
    thread, the boards of a block's env-slots staged in shared memory,
    ``anchor_launch_shape``),
    the general ones elsewhere
    (``general_launches``, ``words_general_launches``; the general mask
    and words entries each a warp an env-slot over windows of 32 rows, or a
    thread an anchor row where the footprint words' fields span more than
    32 rows, which the C entries pick).  ``shape`` is the
    picked kernels' launch shape (None for the general ones); ``name`` and
    ``words_name`` are their names.
    """

    def __init__(self, cfg: EnvConfig, device="cuda"):
        t = rules.tables_for(cfg)
        bb = bitboard_tables(cfg)
        self.cfg = cfg
        self.device = _build.resolve_device(device)
        self.num_pieces = t.num_pieces
        self.max_h = t.max_h
        self.tables = bb
        self.launches = self.tall_launches = self.general_launches = 0
        self.words_launches = self.words_tall_launches = self.words_general_launches = 0
        self.kind = packed_kind(cfg)
        if self.kind == "tall" and bb.nwords * bb.fpw > 32:
            self.kind = "general"
        self.shape = {"rows": row_launch_shape(cfg), "tall": anchor_launch_shape(cfg),
                      "general": None}[self.kind]
        self.name = "packed_mask" + SUFFIX[self.kind]
        self.words_kind = words_kernel_kind(cfg)
        self.words_shape = (anchor_launch_shape(cfg, words=True)
                            if self.words_kind == "tall" else self.shape)
        self.words_name = "packed_legal_words" + SUFFIX[self.words_kind]
        dev = self.device
        zero = np.zeros((1, bb.nwords), np.int64)
        # plain version: int64 tables with a zero row at the sentinel P
        self.prow = torch.as_tensor(
            np.concatenate([bb.prow.astype(np.int64), zero]), device=dev)
        self.piece_w = torch.as_tensor(
            np.append(bb.piece_w, 0).astype(np.int64), device=dev)
        self.cmask = torch.as_tensor(bb.cmask.astype(np.int64), device=dev)
        # kernel: the same bits as 32-bit words (it needs no cmask: see
        # csrc/packed_mask.cu)
        self.prow32 = torch.as_tensor(bb.prow.view(np.int32), device=dev)
        self.piece_w32 = torch.as_tensor(bb.piece_w, device=dev)

    def plain(self, words: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        return packed_mask_plain(words, queue, self.prow, self.piece_w,
                                 self.cmask, self.cfg, self.max_h)

    def plain_words(self, words: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        return packed_legal_words_plain(words, queue, self.prow, self.piece_w,
                                        self.cmask, self.cfg, self.max_h)

    def _check(self, words: torch.Tensor, queue: torch.Tensor) -> None:
        """Raise unless the inputs suit this wrapper; on a CUDA device also
        unless the kernels take them."""
        cfg = self.cfg
        n = words.shape[0]
        if words.device != self.device or queue.device != self.device:
            raise ValueError(
                f"tensors on {words.device}/{queue.device}, kernel tables on "
                f"{self.device}"
            )
        if words.shape != (n, cfg.height) or words.dtype != torch.int64:
            raise ValueError(f"words must be (N, {cfg.height}) int64")
        if queue.shape != (n, cfg.queue_size) or queue.dtype != torch.int32:
            raise ValueError(f"queue must be (N, {cfg.queue_size}) int32")
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"no packed mask kernel for device {self.device}")
        if not (words.is_contiguous() and queue.is_contiguous()):
            raise ValueError("words and queue must be contiguous")

    def _args(self, words: torch.Tensor, queue: torch.Tensor, out: torch.Tensor):
        """The kernels' arguments up to their launch shape: inputs, tables,
        output and sizes."""
        cfg = self.cfg
        return (words.data_ptr(), queue.data_ptr(), self.prow32.data_ptr(),
                self.piece_w32.data_ptr(), out.data_ptr(), words.shape[0], cfg.height,
                cfg.width, cfg.queue_size, self.num_pieces, self.tables.nwords,
                self.tables.fpw)

    def __call__(self, words: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        self._check(words, queue)
        if self.device.type == "cpu":
            return self.plain(words, queue)
        n = words.shape[0]
        out = torch.empty(
            (n, cfg.queue_size * cfg.num_cells), dtype=torch.bool,
            device=self.device,
        )
        if out.data_ptr() % 16:  # the kernels store 16-byte vectors
            raise RuntimeError("mask output is not 16-byte aligned")
        stream = torch.cuda.current_stream(self.device).cuda_stream
        # the launch shape: (per_warp, warps), (envs,) or nothing
        shape = self.shape or ()
        entry = "bp_" + self.name
        with torch.cuda.device(self.device):
            err = getattr(_build.library(), entry)(
                *self._args(words, queue, out), *shape, stream)
        _build.check(err, entry)
        count_launch(self)
        return out

    def words(self, words: torch.Tensor, queue: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        self._check(words, queue)
        if self.device.type == "cpu":
            return self.plain_words(words, queue)
        n = words.shape[0]
        out = torch.empty((n, cfg.queue_size * cfg.height), dtype=torch.int64,
                          device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        # per_warp, (envs,) or nothing
        shape = (self.words_shape[:1] if self.words_kind == "rows"
                 else self.words_shape or ())
        entry = "bp_packed_words" + SUFFIX[self.words_kind]
        with torch.cuda.device(self.device):
            err = getattr(_build.library(), entry)(
                *self._args(words, queue, out), *shape, stream)
        _build.check(err, entry)
        count_launch(self, "words_", self.words_kind)
        return out
