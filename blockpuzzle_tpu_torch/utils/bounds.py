"""The least time an H100 could take for each hand kernel's call.

A call's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the integer operations it does on these inputs over the card's
32-bit integer rate, counted on the busier of the two pipes that take
integer work.  Each kernel has one function here, ``COSTS[name](cfg,
inputs, outputs) -> (bytes, ops)``, which a caller hands the tensors of
one actual call; the operations are counted on the call's own data where
they depend on it (the hand's pieces).  ``chip_smoke.py`` phase 1 and the
roofline (``scripts/roofline.py``) read these counts.

Operations: the bit-row mask (K1) packs each of an env-slot's H rows from
(W + 6) // 4 32-bit words (7 operations a word), ORs in the max_h rows
below by shuffles (5 operations a row), smears and shifts its two
rectangles (10 each), masks the legal row (3) and spends one operation per
output byte on the spread store; the bit-row clear (K3) packs its rows
likewise, tests and clears each row word (about 8 operations; a band row 2
per region row and 3 per tile with regions) and spends one per output
byte; the wide mask and clear count the same a word where a row is NW =
ceil(W / 32) words (each word packed from min(32, W - 32 i) cells, NW
shuffles a row below, 10 operations a word for each rectangle's smear and
shift, whose steps are funnel shifts, and 4 for its legal mask; the clear
tests and clears about 8 a word); the tall mask and clear (boards of 33 to
128 rows, a warp a board) and the deep mask (more rows, windows of 32)
count as the wide ones, a row's words being one where W <= 32, the deep
clear 3 more a word (staged, then its full columns cleared); the xwide
mask and clear (rows of 129 to 1024 cells, a lane a word of every row)
load each env's board as row words once (2 operations a byte), the mask
then spending about 50 operations a word of each anchor row beside 5 a
row below (the rectangles' smear and shift on a word pair, the ring of
rows below), the clear about 12 a word in its two passes; the bit-row
apply (K2) packs two words a row, tests, places and
clears (about 12) and stores likewise, and its wide, tall and deep
kernels pack two rows of words (board and cover), spend 2 operations a
word on the overlap and the place and the clear's 8 (the deep one 6 more:
its first pass stages the placed word, pass 1 reads it back, pass 2
clears its columns), its xwide kernel loads the board as row words, ORs
the cover over them and spends 3 a word on the overlap and the place
beside the xwide clear's 12; the legality (K4) is counted as
the function's least work, whichever kernel computes it: each row packed
once as ceil(W / 32) words, the smears built once a word (3 operations for
each of max_h * max_w shapes), about 15 a piece a word and one per output
byte (the mask's every-piece instances repack an env's rows for each
piece, work the function does not need); the general mask tests a piece
at one anchor with an AND and an OR per cell, the general clear and apply
do about 3 and 5 operations a cell; a packed
anchor row tests W - piece_w + 1 anchors with 3 operations per footprint
word and builds its words with 2 per field (B7, and its words entry B7w,
which stores the row word as it is); B1 does about 10 a row word.  Their
tall kernels (33 to 128 rows, a warp a board) and general kernels (more
rows: B1 and B7 a warp over windows of 32 rows, B7w a thread an anchor
row) are counted as they are.  The
draws' (B9, B2, B2w) hash is a quarter multiplies, so theirs are counted
by pipe: they fold an env's key and counter in three mixes (6 ALU
operations and 2 multiplies each) and 3 XORs (21 and 6), the stream's tag
into that in 4 (the lanes' common first xorshift, ``hash32.cuh``
``lane_seed``), and hash a lane in 5 and 2 (an XOR, two shifts, two XORs;
two multiplies); B9 multiplies once more a lane (``__umulhi``), B2 spends
3 more a lane on the select and the running maximum, B2w 2 a word on the
popcount total, 2 a word up to the chosen one on the search, about 10 on
the uniform and the rank and 20 on the 5-step rank-select.  In each the
ALU pipe is the busier.  The other kernels multiply little (one multiply
a packed row word) and count it with the rest.

The packed tail (B10) moves its bytes with little work: it ORs the mask
a 32-bit word at a time (S*HW / 4 an env, again for the mask it writes
with auto-reset), stages and writes its row words (2 a row), spends one
operation per byte of each board view it writes (one, or two with
auto-reset) and about 30 on an env's flags and scalars; the (P + 1, HW)
empty-board table it reads counts once a call.  Its unpack entry stages
the row words (one a row) and spends one per output byte.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.config import EnvConfig
from blockpuzzle_tpu_torch.kernels.draws import select_lanes, select_shape

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# H100 SXM 32-bit integer rate of one pipe: 132 SMs x 64 results a clock
# (add, multiply, shift, logical and compare at compute capability 9.0,
# the CUDA C++ Programming Guide's throughput table) x 1.98 GHz, the
# greatest SM clock: 16.7e12 operations/s.  Hopper issues integer
# multiplies (IMAD) to the FMA pipe and the rest of the integer work
# (logic, shifts, adds, compares, selects, min and max) to the ALU pipe,
# 64 a clock an SM each, the two side by side, so a call's operations
# bound is its busier pipe's count over this rate.  (The 67e12 float32
# figure counts 128 FMA lanes an SM, two operations each; the hand
# kernels' work is integer work, but for B2w's two float products.)
INT_OPS_PER_S = 132 * 64 * 1.98e9

Tensors = Sequence[torch.Tensor]
Cost = Callable[[EnvConfig, Tensors, Tensors], Tuple[int, float]]


def nbytes(tensors: Tensors) -> int:
    """Bytes of the tensors among ``tensors`` (a call's Python ints, such
    as a deal's shared counter, move none)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(tensors: Tensors, ops: float) -> dict:
    """The least time for a kernel that reads and writes ``tensors`` once
    each and does ``ops`` integer operations: the larger of the two."""
    return bytes_bound(nbytes(tensors), ops)


def call_bound(name: str, cfg: EnvConfig, inputs: Tensors, outputs: Tensors) -> dict:
    """``bound`` of one call of kernel ``name`` from its ``COSTS`` entry's
    bytes and operations (for a kernel that reads a table of its own, or
    hands back some of its inputs as outputs)."""
    return bytes_bound(*COSTS[name](cfg, inputs, outputs))


def bytes_bound(moved: int, ops: float) -> dict:
    """``bound`` of a call that moves ``moved`` bytes and does ``ops``
    integer operations."""
    by_bytes = 1e3 * moved / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / INT_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": moved, "ops": ops}


def _pack(cfg: EnvConfig) -> int:
    """Operations to pack one board row from its bytes."""
    return 7 * ((cfg.width + 6) // 4)


def _regions(cfg: EnvConfig) -> int:
    rs = cfg.region_size
    return cfg.height * (2 * rs + 3 * (cfg.width // rs)) if cfg.region_clear else 0


def _hand_sum(values, empty, queue: torch.Tensor) -> float:
    """``values`` of each hand slot's piece (``empty`` for an empty slot),
    summed over the batch."""
    table = torch.as_tensor(np.append(values, empty), device=queue.device)
    return float(table[queue.clamp(0, len(values)).long()].sum())


def _cost(ops: Callable[[EnvConfig, Tensors], float]) -> Cost:
    """A kernel's cost function from its operation count on the inputs."""
    def cost(cfg: EnvConfig, inputs: Tensors, outputs: Tensors) -> Tuple[int, float]:
        return nbytes(list(inputs) + list(outputs)), float(ops(cfg, inputs))
    cost.__doc__ = ops.__doc__
    return cost


def _mask(cfg, inputs):
    """K1, bit-row: inputs (board (N, HW) u8, queue (N, S) i32)."""
    t = rules.tables_for(cfg)
    n, h = inputs[0].shape[0], cfg.height
    return n * cfg.queue_size * (h * (_pack(cfg) + 5 * t.max_h + 23) + cfg.num_cells)


def _words(cfg: EnvConfig) -> int:
    """Words a row of the wide kernels: ceil(W / 32)."""
    return -(-cfg.width // 32)


def _pack_words(cfg: EnvConfig) -> int:
    """Operations to pack one board row as ``_words`` words, each from its
    own cells (``pack_row`` a word)."""
    widths = [min(32, cfg.width - 32 * i) for i in range(_words(cfg))]
    return sum(7 * ((w + 6) // 4) for w in widths)


def _mask_wide(cfg, inputs):
    """K1, wide: inputs (board (N, HW) u8, queue (N, S) i32)."""
    t = rules.tables_for(cfg)
    n, h, nw = inputs[0].shape[0], cfg.height, _words(cfg)
    return n * cfg.queue_size * (h * (_pack_words(cfg) + nw * (5 * t.max_h + 24))
                                 + cfg.num_cells)


def _stage_words(cfg: EnvConfig) -> int:
    """Operations to load one board into row words (``stage_words``):
    about 32 a 16-byte vector (its 16 bits gathered, placed and ORed in),
    2 a byte, and one to zero each word first."""
    return 2 * cfg.num_cells + cfg.height * _words(cfg)


def _mask_xwide(cfg, inputs):
    """K1, xwide (a lane a word of every row): inputs (board (N, HW) u8,
    queue (N, S) i32); each env's board loaded as row words once, then a
    word of each anchor row: 5 operations a row below, 2 shuffles and the
    two rectangles' smear and shift on the word pair (about 40), the legal
    mask, the store to shared memory and the ring of rows below (8); the
    same on rows of more than 1024 cells (``mask_xwide_long``: a lane's
    slots each a word's operations, a slot past the row's last word
    none)."""
    t = rules.tables_for(cfg)
    n, h, nw = inputs[0].shape[0], cfg.height, _words(cfg)
    return n * (_stage_words(cfg) + cfg.queue_size * (h * nw * (5 * t.max_h + 50)
                                                      + cfg.num_cells))


def _mask_general(cfg, inputs):
    """K1, general: inputs (board, queue)."""
    t = rules.tables_for(cfg)
    return 2 * _hand_sum(t.piece_cells, 0, inputs[1]) * cfg.num_cells


def _apply(cfg, inputs):
    """K2, bit-row: inputs (board, footprint cells, valid)."""
    n, h = inputs[0].shape[0], cfg.height
    return n * (h * (2 * _pack(cfg) + 12) + _regions(cfg) + cfg.num_cells)


def _apply_general(cfg, inputs):
    """K2, general: inputs (board, footprint cells, valid)."""
    return 5 * inputs[0].shape[0] * cfg.num_cells


def _apply_words(cfg, inputs):
    """K2, wide and tall: inputs (board, footprint cells, valid); two rows
    of words packed, 2 operations a word to test and place, the clear's
    8."""
    n, h = inputs[0].shape[0], cfg.height
    return n * (h * (2 * _pack_words(cfg) + 10 * _words(cfg)) + _regions(cfg)
                + cfg.num_cells)


def _apply_deep(cfg, inputs):
    """K2, deep: ``_apply_words`` and 6 operations more a word: stage the
    placed word, read it back, clear the full columns from it."""
    n, h = inputs[0].shape[0], cfg.height
    return n * (h * (2 * _pack_words(cfg) + 16 * _words(cfg)) + _regions(cfg)
                + cfg.num_cells)


def _apply_xwide(cfg, inputs):
    """K2, xwide: inputs (board, footprint cells, valid); the board loaded
    as row words and the cover ORed over them, 3 operations a word to test
    the atomics' old words and place, the xwide clear's 12 (also on rows of
    more than 1024 cells, ``apply_xwide_long``: a lane's slots each take a
    word's operations, a slot past the row's last word none)."""
    n, h = inputs[0].shape[0], cfg.height
    return n * (2 * _stage_words(cfg) + h * 15 * _words(cfg) + _regions(cfg)
                + cfg.num_cells)


def _clear(cfg, inputs):
    """K3, bit-row: inputs (board,)."""
    n, h = inputs[0].shape[0], cfg.height
    return n * (h * (_pack(cfg) + 8) + _regions(cfg) + cfg.num_cells)


def _clear_wide(cfg, inputs):
    """K3, wide: inputs (board,)."""
    n, h = inputs[0].shape[0], cfg.height
    return n * (h * (_pack_words(cfg) + 8 * _words(cfg)) + _regions(cfg) + cfg.num_cells)


def _clear_deep(cfg, inputs):
    """K3, deep: inputs (board,); a word's 8 operations of pass 1, then 3
    to stage it and clear the full columns from it in pass 2."""
    n, h = inputs[0].shape[0], cfg.height
    return n * (h * (_pack_words(cfg) + 11 * _words(cfg)) + _regions(cfg) + cfg.num_cells)


def _clear_xwide(cfg, inputs):
    """K3, xwide: inputs (board,); the board loaded as row words, then a
    word of each row about 6 operations in each of the two passes (the
    column AND and the full-row bit, then the clear in place); the same on
    rows of more than 1024 cells (``clear_xwide_long``: a lane's slots each
    a word's operations, a slot past the row's last word none)."""
    n, h = inputs[0].shape[0], cfg.height
    return n * (_stage_words(cfg) + h * 12 * _words(cfg) + _regions(cfg) + cfg.num_cells)


def _clear_general(cfg, inputs):
    """K3, general: inputs (board,)."""
    return 3 * inputs[0].shape[0] * cfg.num_cells


def _legality(cfg, inputs):
    """K4, every kernel: inputs (board,); a row of ``_words`` words packed
    once, its smears and a piece's test a word (one word where W <= 32, the
    bit-row kernel's count)."""
    t = rules.tables_for(cfg)
    n, h, nw = inputs[0].shape[0], cfg.height, _words(cfg)
    return n * (h * (_pack_words(cfg) + nw * (3 * t.max_h * t.max_w + 15 * t.num_pieces))
                + t.num_pieces * cfg.num_cells)


def _packed_apply(cfg, inputs):
    """B1: inputs (words (N, H) i64, attrs, r, c, valid)."""
    return 10 * inputs[0].shape[0] * cfg.height


def _packed_mask(cfg, inputs):
    """B7 and its words entry B7w: inputs (words (N, H) i64, queue).  The
    least work of the test of a whole anchor row at once: each anchor row
    of an env-slot holding a piece ORs each of the piece's cells' board row
    shifted by the cell's column (2 operations a cell) and masks the result
    to its legal columns (2); an empty slot tests nothing."""
    cells = _hand_sum(rules.tables_for(cfg).piece_cells.astype(np.int64), 0, inputs[1])
    slots = _hand_sum(np.ones(rules.tables_for(cfg).num_pieces, np.int64), 0, inputs[1])
    return cfg.height * (2 * cells + 2 * slots)


# the draws' operations on the ALU pipe and multiplies on the FMA pipe:
# the per-env fold of key and counter, the stream's seed, one lane
FOLD_OPS, FOLD_MULS = 21, 6
SEED_OPS = 4
LANE_OPS, LANE_MULS = 5, 2


def _deal(cfg, inputs):
    """B9: inputs (key (N,) i64, counter, tag, width); a lane's deal
    multiplies once more (``__umulhi``)."""
    width = inputs[3]
    return inputs[0].shape[0] * max(FOLD_OPS + SEED_OPS + LANE_OPS * width,
                                    FOLD_MULS + (LANE_MULS + 1) * width)


def _uniform_legal(cfg, inputs):
    """B2: inputs (key (N,) i64, counter, mask (N, A) bool)."""
    n, a = inputs[2].shape
    return n * max(FOLD_OPS + SEED_OPS + (LANE_OPS + 3) * a, FOLD_MULS + LANE_MULS * a)


# B2w's operations besides its words: a scan round (shuffle, test, add) and
# the rank's broadcast and a lane's test of it, each a lane; the holder's
# pass over its registers a word (popcount, two compares, add, select) and
# its 5-step rank-select
SCAN_OPS, RANK_OPS, PICK_OPS, SELECT_OPS = 3, 4, 5, 30


def _words_select(cfg: EnvConfig, inputs: Tensors, outputs: Tensors) -> Tuple[int, float]:
    """B2w: inputs (key (N,) i64, counter, words (N, S*H) i64, width), output
    the (N,) actions.  On the ALU pipe an env takes the draw's fold in one
    lane, a popcount and an add a word, log2 L scan rounds and the rank's
    broadcast and test in each of its L lanes (``kernels/draws.py``
    ``select_lanes``), and the one holder's pass over its K registers and
    its rank-select; where a lane's span passes its registers (rows of more
    than 1024 words) the holder's second walk up to its word is counted on
    the call's data (``action // width``)."""
    key, _, words, width = inputs
    n, nwords = key.shape[0], words.shape[1]
    aligned = words.data_ptr() % 16 == 0
    lanes = select_lanes(nwords, aligned)
    _, span, regs = select_shape(nwords, lanes, aligned)
    per_env = (FOLD_OPS + SEED_OPS + LANE_OPS + 2 * nwords
               + lanes * (SCAN_OPS * (lanes.bit_length() - 1) + RANK_OPS)
               + PICK_OPS * regs + SELECT_OPS)
    walked = 0.0
    if span > regs:
        at = outputs[0] // width % span           # the word's place in its lane's span
        walked = float(2 * ((at // regs + 1) * regs).sum())
    alu = n * per_env + walked
    return nbytes(list(inputs) + list(outputs)), float(max(alu, n * (FOLD_MULS + LANE_MULS)))


def _packed_tail(cfg: EnvConfig, inputs: Tensors, outputs: Tensors) -> Tuple[int, float]:
    """B10: inputs (words_next (N, H) i64, mask (N, S*HW) bool, reward,
    queue3, reset_deals, steps, score, streak_next, rng_counter, auto_reset),
    outputs ``kernels/tail.py`` ``Tail``.  With auto-reset it reads every
    input tensor and writes every output; without, it reads neither the
    reset deals nor the streak and writes the flags, the scalars and one
    board view (the rest of ``Tail`` is its inputs)."""
    (words, mask, reward, queue3, reset, steps, score, streak, counter,
     auto_reset) = inputs
    ins = [words, mask, reward, queue3, steps, score, counter]
    outs = list(outputs[:7])
    if auto_reset:
        ins += [reset, streak]
        outs += list(outputs[7:])
    n, hw = words.shape[0], cfg.num_cells
    table = (rules.tables_for(cfg).num_pieces + 1) * hw
    views = 2 if auto_reset else 1  # the mask ORed and copied; the board views
    ops = n * (views * cfg.queue_size * hw // 4 + 2 * cfg.height + views * hw + 30)
    return nbytes(ins + outs) + table, float(ops)


def _packed_unpack(cfg, inputs):
    """B10's unpack entry: inputs (words (N, H) i64,)."""
    return inputs[0].shape[0] * (cfg.height + cfg.num_cells)


COSTS: Dict[str, Cost] = {
    "mask": _cost(_mask), "mask_wide": _cost(_mask_wide),
    "mask_tall": _cost(_mask_wide), "mask_deep": _cost(_mask_wide),
    "mask_xwide": _cost(_mask_xwide), "mask_xwide_long": _cost(_mask_xwide),
    "mask_general": _cost(_mask_general),
    "apply": _cost(_apply), "apply_wide": _cost(_apply_words),
    "apply_tall": _cost(_apply_words), "apply_deep": _cost(_apply_deep),
    "apply_xwide": _cost(_apply_xwide), "apply_xwide_long": _cost(_apply_xwide),
    "apply_general": _cost(_apply_general),
    "clear": _cost(_clear), "clear_wide": _cost(_clear_wide),
    "clear_tall": _cost(_clear_wide), "clear_deep": _cost(_clear_deep),
    "clear_xwide": _cost(_clear_xwide), "clear_xwide_long": _cost(_clear_xwide),
    "clear_general": _cost(_clear_general),
    **{f"legality{s}": _cost(_legality)
       for s in ("", "_wide", "_tall", "_deep", "_xwide", "_xwide_long", "_general")},
    **{f"packed_apply{s}": _cost(_packed_apply) for s in ("", "_tall", "_general")},
    **{f"packed_{e}{s}": _cost(_packed_mask) for e in ("mask", "legal_words")
       for s in ("", "_tall", "_general")},
    "deal": _cost(_deal), "uniform_legal": _cost(_uniform_legal),
    "words_select": _words_select,
    "packed_tail": _packed_tail, "packed_unpack": _cost(_packed_unpack),
}


def kernel_bounds(cfg, board, queue, cover, valid, words, attrs, r, c, outs) -> dict:
    """The bound of each kernel named in ``outs`` (kernel -> its outputs:
    a tensor or a tuple) on these inputs."""
    inputs = {"mask": [board, queue], "apply": [board, cover, valid],
              "clear": [board], "legality": [board],
              "packed_apply": [words, attrs, r, c, valid],
              "packed_mask": [words, queue], "packed_legal_words": [words, queue]}
    bounds = {}
    for k, out in outs.items():
        args = inputs[k.removesuffix("_long").removesuffix("_wide").removesuffix("_tall")
                      .removesuffix("_deep").removesuffix("_xwide").removesuffix("_general")]
        out = list(out if isinstance(out, tuple) else (out,))
        _, ops = COSTS[k](cfg, args, out)
        bounds[k] = bound(args + out, ops)
    return bounds
