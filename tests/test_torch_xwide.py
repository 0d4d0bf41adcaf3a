"""The u8 mask, clear and apply on rows of more than 128 cells, on the CPU,
against the JAX package.

Boards of at most 32 rows of 129 to 1024 cells take the xwide kernels of
the u8 mask (K1, ``mask_xwide``), clear (K3, ``clear_xwide``) and apply
(K2, ``apply_xwide``, the clear kernel's second instance): a
segment of NW = ceil(W / 32) lanes an env-slot or env, lane w holding word
w of every row (the transpose of the bit-row layout), each board loaded
as 16-byte vectors straight into row words in shared memory
(``bit_rows.cuh`` ``stage_words``). The mask walks the anchor rows with
the 8 rows below in a ring, ORs each rectangle's rows lane-locally and
smears it on the pair (this word, the next lane's); the clear ANDs a
lane's rows into its full columns, finds full rows by one reduction over
the segment and full regions on the funnel-shifted pair of band words, a
field across two words handed up to the next lane; the apply loads the
covers as row words beside the boards, finds the overlap by one reduction
over the segment, places a legal env's cover in place and runs the clear's
passes, an illegal env writing nothing back (above one window of rows it
ORs the covers over the boards instead, ``test_torch_xwide_tall.py``). Numpy emulations of all
three (every lane of a block at once, as (warps, 32) arrays), fed the
tables and launch shapes the wrappers hand the kernels and boards staged
at byte offsets 0, 3 and 13, are held bit-equal to the wrappers' plain
versions and to the JAX package: the u8 engine's shift mask for K1, the
Pallas clear kernel in interpret mode and the u8 engine's ``clear_scan``
for K3, the Pallas apply kernel in interpret mode for K2. The boards: 8x136 (the shape the port's default engine takes
there), 8x160 (whole words, no pad bits), 9x135 with 3x3 regions and a
hand of three (fields across words at columns 30..32 and 63..65), 3x320
(NW = 10) and 2x1024 (NW = 32, one segment a warp; horizontal bars
across every word border), these two with the piece set of at most 2x2
pieces (the JAX engine's piece tables need pieces that fit the board).
The kernels themselves run only on the card (``chip_smoke.py``).
Everything is integer or bool and must be bit-equal.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockpuzzle_tpu import config as jcfg
from blockpuzzle_tpu import kernels as jk
from blockpuzzle_tpu.env import make_env as jax_make_env
from blockpuzzle_tpu_torch import config as tcfg
from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.kernels import ApplyKernel, ClearScanKernel, MaskKernel
from blockpuzzle_tpu_torch.kernels.mask import piece_rows_table
from blockpuzzle_tpu_torch.kernels.packed import (
    SMEM_OPT_IN, U32, XWIDE_APPLY_WARPS, XWIDE_SEGMENT, XWIDE_WARPS, apply_launch_shape,
    xwide_apply_smem_bytes, xwide_launch_shape, xwide_smem_bytes, xwide_windows,
)
from blockpuzzle_tpu_torch.utils.bounds import COSTS
from test_torch_kernels import (
    _block_layout, _fshr, _shr_words, apply_cases, assert_apply_cases, emulate_smear_words,
)
from test_torch_packed import _popc, _reduce, _shfl, _small_div
from test_torch_tall import emulate_store_tall

XWIDE = {"8x136": dict(height=8, width=136), "8x160": dict(height=8, width=160),
         "9x135r3": dict(height=9, width=135, region_clear=True, region_size=3,
                         queue_size=3),
         "3x320": dict(height=3, width=320, piece_set="mini5"),
         "2x1024": dict(height=2, width=1024, piece_set="mini5")}
# (the JAX engine's piece tables need pieces that fit the board, so the
# boards of fewer than 5 rows take the piece set of at most 2x2 pieces)
# two or more blocks on every board, the last one ragged
N = 37


def _pair(case):
    return jcfg.EnvConfig(**XWIDE[case]), tcfg.EnvConfig(**XWIDE[case])


def xwide_cells(cfg, n, rng, fill):
    """Random 0/1 boards with a full first row (env 1) and a full last row
    (env 2), full columns on either side of the first word border and the
    last column (env 3), the last row full but for its first cell (env 4),
    a board holding only the first column of every word but the first (env
    5: a bar across any word border meets one), with regions two 3x3
    regions across word borders, columns 30..32 and 63..65 (env 6), a full
    board (the last) and an empty one."""
    h, w = cfg.height, cfg.width
    cells = (rng.random((n, h, w)) < fill).astype(np.uint8)
    cells[1, 0, :] = 1
    cells[2, h - 1, :] = 1
    cells[3][:, [31, 32, w - 1]] = 1
    cells[4, h - 1, 1:] = 1
    cells[4, h - 1, 0] = 0
    cells[5] = 0
    cells[5][:, 32::32] = 1
    if cfg.region_clear:
        cells[6, 0:3, 30:33] = 1
        cells[6, 3:6, 63:66] = 1
    cells[n - 1], cells[n - 2] = 1, 0
    return cells.reshape(n, -1)


def xwide_hands(cfg, n, rng):
    """Hands with the empty sentinel (env 0), an id below 0 (env 1) and past
    it (env 2), and the widest horizontal bar (1x5, or 1x2 in mini5) on env
    5's board of word borders."""
    t = rules.tables_for(cfg)
    queue = rng.integers(0, t.num_pieces + 1, (n, cfg.queue_size)).astype(np.int32)
    queue[0] = t.num_pieces
    queue[1, 0] = -1
    queue[2, 0] = t.num_pieces + 3
    queue[5, 0] = bar_piece(t)
    return queue


def bar_piece(t):
    """The widest piece of one row."""
    return int(np.argmax(np.where(t.piece_h == 1, t.piece_w, 0)))


# --------------------------------------------------------------------------
# the xwide layout: a segment of NW lanes a board, lane w holding word w of
# every row; values as (warps, 32) int64 arrays holding uint32 bits
# --------------------------------------------------------------------------


def _or_bits(words, at, c, bits, nw, board=None):
    """bit_rows.cuh or_bits, for many at once: ``bits`` (< 2^16) ORed into
    the row whose first word is words[at], from column c on, the part past
    word c / 32, where it has set bits, into the next word (never past a
    row's last word: no column >= W is set).  Given ``board`` (the words
    before a cover is ORed over them), returns where a bit met a set one:
    the old words the atomics return hold the board's bits and the cover's
    placed so far, and no two of a cover's placements share a bit, so the
    board's words alone decide it."""
    wd, off = c >> 5, c & 31
    lo = (bits << off) & U32
    np.bitwise_or.at(words, at + wd, lo)
    over = (off > 16) & ((bits >> np.clip(32 - off, 0, 32)) != 0)
    assert (wd[over] + 1 < nw).all()
    hi = bits[over] >> (32 - off[over])
    np.bitwise_or.at(words, (at + wd + 1)[over], hi)
    if board is None:
        return None
    met = (board[at + wd] & lo) != 0
    met[over] |= (board[(at + wd + 1)[over]] & hi) != 0
    return met


def _place_bits(words, q, bits, n, w, nw, board=None, height=None, met=None):
    """bit_rows.cuh place_bits: the n bits of bytes q .. q + n - 1 into the
    columns of row q / W (``small_div``) from q % W on, the bits past the
    row's end into the next row's first columns.  Given ``board``
    (``place_bits<true>``, the apply's cover), a bit that meets a set one
    marks its board, met[R / H] for its row R."""
    row = _small_div(q, w)
    c = q - row * w
    k = np.minimum(n, w - c)
    hit = _or_bits(words, row * nw, c, np.where(k < 16, bits & ((1 << k) - 1), bits), nw,
                   board)
    spill = k < n
    hit2 = _or_bits(words, (row[spill] + 1) * nw, np.zeros(spill.sum(), np.int64),
                    bits[spill] >> k[spill], nw, board)
    if board is not None:
        met[_small_div(row[hit], height)] = True
        met[_small_div(row[spill][hit2] + 1, height)] = True


def emulate_stage_words(flat, lo, hi, addr, w, nw, board=None, height=None):
    """bit_rows.cuh stage_words: bytes [lo, hi) of ``flat`` (rows of W cells,
    the input starting ``addr`` bytes past a 16-byte boundary) as row words,
    NW a row: the unaligned head and the ragged tail byte by byte, each
    aligned 16-byte vector gathered to 16 bits (``pack16``: a word's four
    top bits by one multiply) and ORed into the rows and words it falls
    in; checked against the rows packed directly.  Returns (rows, NW).
    Given ``board`` (``stage_words<true>``: the apply's covers, ``flat``,
    ORed over the staged boards' words, boards of ``height`` rows), the
    words start from ``board`` instead of zeros, and it returns (the placed
    rows, met): met[e] where a cover bit of board e met a set bit, the
    cover's overlap, checked against board & cover packed directly."""
    length = hi - lo
    rows = int(_small_div(length, w))
    assert rows * w == length
    span = flat[lo:hi].astype(np.int64)
    d = (addr + lo) % 16
    head = min((16 - d) % 16, length)
    nvec = (length - head) // 16
    words = np.zeros(rows * nw, np.int64) if board is None else board.copy()
    met = None if board is None else np.zeros(rows // height, bool)
    q0 = head + 16 * np.arange(nvec)
    assert ((addr + lo + q0) % 16 == 0).all()             # the uint4 loads' alignment
    vec = span[q0[:, None] + np.arange(16)].reshape(nvec, 4, 4)
    v = (vec << (8 * np.arange(4))).sum(axis=2)           # four little-endian words
    top = (((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v) & 0x80808080
    bits = ((((top * 0x00204081) & U32) >> 28) << (4 * np.arange(4))).sum(axis=1)
    assert (bits == ((vec.reshape(nvec, 16) != 0) << np.arange(16)).sum(axis=1)).all()
    _place_bits(words, q0, bits, 16, w, nw, board, height, met)
    qb = np.concatenate([np.arange(head), np.arange(head + 16 * nvec, length)])
    qb = qb[span[qb] != 0]
    _place_bits(words, qb, np.ones_like(qb), 1, w, nw, board, height, met)
    cells = np.zeros((rows, 32 * nw), np.int64)
    cells[:, :w] = span.reshape(rows, w) != 0
    direct = (cells.reshape(rows, nw, 32) << np.arange(32)).sum(axis=2).reshape(-1)
    if board is None:
        np.testing.assert_array_equal(words, direct)
        return words.reshape(rows, nw)
    np.testing.assert_array_equal(words, board | direct)
    np.testing.assert_array_equal(
        met, (board & direct).reshape(rows // height, -1).any(axis=1))
    return words.reshape(rows, nw), met


def _shfl_down(v, l):
    """__shfl_down_sync(v, 1): lane l + 1's value, lane 31 its own."""
    return _shfl(v, np.where(l + 1 < 32, l + 1, l))


def _shfl_up(v, l):
    """__shfl_up_sync(v, 1): lane l - 1's value, lane 0 its own."""
    return _shfl(v, np.where(l >= 1, l - 1, l))


def emulate_mask_xwide_kernel(cfg, board, queue, mk, addr=0):
    """csrc/mask.cu mask_xwide_kernel on ``mk``'s piece table and launch
    shape: the block loads the boards its env-slots read as row words
    (``stage_words``); each lane walks the anchor rows (any number of them)
    holding the 8 rows below in a ring, read from shared memory as it goes,
    ORs each rectangle's rows, takes the next lane's word by a shuffle (0
    for the top word) and smears and shifts the pair (``smear_words<2>``,
    ``shr_words<2>``); the legal words are staged, over the board words in
    place where S = 1 (an active lane never reads a word once it is
    written), and stored from the block's byte offset (``store_words_n``,
    as ``store_tall``).  Lanes of no env-slot read env 0's words, as they
    stand, and store nothing."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    hw, n, nw = cfg.num_cells, len(board), -(-w // 32)
    assert mk.max_h <= 8 and mk.max_w <= 8
    pieces = mk.piece_table.numpy().astype(np.int64) & U32
    per_warp = mk.shape[0]
    per_block, l, sw, lane, _, _, seg = _block_layout(nw, mk.shape)
    total = n * s
    out = np.full(total * hw, 2, np.uint8)                    # 2: never written
    for first in range(0, total, per_block):
        count = min(per_block, total - first)
        env0 = first // s
        envs = (first + count - 1) // s + 1 - env0
        words = emulate_stage_words(board.reshape(-1), env0 * hw, (env0 + envs) * hw, addr,
                                    w, nw).reshape(-1)
        active = (sw < per_warp) & (seg < count)
        pid = np.where(active, queue.reshape(-1)[first + np.where(active, seg, 0)], -1)
        has = (pid >= 0) & (pid < mk.num_pieces)
        pc = np.where(has[..., None], pieces[np.where(has, pid, 0)],
                      np.array([h + 1, w + 1, 0, 0]))        # (warps, 32, 4)
        env = np.where(active, _small_div(first - env0 * s + np.where(active, seg, 0), s), 0)
        written = np.zeros(words.shape, bool)                 # legal words over board words

        def row(i):
            """Row i of each lane's word, from the shared words as they stand."""
            at = (env * h + i) * nw + lane
            assert not written[at[active]].any()              # read before it is written
            return words[at]

        r1, r2 = pc[..., 2], pc[..., 3]
        last = lane + 1 == nw
        a = w - pc[..., 1] + 1 - 32 * lane
        span = np.where(a >= 32, U32, np.where(a > 0, (1 << np.clip(a, 0, 31)) - 1, 0))
        below = [row(i) if i < h else np.zeros_like(env) for i in range(8)]
        in_place = s == 1
        staged = words if in_place else np.full(per_block * h * nw, -1, np.int64)
        for r in range(h):
            v1, v2 = np.zeros_like(env), np.zeros_like(env)
            for i in range(mk.max_h):
                v1 |= np.where((i >= r1 & 0xFF) & (i - (r1 & 0xFF) < (r1 >> 16) & 0xFF),
                               below[i], 0)
                v2 |= np.where((i >= r2 & 0xFF) & (i - (r2 & 0xFF) < (r2 >> 16) & 0xFF),
                               below[i], 0)
            b1 = _shr_words(emulate_smear_words(
                [v1, np.where(last, 0, _shfl_down(v1, l))], r1 >> 24), (r1 >> 8) & 0xFF)
            b2 = _shr_words(emulate_smear_words(
                [v2, np.where(last, 0, _shfl_down(v2, l))], r2 >> 24), (r2 >> 8) & 0xFF)
            legal = np.where(r + pc[..., 0] <= h, ~(b1[0] | b2[0]) & span, 0)
            at = (seg * h + r) * nw + lane
            if in_place:                                    # env-slot e's own rows
                assert (at[active] == ((env * h + r) * nw + lane)[active]).all()
                assert not written[at[active]].any()        # each word staged once
                written[at[active]] = True
            else:
                assert (staged[at[active]] == -1).all()     # each word staged once
            staged[at[active]] = legal[active]
            below = below[1:] + [row(r + 8) if r + 8 < h else np.zeros_like(env)]
        if in_place:
            assert written[: count * h * nw].all()
        emulate_store_tall(staged, out, first * hw, count * hw, w, nw)
    assert (out < 2).all()
    return out.reshape(n, s * hw).astype(bool)


def emulate_clear_xwide_kernel(cfg, board, ck, addr=0, apply=None):
    """csrc/clear.cu clear_xwide_kernel on ``ck``'s launch shape: the block
    loads its envs' boards as row words (``stage_words``); pass 1, a lane at
    a time, ANDs its rows into its word of the full columns; pass 2 walks
    windows of 32 rows (32 - 32 mod rs with regions): bit i of a lane's word
    marks row w0 + i's word (the top word's bits past W set) full, one
    reduction over the segment giving the window's full rows; then a band of
    rs rows at a time (a row without regions): the band's AND, each field
    that starts in the word read from the funnel-shifted pair (this word,
    the next lane's by a shuffle), the part of a full field past the word
    handed up to the next lane by a shuffle, then each row cleared in place
    (all of it if full, else its full columns and fields); k = the full
    rows of every window + the segment's sum of full columns and of
    fields.  Its apply
    instance, given ``apply = (cover, valid, cover_addr)`` (the cover at
    its own offset from a 16-byte boundary): on a board of one window
    (``kCovers``) the block loads its envs' covers as row words beside the
    boards; a lane ORs board & cover over its rows, one reduction over the
    segment gives the env's overlap, and a legal env (valid, no overlap)
    places its cover in its words before the passes; an illegal env runs
    them on its input words and writes none back (every lane still
    shuffles and reduces), so it stores its input with k = 0.  On a taller
    board (``kPlaced``) the block ORs the covers over the staged board
    words (``stage_words<true>``), a cover bit that meets a board bit
    marking the env (its word of ``keep``); a legal env runs the passes on
    its placed words, an illegal one runs them too but writes none back,
    its lane 0 marks it, and the store writes its input bytes, read from
    the board again (``store_apply_words``), with k = 0.  Returns (board,
    k), and legal for the apply."""
    h, w, hw, n = cfg.height, cfg.width, cfg.num_cells, len(board)
    nw = -(-w // 32)
    rs = cfg.region_size if cfg.region_clear else 0
    per_warp = ck.shape[0]
    per_block, l, sw, lane, _, _, seg = _block_layout(nw, ck.shape)
    tail = w - 32 * (nw - 1)
    pad = np.where((lane + 1 == nw) & (tail < 32), (U32 << tail) & U32, 0)
    tile0 = (1 << rs) - 1 if rs else 0
    win = 32 - 32 % rs if rs else 32                          # rows a window
    out, ks = np.full(n * hw, 2, np.uint8), np.full(n, -1, np.int64)
    legals = np.full(n, -1, np.int64)
    for first in range(0, n, per_block):
        count = min(per_block, n - first)
        lo, hi = first * hw, (first + count) * hw
        words = emulate_stage_words(board.reshape(-1), lo, hi, addr, w, nw)
        placed = apply is not None and h > win                # kPlaced, else kCovers
        if placed:                                            # the covers ORed over them
            cover, valid, cover_addr = apply
            words, keep = emulate_stage_words(cover.reshape(-1), lo, hi, cover_addr, w, nw,
                                              words.reshape(-1), h)
        words = words.reshape(count, h, nw)
        active = (sw < per_warp) & (seg < count)
        at = np.where(active, seg, 0)
        x = words[at, :, lane]                                # (warps, 32, H)
        write = active                                        # the env keeps the clear's words
        if placed:
            write = active & valid[first + at] & ~keep[at]
        elif apply is not None:                               # the covers beside them
            cover, valid, cover_addr = apply
            covers = emulate_stage_words(cover.reshape(-1), lo, hi, cover_addr, w,
                                         nw).reshape(count, h, nw)
            y = covers[at, :, lane]
            hit = (np.bitwise_or.reduce(x & y, axis=2) != 0).astype(np.int64)
            overlap = _reduce(hit, sw, np.bitwise_or)
            write = active & valid[first + at] & (overlap == 0)
            x = np.where(write[..., None], x | y, x)           # placed in place
        cols = np.bitwise_and.reduce(x, axis=2)
        got = _popc(cols)
        cleared = np.full_like(x, -1)
        g = rs or 1
        c1 = -(-32 * lane // rs) * rs if rs else 0
        k = np.zeros_like(cols)
        for w0 in range(0, h, win):
            w1 = min(w0 + win, h)
            full = sum(((x[..., r] | pad) == U32).astype(np.int64) << (r - w0)
                       for r in range(w0, w1))
            assert (full >> 32 == 0).all()                    # one 32-bit word a window
            rows_full = _reduce(full, sw, np.bitwise_and)
            k += _popc(rows_full)
            for r0 in range(w0, w1, g):
                rows_here = min(g, w1 - r0)
                reg = np.zeros_like(cols)
                if rs:
                    band = np.bitwise_and.reduce(x[..., r0 : r0 + rows_here], axis=2)
                    hi_word = np.where(lane + 1 < nw, _shfl_down(band, l), 0)
                    spill = np.zeros_like(cols)
                    if rows_here == rs:
                        for c0 in c1 + rs * np.arange(-(-32 // rs) + 1)[:, None]:
                            ok = (c0 < 32 * (lane + 1)) & (c0 + rs <= w)
                            b = np.where(ok, c0 - 32 * lane, 0)
                            hit = ok & ((_fshr(band, hi_word, b) & tile0) == tile0)
                            reg |= np.where(hit, (tile0 << b) & U32, 0)
                            spill |= np.where(hit & (b + rs > 32), tile0 >> (32 - b), 0)
                            got += hit
                    reg |= np.where(lane > 0, _shfl_up(spill, l), 0)
                for r in range(r0, r0 + rows_here):
                    cleared[..., r] = np.where((rows_full >> (r - w0)) & 1, 0,
                                               x[..., r] & ~(cols | reg) & U32)
        k = k + _reduce(got, sw, np.add)
        staged = np.full(per_block * h * nw, -1, np.int64)
        for r in range(h):                                    # an illegal env: as staged
            staged[((seg * h + r) * nw + lane)[active]] = np.where(
                write, cleared[..., r], x[..., r])[active]
        head = active & (lane == 0)
        assert (ks[first + seg[head]] == -1).all()            # one lane 0 writes k
        ks[first + seg[head]] = np.where(write, k, 0)[head]
        legals[first + seg[head]] = write[head]
        if placed:                                            # lane 0 marks an illegal env
            keep[seg[head & ~write]] = True
            emulate_store_apply_words(staged, keep, board.reshape(-1), addr, out, lo,
                                      count * hw, w, nw, h)
        else:
            emulate_store_tall(staged, out, lo, count * hw, w, nw)
    assert (out < 2).all() and (ks >= 0).all()
    if apply is None:
        return out.reshape(n, hw), ks.astype(np.int32)
    assert (legals >= 0).all()
    return out.reshape(n, hw), ks.astype(np.int32), legals.astype(bool)


def emulate_store_apply_words(rows, keep, src, addr, out, at, nbytes, width, nw, height):
    """csrc/clear.cu store_apply_words: ``emulate_store_tall``'s store of
    the staged rows (``store_words_n``), but the bytes of an env marked in
    ``keep`` come from its input ``src`` (which starts ``addr`` bytes past a
    16-byte boundary; ``out`` starts on one): a vector wholly in marked
    envs is one uint4 copy where both share their offset, a vector wholly
    in others the words' spread, any other vector, the head and the tail
    byte by byte."""
    head = min((16 - at % 16) % 16, nbytes)
    nvec = (nbytes - head) // 16
    same = addr % 16 == 0

    def env(q):
        return int(_small_div(_small_div(q, width), height))

    def bit(q):
        row = int(_small_div(q, width))
        c = q - row * width
        assert rows[row * nw + (c >> 5)] >= 0
        return (int(rows[row * nw + (c >> 5)]) >> (c & 31)) & 1

    for v in range(nvec):
        q = head + 16 * v
        assert (at + q) % 16 == 0 and (out[at + q : at + q + 16] == 2).all()
        k0, k1 = keep[env(q)], keep[env(q + 15)]
        if k0 and k1 and same:
            assert (addr + at + q) % 16 == 0                 # the uint4 load's alignment
            out[at + q : at + q + 16] = src[at + q : at + q + 16]
            continue
        # store_words_n's 16 bits: the funnel-shifted word pair holding
        # column c, and the next row's first word where fewer than 16 are left
        row = int(_small_div(q, width))
        c = q - row * width
        wd = c >> 5
        lo, hi = rows[row * nw + wd], rows[row * nw + wd + 1] if wd + 1 < nw else 0
        assert lo >= 0 and hi >= 0
        bits = int(_fshr(lo, hi, c & 31))
        if width - c < 16:
            assert rows[(row + 1) * nw] >= 0
            bits |= (int(rows[(row + 1) * nw]) << (width - c)) & U32
        for j in range(16):
            out[at + q + j] = src[at + q + j] if keep[env(q + j)] else (bits >> j) & 1
    for j in range(nbytes - 16 * nvec):
        q = j if j < head else j + 16 * nvec
        assert out[at + q] == 2
        out[at + q] = src[at + q] if keep[env(q)] else bit(q)


def emulate_apply_xwide_kernel(cfg, board, cover, valid, ak, addr=0, cover_addr=0):
    """csrc/clear.cu clear_xwide_kernel's apply instance on ``ak``'s launch
    shape (``emulate_clear_xwide_kernel``): (board, k, legal)."""
    return emulate_clear_xwide_kernel(cfg, board, ak, addr, (cover, valid, cover_addr))


@functools.cache
def jax_mask_engine(case):
    return jax_make_env(_pair(case)[0], state_impl="u8", mask_impl="shift")


@pytest.mark.parametrize("case", XWIDE)
def test_xwide_mask_matches_jax_mask(case):
    """K1 on rows of more than 128 cells: the wrapper (plain version on the
    CPU) against the JAX u8 engine's shift mask on the envs whose hand ids
    lie in [0, P], and the xwide kernel's emulation against the wrapper on
    every env (ids outside [0, P) read as empty slots): pieces across word
    borders, up to the right edge, a bar on a board of word borders, a full
    board and an empty one."""
    _, ct = _pair(case)
    rng = np.random.default_rng(21)
    board = xwide_cells(ct, N, rng, fill=0.3)
    queue = xwide_hands(ct, N, rng)
    t = rules.tables_for(ct)
    dealt = ((queue >= 0) & (queue <= t.num_pieces)).all(axis=1)
    want = np.asarray(jax_mask_engine(case).action_mask(jnp.asarray(board), jnp.asarray(queue)))
    mk = MaskKernel(ct, "cpu")
    assert (mk.kind, mk.name, mk.shape) == ("xwide", "mask_xwide", xwide_launch_shape(ct))
    np.testing.assert_array_equal(mk.piece_table.numpy(), piece_rows_table(ct))
    got = mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy()
    np.testing.assert_array_equal(got[dealt], want[dealt])
    np.testing.assert_array_equal(emulate_mask_xwide_kernel(ct, board, queue, mk), got)
    hw = ct.num_cells
    assert 0 < got.mean() < 1 and not got[[0, N - 1]].any() and not got[[1, 2], :hw].any()
    # the bar on word borders: legal only where it spans no word's first
    # cell (at every border, from each of its cells)
    bar = got[5, :hw].reshape(ct.height, ct.width)
    bw = t.piece_w[bar_piece(t)]
    cells = np.arange(ct.width - bw + 1)[:, None] + np.arange(bw)
    free = ~((cells % 32 == 0) & (cells > 0)).any(axis=1)
    np.testing.assert_array_equal(bar[:, : ct.width - bw + 1],
                                  np.broadcast_to(free, (ct.height, len(free))))
    assert not bar[:, ct.width - bw + 1 :].any() and free.any() and not free.all()
    # the empty board: a piece's anchors up to the right and bottom edges
    pid = int(queue[N - 2, 0])
    if pid < t.num_pieces:
        anchors = got[N - 2, :hw].reshape(ct.height, ct.width)
        ph, pw = t.piece_h[pid], t.piece_w[pid]
        assert anchors[: ct.height - ph + 1, : ct.width - pw + 1].all()
        assert anchors.sum() == max(ct.height - ph + 1, 0) * (ct.width - pw + 1)
    assert mk.xwide_launches == mk.general_launches == 0


@pytest.mark.parametrize("case", ["8x136", "9x135r3", "2x1024"])
@pytest.mark.parametrize("addr", [3, 13])
def test_xwide_mask_emulation_takes_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary: the xwide mask's emulation
    stages an unaligned head and tail byte by byte (a block's output span
    starts off a boundary too: 136 and 135 cells a row) and still equals the
    plain version."""
    _, ct = _pair(case)
    rng = np.random.default_rng(addr)
    board = xwide_cells(ct, N, rng, fill=0.4)
    queue = xwide_hands(ct, N, rng)
    mk = MaskKernel(ct, "cpu")
    np.testing.assert_array_equal(
        emulate_mask_xwide_kernel(ct, board, queue, mk, addr),
        mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy())


@pytest.mark.parametrize("case", XWIDE)
def test_xwide_clear_matches_jax_clear_kernel(case):
    """K3 on rows of more than 128 cells: the Pallas clear kernel in
    interpret mode, the JAX u8 engine's ``clear_scan``, the wrapper (plain
    version on the CPU) and the xwide kernel's emulation, bit-equal: full
    first and last rows, full columns either side of a word border and at
    the right edge, a row full but for one cell, 3x3 regions across word
    borders, a full board (k = H + W + regions) and an empty one."""
    cj, ct = _pair(case)
    board = xwide_cells(ct, N, np.random.default_rng(22), fill=0.6)
    want = [np.asarray(x) for x in jk.ClearScanKernel(cj, tile_n=N)(
        jnp.asarray(board), interpret=True)]
    engine = jax_make_env(cj, state_impl="u8").clear_scan(jnp.asarray(board))
    ck = ClearScanKernel(ct, "cpu")
    assert (ck.kind, ck.name, ck.shape) == ("xwide", "clear_xwide", xwide_launch_shape(ct))
    got = ck(torch.as_tensor(board))
    emu = emulate_clear_xwide_kernel(ct, board, ck)
    for i, name in enumerate(("board", "k")):
        np.testing.assert_array_equal(np.asarray(engine[i]), want[i], name)
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    h, w = ct.height, ct.width
    k, cleared = want[1], want[0].reshape(N, h, w)
    regions = (h // ct.region_size) * (w // ct.region_size) if ct.region_clear else 0
    assert k[N - 1] == h + w + regions and not cleared[N - 1].any()
    assert k[N - 2] == 0
    assert k[1] >= 1 and not cleared[1, 0].any() and k[2] >= 1 and not cleared[2, h - 1].any()
    assert k[3] >= 3 and not cleared[3][:, [31, 32, w - 1]].any()
    if ct.region_clear:
        assert k[6] >= 2 and not cleared[6, 0:3, 30:33].any() and not cleared[6, 3:6, 63:66].any()
    assert ck.xwide_launches == ck.general_launches == 0


@pytest.mark.parametrize("case", ["8x136", "9x135r3", "3x320"])
@pytest.mark.parametrize("addr", [3, 13])
def test_xwide_clear_emulation_takes_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary: the xwide clear's emulation
    stages an unaligned head and tail byte by byte and still equals the
    plain version."""
    _, ct = _pair(case)
    board = xwide_cells(ct, N, np.random.default_rng(addr), fill=0.55)
    ck = ClearScanKernel(ct, "cpu")
    for e, p in zip(emulate_clear_xwide_kernel(ct, board, ck, addr), ck(torch.as_tensor(board))):
        np.testing.assert_array_equal(e, p.numpy())


def test_xwide_launch_shapes_fit():
    """The xwide launch shape on boards of 1 to 1500 rows of 129 to 1024
    cells, with hands of one and three: 32 // NW segments a warp and
    ``XWIDE_WARPS`` warps wherever they fit, whose shared memory (the
    mask's or the clear's, the larger: row words only, no staged bytes; the
    mask's legal rows over its board rows where S = 1) fits 48 KB on every
    board of at most 32 rows; on taller boards the most warps, at most
    ``XWIDE_WARPS``, whose block fits what a block may opt in to, and None
    only where one warp does not; a block's staged and stored bytes under
    the 2^21 that ``small_div``'s proof needs.  No shape outside
    128 < W <= 1024."""
    tall = 0
    for h in (1, 2, 3, 8, 9, 16, 31, 32, 33, 36, 40, 64, 66, 100, 128, 129, 130, 257, 512,
              1000, 1500):
        for w in (129, 135, 136, 160, 255, 256, 320, 500, 513, 1000, 1024):
            for s in (1, 3):
                cfg = tcfg.EnvConfig(height=h, width=w, queue_size=s)
                per_warp = 32 // -(-w // 32)
                shape = xwide_launch_shape(cfg)
                most = per_warp if s == 1 else max(per_warp, (per_warp + s - 1) // s + 1)
                if shape is None:
                    assert (xwide_smem_bytes(cfg, per_warp) > SMEM_OPT_IN
                            or most * cfg.num_cells >= 1 << 21)
                    continue
                assert shape[0] == per_warp and 1 <= shape[1] <= XWIDE_WARPS
                per_block = per_warp * shape[1]
                smem = xwide_smem_bytes(cfg, per_block)
                most = per_block if s == 1 else max(per_block, (per_block + s - 1) // s + 1)
                assert smem <= SMEM_OPT_IN and most * cfg.num_cells < 1 << 21
                if h <= 32:
                    assert shape[1] == XWIDE_WARPS and smem <= 36 * 1024
                elif shape[1] < XWIDE_WARPS:  # the next warp would not fit
                    bigger = per_block + per_warp
                    most = bigger if s == 1 else max(bigger, (bigger + s - 1) // s + 1)
                    assert (xwide_smem_bytes(cfg, bigger) > SMEM_OPT_IN
                            or most * cfg.num_cells >= 1 << 21)
                tall += h > 32
    assert tall > 100
    # the mask's legal rows over its board rows at S = 1: half the block
    cfg = tcfg.EnvConfig(height=40, width=136)
    assert xwide_launch_shape(cfg) == (6, XWIDE_WARPS)
    assert xwide_smem_bytes(cfg, 24) == 19200
    assert xwide_smem_bytes(dataclasses.replace(cfg, queue_size=3), 24) == 4 * (24 + 9) * 200
    for shape in (dict(height=8, width=128), dict(height=1, width=XWIDE_SEGMENT + 32),
                  dict(height=40, width=XWIDE_SEGMENT + 1)):
        assert xwide_launch_shape(tcfg.EnvConfig(**shape)) is None


@pytest.mark.parametrize("name", ["mask_xwide", "clear_xwide"])
def test_xwide_kernels_are_bytes_bound_on_8x136(name):
    """The xwide mask and clear at N = 49152 on 8x136 move the general
    kernels' bytes (2180 B an env: the board and the hand id in, the mask
    or the cleared board and k out), 0.031985 ms at 3.35 TB/s, above their
    operations at the integer rate."""
    from blockpuzzle_tpu_torch.utils.bounds import bound

    cfg, n = tcfg.EnvConfig(height=8, width=136), 49152
    hw = cfg.num_cells
    board, queue = torch.zeros(n, hw, dtype=torch.uint8), torch.zeros(n, 1, dtype=torch.int32)
    if name == "mask_xwide":
        inputs, outputs = (board, queue), (torch.zeros(n, hw, dtype=torch.bool),)
    else:
        inputs, outputs = (board,), (board, torch.zeros(n, dtype=torch.int32))
    nbytes, ops = COSTS[name](cfg, inputs, outputs)
    general, _ = COSTS[name.replace("_xwide", "_general")](cfg, inputs, outputs)
    assert nbytes == general == 2180 * n
    b = bound(list(inputs) + list(outputs), ops)
    assert b["bound_by"] == "bytes" and round(b["bound_ms"], 6) == 0.031985


@pytest.mark.parametrize("case", XWIDE)
def test_xwide_apply_matches_pallas_apply_kernel(case):
    """K2 on rows of more than 128 cells: the Pallas apply kernel in
    interpret mode, the wrapper (plain version on the CPU) and the xwide
    kernel's apply instance's emulation, bit-equal, on ``apply_cases``:
    legal and illegal actions, an invalid anchor, an action that completes
    a row, one over a full row (illegal: a strict no-op although the row is
    full), on 9x135 one that completes a 3x3 region across the first word
    border (columns 30..32), a full board and an empty one."""
    cj, ct = _pair(case)
    board, cover, valid = apply_cases(ct, N, np.random.default_rng(23))
    want = [np.asarray(x) for x in jk.ApplyKernel(cj, tile_n=N)(
        jnp.asarray(board), jnp.asarray(cover), jnp.asarray(valid), interpret=True)]
    ak = ApplyKernel(ct, "cpu")
    assert (ak.kind, ak.name, ak.shape) == ("xwide", "apply_xwide", xwide_launch_shape(ct))
    got = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    emu = emulate_apply_xwide_kernel(ct, board, cover, valid, ak)
    for i, name in enumerate(("board", "k", "legal")):
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    assert_apply_cases(ct, board, want)
    assert ak.xwide_launches == ak.general_launches == 0


@pytest.mark.parametrize("case", ["8x136", "9x135r3", "2x1024"])
@pytest.mark.parametrize("addr", [3, 13])
def test_xwide_apply_emulation_takes_any_address(case, addr):
    """Boards and covers that start off a 16-byte boundary, each at its own
    offset: the xwide apply's emulation loads both as row words, the
    unaligned heads and tails byte by byte, and still equals the plain
    version."""
    _, ct = _pair(case)
    board, cover, valid = apply_cases(ct, N, np.random.default_rng(addr))
    ak = ApplyKernel(ct, "cpu")
    want = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    assert want[2].any() and not want[2].all()
    for cover_addr in (addr, (addr + 7) % 16):
        emu = emulate_apply_xwide_kernel(ct, board, cover, valid, ak, addr, cover_addr)
        for e, p in zip(emu, want):
            np.testing.assert_array_equal(e, p.numpy())


def test_xwide_apply_takes_the_clear_launch_shape():
    """The xwide apply on boards of 1 to 1000 rows of 129 to 1024 cells: on
    a board of one window of rows its block holds two arrays of row words
    (board and cover) of NW words a row, at most 32 KB, and it keeps the
    clear's launch shape; on a taller one (``xwide_windows``) its block
    holds the placed rows and a word an env (``xwide_apply_smem_bytes``),
    ``XWIDE_APPLY_WARPS`` warp a block wherever one warp fits; above 1024
    cells a row the xwide apply's long-row instance (one env a warp,
    ``test_torch_xwide_rows.py``), and the general apply where one warp does
    not fit."""
    for h in (1, 2, 3, 8, 9, 16, 31, 32, 33, 40, 66, 130, 600, 1000):
        for w in (129, 135, 136, 160, 255, 256, 320, 500, 513, 1000, 1024):
            cfg = tcfg.EnvConfig(height=h, width=w)
            shape = apply_launch_shape(cfg)
            nw, per_warp = -(-w // 32), 32 // -(-w // 32)
            tall = xwide_windows(cfg)
            assert tall == (h > 32)
            if shape is None:  # one warp's block does not fit
                assert tall and (xwide_apply_smem_bytes(cfg, per_warp) > SMEM_OPT_IN
                                 or per_warp * cfg.num_cells >= 1 << 21)
                continue
            # a block's envs' board and cover rows of NW words, or above one
            # window their placed rows and a word an env (``csrc/clear.cu``
            # ``xwide``)
            per_block = shape[0] * shape[1]
            rows = 4 * per_block * h * nw
            smem = rows + 4 * per_block if tall else 2 * rows
            assert smem == xwide_apply_smem_bytes(cfg, per_block) <= SMEM_OPT_IN
            if tall:
                assert shape == (per_warp, XWIDE_APPLY_WARPS)
            else:
                assert shape == xwide_launch_shape(cfg) and smem <= 32 * 1024
    cfg = tcfg.EnvConfig(height=36, width=135, region_clear=True, region_size=3)
    assert xwide_windows(cfg) and not xwide_windows(dataclasses.replace(cfg, height=30))
    assert apply_launch_shape(tcfg.EnvConfig(height=33, width=136)) == (6, XWIDE_APPLY_WARPS)
    cfg = tcfg.EnvConfig(height=2, width=1056, piece_set="mini5")
    assert apply_launch_shape(cfg) == (1, XWIDE_WARPS)
    ak = ApplyKernel(cfg, "cpu")
    assert (ak.kind, ak.name, ak.shape) == ("xwide", "apply_xwide_long", (1, XWIDE_WARPS))


def test_xwide_apply_is_bytes_bound_on_8x136():
    """The xwide apply at N = 49152 on 8x136 moves the general apply's
    bytes (3270 B an env: board and cover in, a valid byte; board, k and
    legal out), 0.047978 ms at 3.35 TB/s, above its 6120 operations an env
    (both boards loaded as row words, 15 operations a word, one an output
    byte) at the integer rate."""
    from blockpuzzle_tpu_torch.utils.bounds import bound

    cfg, n = tcfg.EnvConfig(height=8, width=136), 49152
    hw = cfg.num_cells
    board, valid = torch.zeros(n, hw, dtype=torch.uint8), torch.zeros(n, dtype=torch.bool)
    inputs = (board, board, valid)
    outputs = (board, torch.zeros(n, dtype=torch.int32), valid)
    nbytes, ops = COSTS["apply_xwide"](cfg, inputs, outputs)
    general, _ = COSTS["apply_general"](cfg, inputs, outputs)
    assert nbytes == general == 3270 * n and ops == 6120 * n
    b = bound(list(inputs) + list(outputs), ops)
    assert b["bound_by"] == "bytes" and round(b["bound_ms"], 6) == 0.047978
