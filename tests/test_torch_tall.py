"""The kernels of boards taller than 32 rows on the CPU, against the JAX
package.

The JAX engine's default state is packed on every board of at most 32
columns, whatever its height; the port's packed kernels take one row a
lane, so boards of 33 to 128 rows take its tall kernels (the apply one
warp a board, lane l holding rows l + 32 j in slot j; the mask and its
words entry a segment of ceil(H / K) threads an env-slot, K anchor rows a
thread, rows below read from the boards staged in shared memory) and
taller boards its general ones (a warp an env or env-slot over windows of
rows).  The u8 mask (K1) and clear (K3) have tall kernels of the apply's
layout, on rows of up to four words.

Numpy emulations of each new CUDA kernel's lane and slot logic (every
lane of a warp at once, as (warps, NR, 32) arrays; a row below row r comes
from lane (l + d) mod 32, from slot j + 1 across the seam; the tall
packed mask's every thread of a block or warp at once), fed the tables
and launch shapes the wrappers hand the kernels, are held bit-equal to the
plain versions and to the JAX package: the packed engine's
``_cover_words``/``_clear_scan_packed`` block, ``_bitboard_mask_from_words``
and ``legal_words`` for B1, B7 and B7w; the Pallas mask and clear kernels
in interpret mode (or, where the mask's one-hot tables would take
hundreds of MB, the JAX u8 engine's shift mask) and the JAX u8 engine's
``clear_scan`` for K1 and K3.  The kernels themselves run only on the
card (``chip_smoke.py``, the ``gpu`` tests of test_torch_rollout.py).
Everything is integer or bool and must be bit-equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockpuzzle_tpu import config as jcfg
from blockpuzzle_tpu import kernels as jk
from blockpuzzle_tpu.env import make_env as jax_make_env
from blockpuzzle_tpu.env import words as jwords
from blockpuzzle_tpu_torch import config as tcfg
from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.kernels import (
    ApplyKernel,
    ClearScanKernel,
    LegalityKernel,
    MaskKernel,
    PackedApplyKernel,
    PackedMaskKernel,
    _build,
)
from blockpuzzle_tpu_torch.kernels.packed import (
    ANCHOR_ROWS, ANCHOR_THREADS, MASK_ANCHOR_ROWS, MAX_ANCHOR_THREADS, SMEM_OPT_IN, U32,
    anchor_launch_shape,
    apply_launch_shape, apply_smem_bytes, bitboard_tables, deep_launch_shape,
    tall_block_warps, tall_launch_shape, tall_smem_bytes, u8_kind, u8_launch_shape,
    xwide_launch_shape,
)
from test_torch_kernels import (
    _fshr, _shr_words, apply_cases, assert_apply_cases, emulate_pack_row, emulate_pack_words,
    emulate_smear_words, emulate_stage_bytes,
)
from test_torch_packed import (
    _popc, _shl32, _small_div, _spread4, chosen_actions, crafted_cells, jax_apply,
    np_words,
)

# packed boards (W <= 32) of more than 32 rows: two, three and four slots a
# lane; 3x3 regions whose band 30..32 crosses the seam (lanes 30, 31 of slot
# 0, lane 0 of slot 1) and a hand of three; 130 rows take the general kernels
PACKED_TALL = {"tall33": dict(height=33, width=9),
               "tall36r3": dict(height=36, width=9, region_clear=True, region_size=3,
                                queue_size=3),
               "tall64": dict(height=64, width=8),
               "tall128": dict(height=128, width=10)}
PACKED_GENERAL = {"tall130": dict(height=130, width=8)}
# u8 boards of more than 32 rows: one word a row (33x9, 36x9 with regions),
# two (40x40, JAX's u8 default there) and four (33x128)
U8_TALL = {"tall33": dict(height=33, width=9),
           "tall36r3": PACKED_TALL["tall36r3"],
           "tall40x40": dict(height=40, width=40),
           "tall33x128": dict(height=33, width=128)}
N = 13


def _pair(shape):
    return jcfg.EnvConfig(**shape), tcfg.EnvConfig(**shape)


@functools.cache
def jax_packed(case):
    shape = {**PACKED_TALL, **PACKED_GENERAL}[case]
    return jax_make_env(jcfg.EnvConfig(**shape), state_impl="packed")


def tall_cells(cfg, n, rng, fill=0.45):
    """``crafted_cells`` plus rows and regions at the seams: a full row 31
    and a full row 32 (slot 0's last lane, slot 1's first), rows 30..32 of
    columns 0..2 full (a region across the seam where regions are 3x3), a
    full column 8, and a row 32 full but for its first cell."""
    cells = crafted_cells(cfg, n, rng, fill)
    cells[1::5, 31, :] = 1
    cells[2::5, 32, :] = 1
    cells[3::5, 30:33, 0:3] = 1
    cells[4::5, :, 8 % cfg.width] = 1
    cells[5::7, 32, 1:] = 1
    cells[5::7, 32, 0] = 0
    return cells


# --------------------------------------------------------------------------
# the lane and slot layout of the tall kernels: one warp a board, values
# as (warps, NR, 32) int64 arrays holding uint32 bits, lane l of slot j
# holding row l + 32 j
# --------------------------------------------------------------------------

LANE = np.arange(32)


def _slot_rows(nr):
    return LANE[None, :] + 32 * np.arange(nr)[:, None]        # (NR, 32)


def _rows_below(v, d, past):
    """bit_rows.cuh rows_below: row r + d (0 <= d < 32) of every lane and
    slot: one shuffle a slot from lane (l + d) mod 32, slot j + 1 across the
    seam (l + d >= 32), ``past`` beyond the last slot."""
    assert 0 <= d < 32
    s = v[:, :, (LANE + d) % 32]
    nxt = np.concatenate([s[:, 1:], np.full_like(s[:, :1], past)], axis=1)
    return np.where(LANE + d >= 32, nxt, s)


def _rows_above(v, e):
    """The row e = r % rs above (0 <= e < 32, per lane and slot): lane
    (l - e) mod 32, slot j - 1 across the seam (l < e), by two shuffles a
    slot (slot 0's first reads zeros, and never wraps)."""
    src = (LANE - e) % 32
    here = np.take_along_axis(v, np.broadcast_to(src, v.shape), axis=2)
    prev = np.concatenate([np.zeros_like(v[:, :1]), v[:, :-1]], axis=1)
    up = np.take_along_axis(prev, np.broadcast_to(src, v.shape), axis=2)
    assert not (LANE[None, :] < e)[0].any()                  # slot 0 never wraps
    return np.where(LANE < e, up, here)


def _full_fields(band, w, rs):
    """bit_rows.cuh full_fields on ``band``, a list of NW words a row (any
    shape): each rs-bit field from column 0 up, read from the funnel-shifted
    pair of words holding its first column and marked in both where it
    straddles them.  Returns the marked words and the count of full fields,
    for every row."""
    nw = len(band)
    tile0, c0 = (1 << rs) - 1, 0
    reg, tiles = [np.zeros_like(a) for a in band], np.zeros_like(band[0])
    for i in range(nw):
        while c0 < 32 * (i + 1) and c0 + rs <= w:
            b = c0 - 32 * i
            hit = (_fshr(band[i], band[i + 1] if i + 1 < nw else 0, b) & tile0) == tile0
            reg[i] |= np.where(hit, (tile0 << b) & U32, 0)
            if i + 1 < nw and b + rs > 32:
                reg[i + 1] |= np.where(hit, tile0 >> (32 - b), 0)
            tiles += hit
            c0 += rs
    return reg, tiles


def emulate_clear_tall(x, active, h, w, rs):
    """bit_rows.cuh clear_tall on ``x``, a list of NW (warps, NR, 32) words
    a row (rows >= H all ones), ``active`` (warps,): full rows by a ballot a
    slot, columns by ANDing a lane's slots and the warp, each row's band
    AND from the rs - 1 rows below it, a band's first row testing its
    fields (read from funnel-shifted word pairs) and every row taking them
    from its first row, e = r % rs rows above.  Returns the cleared words
    and k (warps,)."""
    nw, nr = len(x), x[0].shape[1]
    rows = _slot_rows(nr)
    tail = w - 32 * (nw - 1)
    colmask = [U32] * (nw - 1) + [(1 << tail) - 1 if tail < 32 else U32]
    full = np.logical_and.reduce([x[i] == colmask[i] for i in range(nw)])
    k = (full & (rows < h) & active[:, None, None]).sum(axis=(1, 2))   # popc(ballot)
    cols = [np.bitwise_and.reduce(a.reshape(len(a), -1), axis=1) for a in x]
    k = k + sum(_popc(c) for c in cols)
    reg = [np.zeros_like(a) for a in x]
    if rs:
        band = [a.copy() for a in x]
        for d in range(1, rs):
            band = [b & _rows_below(a, d, U32) for a, b in zip(x, band)]
        # r % rs stepped slot to slot as the kernel does
        e = np.empty((nr, 32), np.int64)
        e[0] = LANE % rs
        for j in range(1, nr):
            e[j] = e[j - 1] + 32 % rs
            e[j] -= np.where(e[j] >= rs, rs, 0)
        assert (e == rows % rs).all()
        head = (e == 0) & (rows + rs <= h)
        fields, tiles = _full_fields(band, w, rs)
        k = k + np.where(head, tiles, 0).sum(axis=(1, 2))
        reg = [_rows_above(np.where(head, a, 0), e) for a in fields]
    cleared = [x[i] & ~(np.where(full, colmask[i], 0) | cols[i][:, None, None] | reg[i]) & U32
               for i in range(nw)]
    return cleared, k


def emulate_store_tall(rows, out, at, nbytes, width, nw):
    """bit_rows.cuh store_tall: bytes to out[at ...] from any offset, the
    head up to the first 16-byte boundary and the tail byte by byte, each
    vector between from the staged rows of ``nw`` words: up to 16 rows where
    a row is one word, the funnel-shifted word pair and the next row's first
    word where it is more."""
    head = min((16 - at % 16) % 16, nbytes)
    nvec = (nbytes - head) // 16
    for v in range(nvec):
        q = head + 16 * v
        assert (at + q) % 16 == 0                   # the uint4 stores' alignment
        row = int(_small_div(q, width))
        c = q - row * width
        if nw == 1:
            got, bits = 0, 0
            while got < 16:
                assert rows[row] >= 0
                bits |= (int(rows[row]) >> c) << got
                got, row, c = got + width - c, row + 1, 0
        else:
            wd = c >> 5
            lo, hi = rows[row * nw + wd], rows[row * nw + wd + 1] if wd + 1 < nw else 0
            assert lo >= 0 and hi >= 0
            bits = int(_fshr(lo, hi, c & 31))
            if width - c < 16:
                assert rows[(row + 1) * nw] >= 0
                bits |= (int(rows[(row + 1) * nw]) << (width - c)) & U32
        vec = [_spread4(bits >> (4 * i)) for i in range(4)]
        assert (out[at + q : at + q + 16] == 2).all()  # written once
        out[at + q : at + q + 16] = np.array(vec, "<u4").view(np.uint8)
    for j in range(nbytes - 16 * nvec):
        q = j if j < head else j + 16 * nvec
        row = int(_small_div(q, width))
        c = q - row * width
        assert rows[row * nw + (c >> 5)] >= 0 and out[at + q] == 2
        out[at + q] = (int(rows[row * nw + (c >> 5)]) >> (c & 31)) & 1


# ----------------------------------------------------- packed, tall ----


def emulate_packed_apply_tall(cfg, words, attrs, r, c, valid):
    """csrc/packed_tall.cu packed_apply_tall_kernel: a warp an env, each lane
    its rows' words and footprint words, overlap by ``__any_sync``, the
    placed board through ``clear_tall``, the input written back where the
    action is illegal."""
    h, n, nr = cfg.height, len(words), -(-cfg.height // 32)
    rs = cfg.region_size if cfg.region_clear else 0
    rows = _slot_rows(nr)[None]                               # (1, NR, 32)
    inb = rows < h
    e = np.arange(n)[:, None, None]
    x64 = np.where(inb, words.astype(np.int64)[e, np.minimum(rows, h - 1)], 0)
    cover = np.zeros_like(x64)
    for j in range(2):
        row0 = (r + attrs[:, 3 + 4 * j])[:, None, None]
        on = inb & (rows >= row0) & (rows < row0 + attrs[:, 5 + 4 * j, None, None])
        mask = _shl32((_shl32(1, attrs[:, 6 + 4 * j]) - 1) & U32, c + attrs[:, 4 + 4 * j])
        cover |= np.where(on, mask[:, None, None], 0)
    overlap = ((x64 & cover) != 0).any(axis=(1, 2))          # __any_sync
    legal = valid & ~overlap
    w = np.where(inb, x64 | cover, U32)
    (cleared,), k = emulate_clear_tall([w], np.ones(n, bool), h, cfg.width, rs)
    stored = np.where(legal[:, None, None], cleared, x64)
    out = np.full((n, h), -1, np.int64)
    ee, jj, ll = np.nonzero(np.broadcast_to(inb, stored.shape))
    out[ee, rows[0, jj, ll]] = stored[ee, jj, ll]
    assert (out >= 0).all()
    return out, np.where(legal, k, 0).astype(np.int32), legal


def anchor_smem_bytes(cfg, envs, reach, words=False):
    """Shared memory of a block of ``envs`` env-slots of the tall packed
    mask (``words``: its words entry), footprints spanning ``reach`` =
    nwords * fpw rows, as csrc/packed_tall.cu ``launch_anchor`` counts it:
    for each group of threads that stage and store together (the block, or
    each warp where a warp holds whole segments) the boards of the most
    envs its env-slots can read, each followed by the full rows a footprint
    reaches past its bottom, then the mask's legal rows, a 32-bit word a
    row."""
    s, h = cfg.queue_size, cfg.height
    k = ANCHOR_ROWS if words else MASK_ANCHOR_ROWS
    seg = -(-h // k)
    stride = reach - 1 + k * seg
    warp = 32 % seg == 0 and envs % (32 // seg) == 0
    per, groups = (32 // seg, envs * seg // 32) if warp else (envs, 1)
    return 4 * groups * (((per + s - 2) // s + 1) * stride + (0 if words else per * h))


def emulate_packed_anchor(cfg, words, queue, mk, envs=None, entry="mask"):
    """csrc/packed_tall.cu packed_anchor_kernel on the 32-bit tables
    ``PackedMaskKernel`` hands it, K = ``MASK_ANCHOR_ROWS`` anchor rows a
    thread (the words instance: ``ANCHOR_ROWS``)
    and ``envs`` env-slots a block E (the wrapper's by default), each
    group of threads that stage and store together in turn, all its threads
    at once: the block, or each warp where a warp holds whole segments (C
    divides 32 and E is a multiple of 32 / C).  Thread (e, c) of a segment
    of C = ceil(H / K) threads, e by the kernel's float reciprocal, holds
    rows c + C j of the group's env-slot es0 + e.  The group stages the
    boards of the envs its env-slots read, words[env0 * H ...] read once
    as one span (an env of S > 1 slots staged once; span row j, row j - v H
    of board v, at j + v pad), then each board's pad full rows, as far as a
    footprint reaches from the last slot's rows, at j + (v + 1) H for full
    row j - v pad of board v, each quotient the kernel's; a thread reads
    row + t of its env's staged board (full past the bottom, untested) and
    ORs it shifted right by each cell column of piece row t into the
    blocked bits of its K rows.
    The mask (``entry="mask"``) stages the legal rows and stores the
    group's bytes from es0 * HW (``store_tall``: the head up to a 16-byte
    boundary and the last group's ragged tail byte by byte); the words
    instance (``"words"``) stores each live row's bits as the int64
    out[es * H + row]."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    k = ANCHOR_ROWS if entry == "words" else MASK_ANCHOR_ROWS
    envs = envs or mk.shape[0]
    seg = -(-h // k)
    threads = -(-envs * seg // 32) * 32
    assert threads <= MAX_ANCHOR_THREADS
    warp = 32 % seg == 0 and envs % (32 // seg) == 0
    per, gn = (32 // seg, 32) if warp else (envs, threads)
    stride = mk.tables.nwords * mk.tables.fpw - 1 + k * seg      # a board, its full rows
    pad = stride - h
    boards = (per + s - 2) // s + 1                             # the most envs a group reads
    assert 4 * (threads // gn) * (boards * stride + (per * h if entry == "mask" else 0)) == (
        anchor_smem_bytes(cfg, envs, mk.tables.nwords * mk.tables.fpw, entry == "words"))
    total, hw = len(words) * s, cfg.num_cells
    prow = mk.prow32.numpy().view(np.uint32).astype(np.int64)
    piece_w = mk.piece_w32.numpy()
    nwords, fpw = mk.tables.nwords, mk.tables.fpw
    full = ((1 << w) - 1) & U32
    x64 = words.astype(np.int64)
    ids = queue.reshape(-1)
    if entry == "words":
        out = np.full(total * h, -1, np.int64)                 # -1: never written
    else:
        out = np.full(total * hw, 2, np.uint8)                 # 2: never written
    e = _small_div(np.arange(gn), seg)
    c = np.arange(gn) - e * seg
    rows = c[None] + seg * np.arange(k)[:, None]               # (K, threads)
    for es0 in range(0, total, per):                           # each group's first
        count = min(per, total - es0)
        env0 = es0 // s
        nenv = (es0 + count - 1) // s - env0 + 1
        board = np.full(nenv * stride, -1, np.int64)           # -1: never staged
        j = np.arange(nenv * h)                                 # one contiguous read
        board[j + _small_div(j, h) * pad] = x64[env0 : env0 + nenv].reshape(-1)
        if pad:
            j = np.arange(nenv * pad)                           # no loads
            board[j + (_small_div(j, pad) + 1) * h] = full
        assert (board >= 0).all() and nenv <= boards
        live = e < count
        es = es0 + e
        pid = np.where(live, ids[np.minimum(es, total - 1)], -1)
        has = (pid >= 0) & (pid < mk.num_pieces)
        p = np.where(has, pid, 0)
        pw = np.where(has, piece_w[p], w + 1)                  # none: no anchor
        base = _small_div(es0 - env0 * s + e, s) * stride      # its env's board
        blocked = np.zeros((k, gn), np.int64)
        for t in range(nwords * fpw):
            m = np.where(live & (pw <= w), prow[p, t // fpw], 0)
            cells = (m >> ((t % fpw) * w)) & full              # piece row t
            y = board[np.where(live, base + rows + t, 0)]     # read by live threads
            for col in range(w):                                # each cell column
                blocked |= np.where((cells >> col) & 1, y >> col, 0)
        anchors = np.where(pw <= w, _shl32(1, np.maximum(w - pw + 1, 0)) - 1 & U32, 0)
        bits = ~blocked & anchors
        held = live & (rows < h)
        if entry == "words":
            at = (es * h + rows)[held]
            assert (out[at] == -1).all()                       # written once
            out[at] = bits[held]
        else:
            legal = np.full(per * h, -1, np.int64)
            legal[(e * h + rows)[held]] = bits[held]
            emulate_store_tall(legal, out, es0 * hw, count * hw, w, 1)
    if entry == "words":
        assert (out >= 0).all()
        return out.reshape(len(words), s * h)
    assert (out < 2).all()
    return out.reshape(len(words), s * hw).astype(bool)


def emulate_packed_anchor_words(cfg, words, queue, mk, envs=None):
    """The words instance of the tall mask (``emulate_packed_anchor``): (N,
    S*H) int64 legal row words."""
    return emulate_packed_anchor(cfg, words, queue, mk, envs, "words")


# -------------------------------------------------- packed, general ----


def emulate_packed_apply_deep(cfg, words, attrs, r, c, valid, staged=True):
    """csrc/packed_tall.cu packed_apply_general_kernel, every warp (env) at
    once: windows of cr rows (32, or 32 - 32 mod rs with regions), lane l
    row w0 + l for l < cr.  Pass 1 ORs in the footprint (the attrs row read
    once), gathers the overlap, ANDs the columns a lane and keeps the placed
    rows (``staged``: H words a warp, each read back by the lane that wrote
    it) or leaves pass 2 to read the input again; the warp's AND at the end.
    Pass 2, on a legal action: full rows by a ballot a window, each band's
    AND by rs shuffles from its lanes (all inside the window), its full
    tiles counted by its first row; else the input written back."""
    h, w, n = cfg.height, cfg.width, len(words)
    rs = cfg.region_size if cfg.region_clear else 0
    cr = 32 - 32 % rs if rs else 32
    x = words.astype(np.int64)
    row0 = [(r + attrs[:, 3 + 4 * j])[:, None] for j in range(2)]
    end = [row0[j] + attrs[:, 5 + 4 * j, None] for j in range(2)]
    mask = [_shl32((_shl32(1, attrs[:, 6 + 4 * j]) - 1) & U32,
                   c + attrs[:, 4 + 4 * j])[:, None] for j in range(2)]

    def cover(row):
        return np.bitwise_or.reduce(
            [np.where((row >= row0[j]) & (row < end[j]), mask[j], 0) for j in range(2)])

    lane = LANE < cr
    overlap, cols = np.zeros(n, bool), np.full((n, 32), U32)
    placed = np.full((n, h), -1, np.int64)                    # the warp's shared rows
    owner = np.full(h, -1)
    for w0 in range(0, h, cr):
        row = w0 + LANE
        live = lane & (row < h)
        xr = np.where(live, x[:, np.minimum(row, h - 1)], 0)
        pr = xr | cover(row)
        overlap |= ((xr & cover(row)) != 0)[:, live].any(axis=1)   # __any_sync
        cols = np.where(live, cols & pr, cols)
        if staged:
            placed[:, row[live]], owner[row[live]] = pr[:, live], LANE[live]
    legal = valid & ~overlap
    cols = np.bitwise_and.reduce(cols, axis=1)[:, None]       # __reduce_and_sync
    full = (1 << w) - 1
    e = LANE % rs if rs else np.zeros(32, np.int64)
    k, tiles = _popc(cols[:, 0]), np.zeros((n, 32), np.int64)
    out = np.full((n, h), -1, np.int64)
    for w0 in range(0, h, cr):
        row = w0 + LANE
        live = lane & (row < h)
        if staged:                                             # each lane its own rows
            assert (owner[row[live]] == LANE[live]).all()
            p = np.where(live, placed[:, np.minimum(row, h - 1)], U32)
        else:
            p = np.where(live, x[:, np.minimum(row, h - 1)] | cover(row), U32)
        assert (p >= 0).all()
        k = k + (live & (p == full)).sum(axis=1)              # popc(ballot)
        reg = np.zeros_like(p)
        if rs:
            src = LANE - e + np.arange(rs)[:, None]           # (rs, 32) source lanes
            assert (src[:, live] < cr).all()                  # a band inside its window
            band = np.bitwise_and.reduce(p[:, src % 32], axis=1)
            whole = live & (row - e + rs <= h)
            for i in range(0, w - rs + 1, rs):
                tile = ((1 << rs) - 1) << i
                hit = whole & ((band & tile) == tile)
                reg |= np.where(hit, tile, 0)
                tiles += hit & (e == 0)
        cleared = p & ~(np.where(p == full, full, 0) | cols | reg) & U32
        out[:, row[live]] = cleared[:, live]
    k = k + tiles.sum(axis=1)                                  # __reduce_add_sync
    assert (out >= 0).all()
    return (np.where(legal[:, None], out, x), np.where(legal, k, 0).astype(np.int32), legal)


def emulate_legal_general(cfg, words, queue, mk):
    """csrc/packed_tall.cu legal_row_general for every (env-slot, anchor
    row) thread: (N*S, H) legal bits, the rows read straight."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    prow = mk.prow32.numpy().view(np.uint32).astype(np.int64)
    piece_w = mk.piece_w32.numpy()
    full = (1 << w) - 1
    es = np.arange(len(words) * s)[:, None]
    row = np.arange(h)[None, :]
    pid = queue.reshape(-1)[es]
    has = (pid >= 0) & (pid < mk.num_pieces)
    p = np.where(has, pid, 0)
    ok = has & (piece_w[p] <= w)
    blocked = np.zeros((len(es), h), np.int64)
    x = words.astype(np.int64)[es[:, 0] // s]
    for k in range(mk.tables.nwords):
        wk = np.zeros_like(blocked)
        for f in range(mk.tables.fpw):
            t = row + k * mk.tables.fpw + f
            y = np.where(t < h, np.take_along_axis(x, np.minimum(t, h - 1).repeat(
                len(es), axis=0), axis=1), full)
            wk |= _shl32(y, f * w)
        m = prow[p, k]
        for bit in range(32):
            blocked |= np.where((m >> bit) & 1, wk >> bit, 0)
    anchors = _shl32(1, np.maximum(w - piece_w[p] + 1, 0)) - 1
    return np.where(ok, ~blocked & anchors & U32, 0)


# ------------------------------------------------------------ u8, tall ----


def _turns(per_warp, warps):
    """The env-slot (or env) of the block each warp holds in each of its
    ``per_warp`` turns, turn-major: it * warps + warp, as (E, 1, 1)."""
    return (np.arange(per_warp)[:, None] * warps + np.arange(warps)[None, :]).reshape(
        -1, 1, 1)


def emulate_mask_tall_kernel(cfg, board, queue, mk, addr=0):
    """csrc/mask.cu mask_tall_kernel on ``mk``'s piece table and launch
    shape: a warp an env-slot at a time, ``per_warp`` turns each from one
    staged span of the block's env-slots (every turn of every warp at once
    here), each lane packing its rows (NW words a row), each rectangle's
    vertical OR from the rows below (``rows_below``), its smear and dc shift
    on the NW-word rows, the legal rows staged and stored by
    ``store_tall``.  A turn's piece id comes from lane ``it`` of its warp,
    which loaded it before the block's barrier."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    hw, n, nw, nr = cfg.num_cells, len(board), -(-w // 32), -(-h // 32)
    pieces = mk.piece_table.numpy().astype(np.int64) & U32
    per_warp, warps = mk.shape
    per_block, total = per_warp * warps, n * s
    rows = _slot_rows(nr)[None]
    seg = _turns(per_warp, warps)
    out = np.full(total * hw, 2, np.uint8)                    # 2: never written
    for first in range(0, total, per_block):
        count = min(per_block, total - first)
        env0 = first // s
        buf, d = emulate_stage_bytes(
            board.reshape(-1), env0 * hw, ((first + count - 1) // s + 1) * hw, addr)
        active = seg < count
        # lane l of warp v: the id of the env-slot l * warps + v (turn l)
        lane_seg = LANE[None, :] * warps + np.arange(warps)[:, None]      # (warps, 32)
        pids = np.where((LANE < per_warp) & (lane_seg < count),
                        queue.reshape(-1)[first + np.minimum(lane_seg, count - 1)], -1)
        it, v = np.divmod(seg[:, 0, 0], warps)
        pid = pids[v, it][:, None, None]                      # __shfl_sync(pids, it)
        has = (pid >= 0) & (pid < mk.num_pieces)
        pc = np.where(has[..., None], pieces[np.where(has, pid, 0)],
                      np.array([h + 1, w + 1, 0, 0]))        # (warps, 1, 1, 4)
        env = _small_div(first - env0 * s + seg, s)
        live = np.broadcast_to(active & (rows < h), (per_block, nr, 32))
        at = np.broadcast_to(d + env * hw + np.minimum(rows, h - 1) * w, live.shape)
        x = [emulate_pack_row(buf, at + 32 * i, min(32, w - 32 * i), live)
             for i in range(nw)]
        r1, r2 = pc[..., 2], pc[..., 3]
        v1 = [np.zeros_like(a) for a in x]
        v2 = [np.zeros_like(a) for a in x]
        for t in range(mk.max_h):
            in1 = (t >= r1 & 0xFF) & (t - (r1 & 0xFF) < (r1 >> 16) & 0xFF)
            in2 = (t >= r2 & 0xFF) & (t - (r2 & 0xFF) < (r2 >> 16) & 0xFF)
            for i in range(nw):
                y = _rows_below(x[i], t, 0)
                v1[i] |= np.where(in1, y, 0)
                v2[i] |= np.where(in2, y, 0)
        b1 = _shr_words(emulate_smear_words(v1, r1 >> 24), (r1 >> 8) & 0xFF)
        b2 = _shr_words(emulate_smear_words(v2, r2 >> 24), (r2 >> 8) & 0xFF)
        anchors = w - pc[..., 1] + 1
        fits = (rows + pc[..., 0] <= h) & (anchors > 0)
        staged = np.full(per_block * h * nw, -1, np.int64)
        for i in range(nw):
            a = anchors - 32 * i
            span = np.where(a >= 32, U32, np.where(a > 0, (1 << np.clip(a, 0, 31)) - 1, 0))
            legal = np.where(fits, ~(b1[i] | b2[i]) & span, 0)
            at_row = np.broadcast_to((seg * h + rows) * nw + i, live.shape)
            staged[at_row[live]] = legal[live]
        emulate_store_tall(staged, out, first * hw, count * hw, w, nw)
    assert (out < 2).all()
    return out.reshape(n, s * hw).astype(bool)


def emulate_mask_deep_kernel(cfg, board, queue, mk, addr=0):
    """csrc/mask.cu mask_deep_kernel on ``mk``'s piece table and launch
    shape: ``emulate_mask_tall_kernel``'s blocks, turns and staging, each
    warp walking its env-slot's board in windows of 32 rows with two slots,
    rows 32 j + l and 32 (j + 1) + l (rows past the bottom packed as 0): the
    vertical OR from the rows below across the pair (``rows_below``), the
    smear and dc shift, the window's legal rows staged; then the second slot
    moves up and window j + 2 is packed into it.  A warp whose turn has no
    env-slot left stops."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    hw, n, nw = cfg.num_cells, len(board), -(-w // 32)
    assert mk.max_h <= 8                                      # r + t within two slots
    pieces = mk.piece_table.numpy().astype(np.int64) & U32
    per_warp, warps = mk.shape
    per_block, total = per_warp * warps, n * s
    out = np.full(total * hw, 2, np.uint8)                    # 2: never written
    for first in range(0, total, per_block):
        count = min(per_block, total - first)
        env0 = first // s
        buf, d = emulate_stage_bytes(
            board.reshape(-1), env0 * hw, ((first + count - 1) // s + 1) * hw, addr)
        seg = _turns(per_warp, warps)[:, 0]                    # (E, 1)
        seg = seg[seg[:, 0] < count]                           # the turns that run
        lane_seg = LANE[None, :] * warps + np.arange(warps)[:, None]      # (warps, 32)
        pids = np.where((LANE < per_warp) & (lane_seg < count),
                        queue.reshape(-1)[first + np.minimum(lane_seg, count - 1)], -1)
        it, v = np.divmod(seg[:, 0], warps)
        pid = pids[v, it][:, None]                             # __shfl_sync(pids, it)
        has = (pid >= 0) & (pid < mk.num_pieces)
        pc = np.where(has[..., None], pieces[np.where(has, pid, 0)],
                      np.array([h + 1, w + 1, 0, 0]))         # (E, 1, 4)
        at = d + _small_div(first - env0 * s + seg, s) * hw    # the board's first byte

        def window(j):
            rows = 32 * j + LANE
            live = np.broadcast_to(rows < h, (len(seg), 32))
            start = np.broadcast_to(at + np.minimum(rows, h - 1) * w, live.shape)
            return [emulate_pack_row(buf, start + 32 * i, min(32, w - 32 * i), live)
                    for i in range(nw)]

        r1, r2 = pc[..., 2], pc[..., 3]
        anchors = w - pc[..., 1] + 1
        slots = [window(0), window(1)]
        staged = np.full(per_block * h * nw, -1, np.int64)
        for j in range(-(-h // 32)):
            v1 = [np.zeros((len(seg), 32), np.int64) for _ in range(nw)]
            v2 = [np.zeros((len(seg), 32), np.int64) for _ in range(nw)]
            for t in range(mk.max_h):
                in1 = (t >= r1 & 0xFF) & (t - (r1 & 0xFF) < (r1 >> 16) & 0xFF)
                in2 = (t >= r2 & 0xFF) & (t - (r2 & 0xFF) < (r2 >> 16) & 0xFF)
                for i in range(nw):
                    pair = np.stack([slots[0][i], slots[1][i]], axis=1)   # (E, 2, 32)
                    y = _rows_below(pair, t, 0)[:, 0]
                    v1[i] |= np.where(in1, y, 0)
                    v2[i] |= np.where(in2, y, 0)
            b1 = _shr_words(emulate_smear_words(v1, r1 >> 24), (r1 >> 8) & 0xFF)
            b2 = _shr_words(emulate_smear_words(v2, r2 >> 24), (r2 >> 8) & 0xFF)
            rows = 32 * j + LANE
            live = np.broadcast_to(rows < h, (len(seg), 32))
            fits = (rows + pc[..., 0] <= h) & (anchors > 0)
            for i in range(nw):
                a = anchors - 32 * i
                span = np.where(a >= 32, U32, np.where(a > 0, (1 << np.clip(a, 0, 31)) - 1, 0))
                legal = np.where(fits, ~(b1[i] | b2[i]) & span, 0)
                at_row = np.broadcast_to((seg * h + rows) * nw + i, live.shape)
                assert (staged[at_row[live]] == -1).all()     # each row staged once
                staged[at_row[live]] = legal[live]
            slots = [slots[1], window(j + 2)]
        emulate_store_tall(staged, out, first * hw, count * hw, w, nw)
    assert (out < 2).all()
    return out.reshape(n, s * hw).astype(bool)


def emulate_clear_tall_kernel(cfg, board, ck, addr=0, apply=None):
    """csrc/clear.cu clear_tall_kernel on ``ck``'s launch shape: a warp an
    env at a time, ``per_warp`` turns each from one staged span of the
    block's envs (every turn at once here), its rows packed from the span
    (rows past the bottom all ones), through ``clear_tall``, stored by
    ``store_tall``.  Its apply instance, given ``apply = (cover, valid,
    cover_addr)``: the cover span staged beside the board span, a cover word
    packed beside each board word, overlap by one ``__any_sync`` over every
    slot; a legal env's warp ORs the cover words in and runs the clear, an
    illegal env's skips it and keeps its input words, k = 0.
    Returns (board, k), and legal for the apply."""
    h, w, hw, n = cfg.height, cfg.width, cfg.num_cells, len(board)
    nw, nr = -(-w // 32), -(-h // 32)
    rs = cfg.region_size if cfg.region_clear else 0
    per_warp, warps = ck.shape
    per_block = per_warp * warps
    rows = _slot_rows(nr)[None]
    seg = _turns(per_warp, warps)
    out, ks = np.full(n * hw, 2, np.uint8), np.full(n, -1, np.int64)
    legals = np.full(n, -1, np.int64)
    for first in range(0, n, per_block):
        count = min(per_block, n - first)
        lo, hi = first * hw, (first + count) * hw
        buf, d = emulate_stage_bytes(board.reshape(-1), lo, hi, addr)
        active = seg[:, 0, 0] < count
        live = np.broadcast_to(active[:, None, None] & (rows < h), (per_block, nr, 32))
        at = np.broadcast_to(seg * hw + np.minimum(rows, h - 1) * w, live.shape)

        def pack(span, start):
            return [emulate_pack_row(span, start + 32 * i, min(32, w - 32 * i), live)
                    for i in range(nw)]

        x = [np.where(live, a, U32) for a in pack(buf, d + at)]
        x_in, legal = x, active.copy()                           # the input words
        if apply is not None:
            cover, valid, cover_addr = apply
            covers, dc = emulate_stage_bytes(cover.reshape(-1), lo, hi, cover_addr)
            y = pack(covers, dc + at)                            # 0: no row
            hit = np.logical_or.reduce([(a & b) != 0 for a, b in zip(x, y)]).any(axis=(1, 2))
            legal = active & ~hit & valid[first + np.where(active, seg[:, 0, 0], 0)]
            x = [a | b for a, b in zip(x, y)]
        cleared, k = emulate_clear_tall(x, active, h, w, rs)
        staged = np.full(per_block * h * nw, -1, np.int64)
        for i in range(nw):
            at_row = np.broadcast_to((seg * h + rows) * nw + i, live.shape)
            staged[at_row[live]] = np.where(legal[:, None, None], cleared[i], x_in[i])[live]
        for e, kk, ok in zip(seg[:, 0, 0][active], k[active], legal[active]):
            assert ks[first + e] == -1                        # one lane 0 writes k
            ks[first + e] = kk if ok else 0
            legals[first + e] = ok
        emulate_store_tall(staged, out, lo, count * hw, w, nw)
    assert (out < 2).all() and (ks >= 0).all()
    if apply is None:
        return out.reshape(n, hw), ks.astype(np.int32)
    assert (legals >= 0).all()
    return out.reshape(n, hw), ks.astype(np.int32), legals.astype(bool)


def emulate_apply_tall_kernel(cfg, board, cover, valid, ak, addr=0, cover_addr=0):
    """csrc/clear.cu clear_tall_kernel's apply instance on ``ak``'s launch
    shape (``emulate_clear_tall_kernel``): (board, k, legal)."""
    return emulate_clear_tall_kernel(cfg, board, ak, addr, (cover, valid, cover_addr))


def emulate_clear_deep_kernel(cfg, board, ck, addr=0, apply=None):
    """csrc/clear.cu clear_deep_kernel on ``ck``'s launch shape:
    ``emulate_clear_tall_kernel``'s blocks, turns and staging, each warp
    walking its env's board in windows of 32 rows (32 - 32 mod rs with
    regions), lane l packing row w0 + l (lanes from the window's size on and
    rows past the bottom: the AND's identity).  Pass 1 a window: full rows
    by a ballot, each band's AND by rs shuffles from its lanes, its fields
    tested by every row of it (``full_fields``) and its tiles counted by its
    first row, each row staged with its full row and tiles cleared, the
    column AND a lane; the warp's AND and k at the end.  Pass 2 clears the
    full columns from the staged rows, and the block stores them by
    ``store_tall``.  A warp whose turn has no env left stops.  Its apply
    instance, given ``apply = (cover, valid, cover_addr)``: the cover span
    staged beside the board span; a pass 0 a row a lane (rows l + 32 j)
    packs each board and cover row, stages the placed row and gathers the
    overlap by ``__any_sync``; an illegal env stages its input rows packed
    again, k = 0, and stops there; a legal one's pass 1 reads the placed
    rows back from where pass 0 staged them.  Returns (board, k), and legal
    for the apply."""
    h, w, hw, n = cfg.height, cfg.width, cfg.num_cells, len(board)
    nw = -(-w // 32)
    rs = cfg.region_size if cfg.region_clear else 0
    win = 32 - 32 % rs if rs else 32
    tail = w - 32 * (nw - 1)
    colmask = [U32] * (nw - 1) + [(1 << tail) - 1 if tail < 32 else U32]
    e = LANE % rs if rs else np.zeros(32, np.int64)
    per_warp, warps = ck.shape
    per_block = per_warp * warps
    out, ks = np.full(n * hw, 2, np.uint8), np.full(n, -1, np.int64)
    legals = np.full(n, -1, np.int64)
    for first in range(0, n, per_block):
        count = min(per_block, n - first)
        lo, hi = first * hw, (first + count) * hw
        buf, d = emulate_stage_bytes(board.reshape(-1), lo, hi, addr)
        seg = _turns(per_warp, warps)[:, 0]                     # (E, 1)
        seg = seg[seg[:, 0] < count]                            # the turns that run
        staged = np.full(per_block * h * nw, -1, np.int64)
        if apply is not None:
            cover, valid, cover_addr = apply
            covers, dc = emulate_stage_bytes(cover.reshape(-1), lo, hi, cover_addr)
            hit = np.zeros(len(seg), bool)
            for r0 in range(0, h, 32):                          # pass 0
                r = r0 + LANE
                lv = np.broadcast_to(r < h, (len(seg), 32))
                start = np.broadcast_to(seg * hw + np.minimum(r, h - 1) * w, lv.shape)
                x = emulate_pack_words(buf, d + start, w, lv)
                y = emulate_pack_words(covers, dc + start, w, lv)
                hit |= (np.logical_or.reduce([(a & b) != 0 for a, b in zip(x, y)])
                        & lv).any(axis=1)                        # __any_sync
                for i in range(nw):
                    at_row = np.broadcast_to((seg * h + r) * nw + i, lv.shape)
                    assert (staged[at_row[lv]] == -1).all()     # each row staged once
                    staged[at_row[lv]] = (x[i] | y[i])[lv]
            legal = ~hit & valid[first + seg[:, 0]]
            legals[first + seg[:, 0]] = legal
            rows = np.arange(h)
            for env in seg[~legal, 0]:                          # the input again, k = 0
                x = emulate_pack_words(buf, d + env * hw + rows * w, w, np.ones(h, bool))
                for i in range(nw):
                    staged[(env * h + rows) * nw + i] = x[i]
                ks[first + env] = 0
            seg = seg[legal]
        cols = [np.full((len(seg), 32), U32) for _ in range(nw)]
        k, tiles = np.zeros(len(seg), np.int64), np.zeros((len(seg), 32), np.int64)
        for w0 in range(0, h, win):
            r = w0 + LANE
            live = (LANE < win) & (r < h)                       # the lanes holding a row
            lv = np.broadcast_to(live, (len(seg), 32))
            if apply is None:
                start = np.broadcast_to(d + seg * hw + np.minimum(r, h - 1) * w, lv.shape)
                x = [np.where(lv, a, U32) for a in emulate_pack_words(buf, start, w, lv)]
            else:                                               # pass 0's placed rows
                at = np.broadcast_to((seg * h + np.minimum(r, h - 1)) * nw, lv.shape)
                assert (staged[at[lv]] >= 0).all()
                x = [np.where(lv, staged[at + i], U32) for i in range(nw)]
            full = np.logical_and.reduce([x[i] == colmask[i] for i in range(nw)])
            k += (lv & full).sum(axis=1)                        # popc(ballot)
            cols = [c & a for c, a in zip(cols, x)]
            reg = [np.zeros_like(a) for a in x]
            if rs:
                band = [np.full_like(a, U32) for a in x]
                for t in range(rs):
                    src = np.where(live, LANE - e + t, LANE)
                    assert (src[live] < win).all()             # a band inside its window
                    band = [b & a[:, src] for b, a in zip(band, x)]
                whole = lv & (r - e + rs <= h)
                fields, got = _full_fields(band, w, rs)
                reg = [np.where(whole, a, 0) for a in fields]
                tiles += np.where(whole & (e == 0), got, 0)
            for i in range(nw):
                at_row = np.broadcast_to((seg * h + r) * nw + i, lv.shape)
                # each row staged once (the apply's pass 0 staged them first)
                assert apply is not None or (staged[at_row[lv]] == -1).all()
                staged[at_row[lv]] = (x[i] & ~(np.where(full, colmask[i], 0) | reg[i])
                                      & U32)[lv]
        cols = [np.bitwise_and.reduce(c, axis=1) for c in cols]   # __reduce_and_sync
        k += sum(_popc(c) for c in cols) + tiles.sum(axis=1)
        assert (ks[first + seg[:, 0]] == -1).all()               # one lane 0 writes k
        ks[first + seg[:, 0]] = k
        for i in range(nw):                                     # pass 2: the columns
            at_row = (seg * h + np.arange(h)) * nw + i
            assert (staged[at_row] >= 0).all()
            staged[at_row] &= ~cols[i][:, None]
        emulate_store_tall(staged, out, lo, count * hw, w, nw)
    assert (out < 2).all() and (ks >= 0).all()
    if apply is None:
        return out.reshape(n, hw), ks.astype(np.int32)
    assert (legals >= 0).all()
    return out.reshape(n, hw), ks.astype(np.int32), legals.astype(bool)


def emulate_apply_deep_kernel(cfg, board, cover, valid, ak, addr=0, cover_addr=0):
    """csrc/clear.cu clear_deep_kernel's apply instance on ``ak``'s launch
    shape (``emulate_clear_deep_kernel``): (board, k, legal)."""
    return emulate_clear_deep_kernel(cfg, board, ak, addr, (cover, valid, cover_addr))


def emulate_packed_mask_deep(cfg, words, queue, mk, addr=0, entry="mask"):
    """csrc/packed_tall.cu packed_mask_general_kernel on the 32-bit tables
    ``PackedMaskKernel`` hands it, a warp an env-slot (every one at once
    here): lane t holds the columns of piece row t (field t % fpw of
    footprint word t / fpw) and a ballot gives the piece's rows; per window
    of 32 anchor rows the warp's 64 board rows (the window's and the next,
    two a lane, full past the bottom) are in shared memory, and lane l ORs
    row l + t shifted right by each cell column of piece row t (one shuffle
    of its columns) into its blocked bits.  The mask (``entry="mask"``)
    stages the window's legal rows beside the previous window's, and every
    second window (or the last) the warp stores the pair's rows
    (``store_tall``, 32 threads) from addr + es * HW + (w0 & ~63) * W past
    the 16-byte boundary at or below the output's address.  Its words
    instance (``entry="words"``, the same legality) stores lane l's legal
    row w0 + l (below H) as the int64 out[addr + es * H + w0 + l], ``addr``
    int64 words into the output: (N, S*H) int64."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    hw, total = cfg.num_cells, len(words) * cfg.queue_size
    prow = mk.prow32.numpy().view(np.uint32).astype(np.int64)
    piece_w = mk.piece_w32.numpy()
    nwords, fpw = mk.tables.nwords, mk.tables.fpw
    assert nwords * fpw <= 32                                 # l + t within the 64 rows
    full = ((1 << w) - 1) & U32
    pid = queue.reshape(-1)
    has = (pid >= 0) & (pid < mk.num_pieces)
    p = np.where(has, pid, 0)
    pw = np.where(has, piece_w[p], w + 1)[:, None]              # none: no anchor
    k = _small_div(LANE, fpw)
    field = (prow[p][:, np.minimum(k, nwords - 1)] >> ((LANE - k * fpw) * w)) & full
    cells = np.where((pw <= w) & (LANE < nwords * fpw), field, 0)       # lane t: row t
    ballot = ((cells != 0) << LANE).sum(axis=1)
    piece_rows = np.array([int(b).bit_length() for b in ballot])[:, None]  # 32 - clz
    anchors = np.where(pw <= w, _shl32(1, np.maximum(w - pw + 1, 0)) - 1, 0)
    x64 = words.astype(np.int64)[np.arange(total) // s]        # (N*S, H)

    def rows(r):
        return np.where(r < h, x64[:, np.minimum(r, h - 1)], full)

    if entry == "words":
        out = np.full(addr + total * h, -1, np.int64)          # -1: never written
    else:
        out = np.full(addr + total * hw, 2, np.uint8)          # 2: never written
    x0, x1 = rows(LANE), rows(32 + LANE)
    staged = np.full((total, 64), -1, np.int64)
    for w0 in range(0, h, 32):
        nxt = rows(w0 + 64 + LANE)
        board = np.concatenate([x0, x1], axis=1)               # the warp's 64 rows
        blocked = np.zeros_like(x0)
        for t in range(int(piece_rows.max())):
            y = board[:, LANE + t]
            m = np.where(t < piece_rows, cells[:, t : t + 1], 0)   # __shfl_sync(cells, t)
            for bit in range(w):                                # each cell column
                blocked |= np.where((m >> bit) & 1, y >> bit, 0)
        legal = ~blocked & anchors & U32
        if entry == "words":
            live = w0 + LANE < h
            at = addr + np.arange(total)[:, None] * h + w0 + LANE
            assert (out[at[:, live]] == -1).all()               # written once
            out[at[:, live]] = legal[:, live]
            x0, x1 = x1, nxt
            continue
        half = (w0 >> 5) & 1
        staged[:, 32 * half + LANE] = legal
        if half == 1 or w0 + 32 >= h:
            first = w0 & ~63
            for es in range(total):
                emulate_store_tall(staged[es], out, addr + es * hw + first * w,
                                   min(64, h - first) * w, w, 1)
            staged[:] = -1
        x0, x1 = x1, nxt
    if entry == "words":
        assert (out[addr:] >= 0).all() and (out[:addr] == -1).all()
        return out[addr:].reshape(len(words), s * h)
    assert (out[addr:] < 2).all() and (out[:addr] == 2).all()
    return out[addr:].reshape(len(words), s * hw).astype(bool)


def emulate_packed_words_deep(cfg, words, queue, mk, addr=0):
    """The words instance of the windowed general mask
    (``emulate_packed_mask_deep``): (N, S*H) int64 legal row words."""
    return emulate_packed_mask_deep(cfg, words, queue, mk, addr, "words")


# ------------------------------------------------------------------ tests ----


@pytest.mark.parametrize("height", [33, 40, 64, 128, 130])
def test_packed_wrappers_name_a_kernel_for_every_height_jax_takes(height):
    """JAX's ``make_env`` takes packed state on a board of at most 32
    columns whatever its height, and so does the port's; the packed
    wrappers name a kernel with a C entry point for each such height: the
    tall kernels up to 128 rows, the general ones above.  (Before them the
    wrappers had no kernel above 32 rows and raised at the first step on
    the card.)"""
    cj, ct = _pair(dict(height=height, width=9))
    assert jax_make_env(cj).state_impl == "packed"
    from blockpuzzle_tpu_torch.env import make_env

    env = make_env(ct, device="cpu")
    assert env.state_impl == "packed"
    kind = "tall" if height <= 128 else "general"
    ak, mk = env.packed_apply_kernel, env.packed_mask_kernel
    assert ak.kind == mk.kind == kind
    names = (ak.name, mk.name, mk.words_name)
    assert names == tuple(f"{k}_{kind}" for k in ("packed_apply", "packed_mask",
                                                  "packed_legal_words"))
    entries = ("bp_" + ak.name, "bp_" + mk.name, "bp_packed_words_" + kind)
    assert all(e in _build.SIGNATURES for e in entries)
    assert (mk.shape is not None) == (kind == "tall")
    if kind == "tall":
        assert mk.shape == anchor_launch_shape(ct) and mk.shape[0] >= 1
    # a board of at most 32 rows keeps its bit-row kernels
    short = tcfg.EnvConfig(height=32, width=9)
    assert PackedApplyKernel(short, "cpu").name == "packed_apply"
    assert PackedMaskKernel(short, "cpu").name == "packed_mask"


@pytest.mark.parametrize("case", [*PACKED_TALL, *PACKED_GENERAL])
def test_tall_packed_apply_matches_jax_packed_step(case):
    """The cover words, the clear and the whole apply block against JAX's
    packed engine, then the wrapper (plain version on the CPU) and the
    kernel's emulation: the tall kernel's up to 128 rows, the general
    one's above."""
    env_j = jax_packed(case)
    _, ct = _pair({**PACKED_TALL, **PACKED_GENERAL}[case])
    rng = np.random.default_rng(1)
    cells = tall_cells(ct, N, rng)
    words = np_words(cells)
    attrs, r, c, valid = chosen_actions(ct, N, rng)
    attrs[5], r[5], c[5], valid[5] = attrs[2], 32, 0, True   # completes row 32
    want_next, want_k, want_legal, _ = (
        np.asarray(x) for x in jax_apply(env_j, words, attrs, r, c, valid))
    tw = torch.as_tensor(words.astype(np.int64))
    ak = PackedApplyKernel(ct, "cpu")
    got = ak(tw, *(torch.as_tensor(x) for x in (attrs, r, c, valid)))
    emulate = (emulate_packed_apply_tall if ak.kind == "tall"
               else emulate_packed_apply_deep)
    emu = emulate(ct, words, attrs, r, c, valid)
    for g, e, wnt, name in zip(got, emu, (want_next.astype(np.int64), want_k, want_legal),
                               ("words", "k", "legal")):
        np.testing.assert_array_equal(g.numpy(), wnt, name)
        np.testing.assert_array_equal(e, wnt, name)
    assert want_legal[5] and want_k[5] >= 1 and want_next[5, 32] == 0
    assert want_legal.any() and (~want_legal).any()
    if ct.region_clear:  # the band across the seam (rows 30..32) cleared
        cl_j, k_j = env_j._clear_scan_packed(jnp.asarray(words))
        assert (np.asarray(cl_j)[3::5, 30:33] & 7 == 0).all() and np.asarray(k_j)[3] >= 1
    assert (ak.launches, ak.tall_launches, ak.general_launches) == (0, 0, 0)


def _mask_inputs(cfg, n, seed):
    """Boards at a fill of 0.3 with full lines at the seams (``tall_cells``)
    as packed words, and hands with ids from -1 to P + 1 (empty slots and
    ids past the sentinel), an empty hand first and a 1x5 bar second."""
    rng = np.random.default_rng(seed)
    words = np_words(tall_cells(cfg, n, rng, fill=0.3))
    num_pieces = rules.tables_for(cfg).num_pieces
    queue = rng.integers(-1, num_pieces + 2, (n, cfg.queue_size)).astype(np.int32)
    queue[0] = num_pieces
    queue[1] = 4                                           # a 1x5 bar
    return words, queue


def _jax_mask(env_j, words, queue, num_pieces):
    """JAX's mask and legal words on ``words``/``queue`` (ids clipped to
    [0, P]), and which envs hold only ids in [0, P] (the rows JAX's answer
    is compared on; the others hold ids the wrappers read as empty)."""
    jw, jq = jnp.asarray(words), jnp.asarray(np.clip(queue, 0, num_pieces))
    dealt = (queue >= 0).all(axis=1) & (queue <= num_pieces).all(axis=1)
    want = np.asarray(env_j._bitboard_mask_from_words(jw, jq))
    want_words = np.asarray(jwords.legal_words(env_j, jw, jq)).astype(np.int64)
    return want, want_words, dealt


@pytest.mark.parametrize("case", [*PACKED_TALL, *PACKED_GENERAL])
def test_tall_packed_mask_and_words_match_jax(case):
    """The bool mask against JAX's ``_bitboard_mask_from_words`` and the
    words entry against its ``legal_words``: the plain versions and the
    tall (or general) kernels' emulations, with empty slots and ids past
    the sentinel, the words also equal to the mask packed to words."""
    env_j = jax_packed(case)
    _, ct = _pair({**PACKED_TALL, **PACKED_GENERAL}[case])
    words, queue = _mask_inputs(ct, N, 2)
    num_pieces = rules.tables_for(ct).num_pieces
    want, want_words, dealt = _jax_mask(env_j, words, queue, num_pieces)
    mk = PackedMaskKernel(ct, "cpu")
    tw, tq = torch.as_tensor(words.astype(np.int64)), torch.as_tensor(queue)
    got, got_words = mk(tw, tq).numpy(), mk.words(tw, tq).numpy()
    np.testing.assert_array_equal(got[dealt], want[dealt])
    np.testing.assert_array_equal(got_words[dealt], want_words[dealt])
    np.testing.assert_array_equal(   # ids out of [0, P] read as empty slots
        got[~dealt], mk.plain(tw, torch.as_tensor(np.where(
            (queue >= 0) & (queue < num_pieces), queue, num_pieces))).numpy()[~dealt])
    if mk.kind == "tall":
        np.testing.assert_array_equal(emulate_packed_anchor(ct, words, queue, mk), got)
        np.testing.assert_array_equal(emulate_packed_anchor_words(ct, words, queue, mk),
                                      got_words)
    else:
        bits = emulate_legal_general(ct, words, queue, mk)
        np.testing.assert_array_equal(bits.reshape(N, -1), got_words)
        cells = (bits[..., None] >> np.arange(ct.width)) & 1
        np.testing.assert_array_equal(cells.reshape(N, -1).astype(bool), got)
    packed = (got.reshape(N, -1, ct.width).astype(np.int64)
              << np.arange(ct.width)).sum(axis=2)
    np.testing.assert_array_equal(packed, got_words)
    assert 0 < want.mean() < 1 and not got[0].any()
    assert (mk.launches, mk.tall_launches, mk.general_launches) == (0, 0, 0)
    assert (mk.words_launches, mk.words_tall_launches, mk.words_general_launches) == (0, 0, 0)


# env-slots a block of the tall packed mask and words beside the wrapper's:
# odd counts (spans off a 16-byte boundary on 33x9 and 36x9, envs split
# across blocks where S > 1, the block staging and storing as one on
# 64x8), and 4 and 6 (a warp staging and storing its own env-slots: the
# mask's on 64x8 at 4, on 128x10 at both; the words' on 64x8 at 4 and 6,
# on 128x10 at every count)
ANCHOR_ENVS = [1, 4, 5, 6, 7]


@pytest.mark.parametrize("case", PACKED_TALL)
@pytest.mark.parametrize("envs", ANCHOR_ENVS)
def test_tall_mask_launch_shapes_with_ragged_blocks(case, envs):
    """The tall mask's and words' emulations at block sizes other than the
    wrapper's: a last block that is ragged, blocks whose spans start off a
    16-byte boundary (33x9 and 36x9, whose env-slots' outputs are no
    multiple of 16 bytes), and, where S > 1, blocks that start inside an
    env's slots (its board staged by both); blocks that stage and store as
    one and warps that do so each; on N = 13 and 11, equal to the plain
    versions on every env and to JAX on the envs dealt only ids in [0,
    P]."""
    env_j = jax_packed(case)
    _, ct = _pair(PACKED_TALL[case])
    mk = PackedMaskKernel(ct, "cpu")
    num_pieces = rules.tables_for(ct).num_pieces
    for n in (N, 11):
        assert n * ct.queue_size % envs or envs == 1        # ragged, or a block an env-slot
        words, queue = _mask_inputs(ct, n, n)
        want, want_words, dealt = _jax_mask(env_j, words, queue, num_pieces)
        tw, tq = torch.as_tensor(words.astype(np.int64)), torch.as_tensor(queue)
        got = emulate_packed_anchor(ct, words, queue, mk, envs)
        got_words = emulate_packed_anchor_words(ct, words, queue, mk, envs)
        np.testing.assert_array_equal(got, mk(tw, tq).numpy())
        np.testing.assert_array_equal(got_words, mk.words(tw, tq).numpy())
        np.testing.assert_array_equal(got[dealt], want[dealt])
        np.testing.assert_array_equal(got_words[dealt], want_words[dealt])


@pytest.mark.parametrize("case", PACKED_TALL)
def test_tall_mask_reads_past_a_boards_bottom_as_full(case):
    """A vertical 1x5 bar anchored on a board's last four rows reaches past
    its bottom, where the next env's board is staged (the same board's top
    for the next slot where S > 1), here with empty top rows: those anchors
    are illegal, as JAX says, in the plain versions and in the emulations
    at the wrapper's block size and at ``ANCHOR_ENVS``."""
    env_j = jax_packed(case)
    _, ct = _pair(PACKED_TALL[case])
    h, n = ct.height, 7
    t = rules.tables_for(ct)
    bar = int(np.flatnonzero((t.piece_h == 5) & (t.piece_w == 1))[0])
    cells = (np.random.default_rng(4).random((n, h, ct.width)) < 0.3).astype(np.uint8)
    cells[:, :8] = cells[:, h - 8:] = 0                    # empty top and bottom rows
    words = np_words(cells)
    queue = np.full((n, ct.queue_size), bar, np.int32)
    want, want_words, dealt = _jax_mask(env_j, words, queue, t.num_pieces)
    assert dealt.all()
    legal = want.reshape(n, ct.queue_size, h, ct.width)
    assert legal[:, :, h - 8 : h - 4, 0].all() and not legal[:, :, h - 4 :].any()
    mk = PackedMaskKernel(ct, "cpu")
    tw, tq = torch.as_tensor(words.astype(np.int64)), torch.as_tensor(queue)
    np.testing.assert_array_equal(mk(tw, tq).numpy(), want)
    np.testing.assert_array_equal(mk.words(tw, tq).numpy(), want_words)
    for envs in (None, *ANCHOR_ENVS):
        np.testing.assert_array_equal(emulate_packed_anchor(ct, words, queue, mk, envs), want)
        np.testing.assert_array_equal(
            emulate_packed_anchor_words(ct, words, queue, mk, envs), want_words)


def test_tall_mask_launch_shape_fits_and_aligns():
    """Every packed board the tall mask and words take (32 < H <= 128, W <=
    32) gets the fewest env-slots a block, at least ``ANCHOR_THREADS``
    threads of the words entry's ``ANCHOR_ROWS`` anchor rows each, whose
    output is a multiple of 16 bytes, so that every block's span of the
    mask starts on a 16-byte boundary; for each entry (the mask at
    ``MASK_ANCHOR_ROWS``) at most ``MAX_ANCHOR_THREADS`` threads and 48 KB
    of shared memory (no opt-in) for hands of 1 to 3 slots and footprints
    of up to 32 rows, and at most K - 1 of a segment's K * ceil(H / K)
    slots hold no row; the kernel's float32 quotients (``small_div``) of a
    thread index by C, of a staged row by H, of a staged full row by the
    full rows a board and of a block's first slot plus an env-slot by S are
    exact; other boards get no such shape."""
    for h in range(33, 129):
        for w in range(1, 33):
            (envs,) = anchor_launch_shape(tcfg.EnvConfig(height=h, width=w))
            seg = -(-h // ANCHOR_ROWS)
            assert ANCHOR_THREADS <= envs * seg
            assert envs * h * w % 16 == 0 and not any(
                fewer * seg >= ANCHOR_THREADS and fewer * h * w % 16 == 0
                for fewer in range(1, envs))
            for k, words in ((ANCHOR_ROWS, True), (MASK_ANCHOR_ROWS, False)):
                seg = -(-h // k)
                assert k * seg - h <= k - 1
                threads = -(-envs * seg // 32) * 32
                assert threads <= MAX_ANCHOR_THREADS
                for s in (1, 2, 3):
                    big = tcfg.EnvConfig(height=h, width=w, queue_size=s)
                    assert anchor_smem_bytes(big, envs, 32, words) <= 48 * 1024  # most reach
                    if w == 9:
                        boards = (envs + s - 2) // s + 1
                        _small_div(np.arange(s + envs), s)     # asserts the quotients
                        _small_div(np.arange(boards * h), h)
                        _small_div(np.arange(boards * (31 + k * seg - h)), 31 + k * seg - h)
                if w == 9:
                    _small_div(np.arange(threads), seg)
    for h, w in ((32, 9), (129, 9), (40, 33)):
        assert anchor_launch_shape(tcfg.EnvConfig(height=h, width=w)) is None


def _u8_inputs(cfg, n, rng, fill):
    """Boards of 0/1 cells with full lines at the seams (``tall_cells``), a
    full board and an empty one, and hands with empty slots and an id below
    0."""
    board = tall_cells(cfg, n, rng, fill).reshape(n, -1)
    board[n - 1], board[n - 2] = 1, 0
    num_pieces = rules.tables_for(cfg).num_pieces
    queue = rng.integers(0, num_pieces + 1, (n, cfg.queue_size)).astype(np.int32)
    queue[0] = num_pieces
    queue[1, 0] = -1
    return board, queue


@pytest.mark.parametrize("case", U8_TALL)
def test_mask_tall_matches_jax_mask(case):
    """The u8 mask on tall boards against JAX's: the Pallas kernel in
    interpret mode where its one-hot tables are small (33x9, 36x9), the
    JAX u8 engine's shift mask on every board (on the envs whose hand ids
    are >= 0); then the wrapper (plain version) and the tall kernel's
    emulation."""
    shape = U8_TALL[case]
    cj, ct = _pair(shape)
    board, queue = _u8_inputs(ct, N, np.random.default_rng(3), fill=0.4)
    dealt = (queue >= 0).all(axis=1)
    engine = np.asarray(jax_make_env(cj, state_impl="u8", mask_impl="shift").action_mask(
        jnp.asarray(board), jnp.asarray(queue)))
    mk = MaskKernel(ct, "cpu")
    assert mk.kind == "tall" and mk.name == "mask_tall" and not mk.wide
    got = mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy()
    np.testing.assert_array_equal(got[dealt], engine[dealt])
    if ct.num_cells <= 400:
        want = np.asarray(jk.MaskKernel(cj, tile_n=N)(
            jnp.asarray(board), jnp.asarray(queue), interpret=True))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulate_mask_tall_kernel(ct, board, queue, mk), got)
    assert 0 < got.mean() < 1 and not got[[0, N - 1]].any()
    assert (mk.launches, mk.wide_launches, mk.tall_launches, mk.general_launches) == (
        0, 0, 0, 0)


@pytest.mark.parametrize("case", U8_TALL)
def test_clear_tall_matches_jax_clear_kernel(case):
    """The u8 clear on tall boards against the Pallas kernel (interpret
    mode) and the JAX u8 engine's ``clear_scan``: full rows at the seam,
    full columns, a full 3x3 region across the seam, a full and an empty
    board; then the wrapper (plain version) and the tall kernel's
    emulation."""
    cj, ct = _pair(U8_TALL[case])
    board, _ = _u8_inputs(ct, N, np.random.default_rng(4), fill=0.6)
    want = [np.asarray(x) for x in jk.ClearScanKernel(cj, tile_n=N)(
        jnp.asarray(board), interpret=True)]
    engine = jax_make_env(cj, state_impl="u8").clear_scan(jnp.asarray(board))
    ck = ClearScanKernel(ct, "cpu")
    assert ck.kind == "tall" and ck.name == "clear_tall" and ck.shape is not None
    got = ck(torch.as_tensor(board))
    emu = emulate_clear_tall_kernel(ct, board, ck)
    for i, name in enumerate(("board", "k")):
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(np.asarray(engine[i]), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    k, cleared = want[1], want[0].reshape(N, ct.height, ct.width)
    assert k[N - 1] == ct.height + ct.width + (
        (ct.height // ct.region_size) * (ct.width // ct.region_size) if ct.region_clear else 0)
    assert not cleared[2, 32].any() and k[2] >= 1          # row 32, slot 1's first
    if ct.region_clear:                                      # the band across the seam
        assert not cleared[3, 30:33, 0:3].any()
    assert (ck.launches, ck.wide_launches, ck.tall_launches, ck.general_launches) == (
        0, 0, 0, 0)


@pytest.mark.parametrize("case", ["tall33", "tall36r3", "tall40x40"])
@pytest.mark.parametrize("addr", [3, 13])
def test_tall_emulations_take_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary: the tall mask and clear's
    emulations stage an unaligned head and tail byte by byte and still
    equal the plain versions (N = 13: the last block short of its
    env-slots)."""
    _, ct = _pair(U8_TALL[case])
    board, queue = _u8_inputs(ct, N, np.random.default_rng(addr), fill=0.5)
    mk, ck = MaskKernel(ct, "cpu"), ClearScanKernel(ct, "cpu")
    tb, tq = torch.as_tensor(board), torch.as_tensor(queue)
    np.testing.assert_array_equal(emulate_mask_tall_kernel(ct, board, queue, mk, addr),
                                  mk(tb, tq).numpy())
    for e, p in zip(emulate_clear_tall_kernel(ct, board, ck, addr), ck(tb)):
        np.testing.assert_array_equal(e, p.numpy())


def _apply_seam_cases(cfg, board, cover, valid):
    """``apply_cases`` plus 1x1 actions at the lane seam (rows 31 and 32,
    slot 0's last lane and slot 1's first): one that completes row 32 (env
    9), one that completes row 31 or, with regions, the band of rows 30..32
    across the seam (env 10)."""
    t = rules.tables_for(cfg)
    grid = board.reshape(len(board), cfg.height, cfg.width)

    def one(env, r, c):
        cover[env], valid[env] = t.cover[r * cfg.width + c], t.valid[r * cfg.width + c]

    grid[9, 32, 1:], grid[9, 32, 0] = 1, 0
    one(9, 32, 0)
    if cfg.region_clear:
        grid[10, 30:33, 0:3] = 1
        grid[10, 32, 2] = 0
        one(10, 32, 2)
    else:
        grid[10, 31, :] = 1
        grid[10, 31, 5] = 0
        one(10, 31, 5)


@pytest.mark.parametrize("case", ["tall33", "tall36r3", "tall40x40"])
def test_apply_tall_matches_pallas_apply_kernel(case):
    """K2 on boards of 33 to 128 rows: the Pallas apply kernel in interpret
    mode, the wrapper (plain version on the CPU) and the tall kernel's apply
    instance's emulation, bit-equal: legal and illegal actions, an invalid
    anchor, actions that complete a row (also at the lane seam) or, with
    regions, a band across the seam, one over a full row (a strict no-op), a
    full board and an empty one (``apply_cases``).  (33x128's footprint
    table, P * HW * HW bytes, would take 339 MB; the card holds that board.)"""
    cj, ct = _pair(U8_TALL[case])
    board, cover, valid = apply_cases(ct, N, np.random.default_rng(9))
    _apply_seam_cases(ct, board, cover, valid)
    want = [np.asarray(x) for x in jk.ApplyKernel(cj, tile_n=N)(
        jnp.asarray(board), jnp.asarray(cover), jnp.asarray(valid), interpret=True)]
    ak = ApplyKernel(ct, "cpu")
    assert (ak.kind, ak.name, ak.shape) == ("tall", "apply_tall", apply_launch_shape(ct))
    got = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    emu = emulate_apply_tall_kernel(ct, board, cover, valid, ak)
    for i, name in enumerate(("board", "k", "legal")):
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    assert_apply_cases(ct, board, want)
    new_board, k, legal = want
    grid = new_board.reshape(N, ct.height, ct.width)
    assert legal[9] and k[9] >= 1 and not grid[9, 32].any()
    assert legal[10] and k[10] >= 1
    assert not (grid[10, 30:33, 0:3].any() if ct.region_clear else grid[10, 31].any())
    assert ak.tall_launches == ak.general_launches == 0


@pytest.mark.parametrize("case", ["tall33", "tall36r3", "tall40x40"])
@pytest.mark.parametrize("addr", [3, 13])
def test_apply_tall_emulation_takes_any_address(case, addr):
    """Boards and covers off a 16-byte boundary, each at its own offset: the
    tall apply's emulation stages both spans' unaligned heads and tails byte
    by byte and still equals the plain version (N = 13: the last block short
    of its envs)."""
    _, ct = _pair(U8_TALL[case])
    board, cover, valid = apply_cases(ct, N, np.random.default_rng(addr))
    ak = ApplyKernel(ct, "cpu")
    want = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    for cover_addr in (addr, (addr + 7) % 16):
        emu = emulate_apply_tall_kernel(ct, board, cover, valid, ak, addr, cover_addr)
        for e, p in zip(emu, want):
            np.testing.assert_array_equal(e, p.numpy())


def test_apply_block_shapes_fit():
    """The u8 apply's launch shape (``apply_launch_shape``) on boards of 33
    to 4096 rows of 1 to 128 cells: the tall and deep kernels' rule on the
    apply's own shared memory (its output rows and two staged spans,
    ``apply_smem_bytes``): 16 warps and the most turns that fit 48 KB, else
    one turn and ``tall_block_warps`` on that memory, or fewer warps that
    fit what a block may opt in to; a block's output bytes under the 2^21
    that ``small_div``'s proof needs; a shape on every board of at most
    12288 cells and lines, so that none of those goes to the general apply
    (which takes the larger ones up to what one warp can stage).  40x40, 33x128, 512x8 and 135x9 with regions fit
    with fewer turns or warps than the mask's where its two spans need it."""
    for h in (33, 36, 40, 64, 100, 128, 129, 130, 135, 160, 257, 512, 1000, 1500, 3000, 4096):
        for w in (1, 8, 9, 31, 32, 33, 40, 64, 100, 128):
            cfg = tcfg.EnvConfig(height=h, width=w)
            shape = apply_launch_shape(cfg)
            if shape is None:
                assert apply_smem_bytes(cfg, 1) > SMEM_OPT_IN
                assert cfg.num_cells + h + w > 12288
                continue
            per_warp, warps = shape
            per_block = per_warp * warps
            smem = apply_smem_bytes(cfg, per_block)
            assert smem <= SMEM_OPT_IN and per_block * cfg.num_cells < 1 << 21
            if apply_smem_bytes(cfg, 16) <= 48 * 1024:
                assert warps == 16 and smem <= 48 * 1024
                assert per_warp == 4 or apply_smem_bytes(cfg, 32 * per_warp) > 48 * 1024
            elif warps >= 4:
                assert per_warp == 1 and warps == tall_block_warps(cfg, apply_smem_bytes)
            else:
                assert per_warp == 1 and apply_smem_bytes(cfg, warps + 1) > SMEM_OPT_IN
    for shape, want in ((dict(height=40, width=40), (1, 4)),
                        (dict(height=33, width=128), (1, 4)),
                        (dict(height=512, width=8), (1, 4)),
                        (dict(height=135, width=9, region_clear=True, region_size=3,
                              queue_size=3), (1, 16)),
                        (dict(height=33, width=9), (4, 16)),
                        (dict(height=130, width=8), (1, 16))):
        cfg = tcfg.EnvConfig(**shape)
        assert apply_launch_shape(cfg) == want
        assert apply_smem_bytes(cfg, want[0] * want[1]) <= SMEM_OPT_IN


def test_tall_block_shapes_fit_and_divide_exactly():
    """For every board the tall kernels take (32 < H <= 128, W <= 128): 16
    warps taking the most turns (4, 2 or 1) whose block fits 48 KB, or one
    turn and 4 to 16 warps whose shared memory fits what a block may opt in
    to; an output span that starts on a 16-byte boundary wherever such a
    block fits, and bytes under the 2^21 that ``small_div``'s proof needs;
    the float32 division the store does gives q // W for every byte q of
    the largest block of each W."""
    most = {}
    for h in range(33, 129):
        for w in range(1, 129):
            cfg = tcfg.EnvConfig(height=h, width=w)
            per_warp, warps = tall_launch_shape(cfg)
            assert 4 <= warps <= 16 and per_warp in (1, 2, 4)
            per_block = per_warp * warps
            smem = tall_smem_bytes(cfg, per_block)
            assert smem <= SMEM_OPT_IN
            if tall_smem_bytes(cfg, 16) <= 48 * 1024:   # no opt-in needed
                assert warps == 16 and smem <= 48 * 1024
                assert per_warp == 4 or tall_smem_bytes(cfg, 2 * per_block) > 48 * 1024
            else:
                assert per_warp == 1 and warps == tall_block_warps(cfg)
            nbytes = per_block * cfg.num_cells
            assert nbytes < 1 << 21
            if tall_smem_bytes(cfg, 16) <= SMEM_OPT_IN:
                assert nbytes % 16 == 0
            most[w] = max(most.get(w, 0), nbytes)
    assert tall_launch_shape(tcfg.EnvConfig(height=33, width=9)) == (4, 16)
    for w, nbytes in most.items():
        q = np.arange(nbytes)
        inv = np.float32(1) / np.float32(w)
        got = ((q.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
        np.testing.assert_array_equal(got, q // w)
    for h, w in ((32, 9), (129, 9), (40, 129)):
        assert tall_launch_shape(tcfg.EnvConfig(height=h, width=w)) is None


def test_u8_wrappers_take_the_general_kernels_above_128_rows():
    """Boards of more than 128 rows take the deep mask, clear, apply and
    legality (a warp an env-slot or env over windows of 32 rows; the mask
    and clear on one launch shape, the apply on its own,
    ``apply_launch_shape``, the legality on the mask's at S = P) where rows
    hold at most 128 cells; the tall kernels stop at 128 rows.  Rows of
    more than 128 cells take the xwide launch shape at any height (130x129,
    33x136: the mask's, the clear's and the apply's xwide kernels, the
    apply's at one warp a block, read off the launch shapes without
    building 130x129's rule table, 5.3 GB with classic19), and on 8x136 the
    mask, the
    clear and the apply take their xwide kernels (a lane a word of every
    row, ``xwide_launch_shape``).  A deep board one warp cannot stage has
    no deep launch shape."""
    for shape, kind in ((dict(height=130, width=9), "deep"),
                        (dict(height=128, width=10), "tall")):
        cfg = tcfg.EnvConfig(**shape)
        mk, ck = MaskKernel(cfg, "cpu"), ClearScanKernel(cfg, "cpu")
        assert (mk.kind, ck.kind) == (kind, kind)
        assert (mk.name, ck.name) == (f"mask_{kind}", f"clear_{kind}")
        assert mk.shape is not None and ck.shape == mk.shape
        ak, lk = ApplyKernel(cfg, "cpu"), LegalityKernel(cfg, "cpu")
        assert (ak.kind, ak.name, lk.name) == (kind, f"apply_{kind}", f"legality_{kind}")
        assert ak.shape == apply_launch_shape(cfg) is not None
    assert all(e in _build.SIGNATURES for e in ("bp_clear_deep", "bp_mask_deep", "bp_clear",
                                                "bp_apply_deep", "bp_apply_tall", "bp_apply",
                                                "bp_mask_xwide", "bp_clear_xwide", "bp_mask",
                                                "bp_apply_xwide", "bp_legality_deep"))
    # rows of more than 128 cells on boards of more than 32 rows: the xwide
    # mask, clear and apply
    for shape in (dict(height=130, width=129), dict(height=33, width=136)):
        cfg = tcfg.EnvConfig(**shape)
        got = u8_launch_shape(cfg)
        assert got == xwide_launch_shape(cfg) is not None
        assert u8_kind(cfg, got) == "xwide" and apply_launch_shape(cfg) == (got[0], 1)
    xwide = tcfg.EnvConfig(height=8, width=136)
    ck, ak = ClearScanKernel(xwide, "cpu"), ApplyKernel(xwide, "cpu")
    assert (ck.kind, ck.name, ck.shape) == ("xwide", "clear_xwide", xwide_launch_shape(xwide))
    assert (ak.kind, ak.name, ak.shape) == ("xwide", "apply_xwide", xwide_launch_shape(xwide))
    # no deep launch shape where one warp's board does not fit shared memory
    assert deep_launch_shape(tcfg.EnvConfig(height=1000, width=128)) is None
