"""The port's kernels on the CPU against the JAX package's Pallas kernels.

Each case makes its inputs with numpy from a seed and runs them through
``MaskKernel``/``ApplyKernel``/``ClearScanKernel``/``LegalityKernel`` of
the JAX package in interpret mode and through the port's wrappers, which
run the plain torch versions for CPU tensors.  A numpy emulation of each
CUDA kernel's per-thread/per-warp logic, fed the very tables the wrappers
hand to the kernels, closes the loop on the CPU (the kernels themselves
run only on the card: ``chip_smoke.py`` and the ``gpu``-marked tests in
test_torch_rollout.py).  Each u8 wrapper has a bit-row kernel, for boards
of at most 32 rows of at most 32 cells (every preset), and a general
kernel; the mask and clear also have a wide kernel, for at most 32 rows of
33 to 128 cells (``WIDE_CASES``: ``wide40`` is 8 rows of 40 cells), where
the apply and legality take their general kernels; ``tall33`` (33 rows)
takes the general kernels of all four.  All outputs are integers or bools
and must be bit-equal.
"""

import dataclasses
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from blockpuzzle_tpu import config as jcfg
from blockpuzzle_tpu import kernels as jk
from blockpuzzle_tpu.env import make_env as jax_make_env
from blockpuzzle_tpu_torch import config as tcfg
from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.kernels import (
    ApplyKernel,
    ClearScanKernel,
    LegalityKernel,
    MaskKernel,
    PackedApplyKernel,
    PackedMaskKernel,
    PackedTailKernel,
    _build,
)
from blockpuzzle_tpu_torch.kernels.clear import line_cell_table, line_masks
from blockpuzzle_tpu_torch.kernels.collision import (
    LEGALITY_WARPS, SHAPE_STRIDE, every_piece_shape, legality_launch_shape,
    legality_rows_table, legality_smem_bytes, piece_table, rect_shapes,
)
from blockpuzzle_tpu_torch.kernels.mask import piece_rows_table
from blockpuzzle_tpu_torch.kernels.packed import (
    apply_launch_shape, apply_smem_bytes, deep_launch_shape, mask_block_warps,
    tall_launch_shape, u8_launch_shape, wide_launch_shape,
)
from test_torch_packed import (
    U32, _ballot, _popc, _reduce, _shfl, _shl32, _small_div, _spread4, _warp_layout,
)

PRESETS = ["default", "tenten", "woodoku"]
# every preset, and a board too wide for a row word (the wide mask and
# clear, the general apply and legality)
U8_CASES = PRESETS + ["big", "wide40"]
WIDE40 = dict(height=8, width=40)
# boards of 33 to 128 cells a row: the wide mask and clear kernels on two,
# three and four words a row (8x33: one cell in the second word; 6x64: 32
# divides W; 4x128: four whole words, with the piece set of at most 2x2
# pieces, since the JAX engine's piece tables need pieces that fit the
# board; 8x100: four words, the top one of 4 cells; 9x36 with 3x3 regions
# and a hand of three: region fields straddling the first two words)
WIDE_CASES = {"wide40": WIDE40, "wide33": dict(height=8, width=33),
              "wide64": dict(height=6, width=64),
              "wide128": dict(height=4, width=128, piece_set="mini5"),
              "wide100": dict(height=8, width=100),
              "wide36r3": dict(height=9, width=36, region_clear=True, region_size=3,
                               queue_size=3)}
# the mask and clear tests: every preset and every wide board
MASK_CASES = PRESETS + ["big"] + list(WIDE_CASES)


def _pair(case):
    if case in WIDE_CASES:
        return jcfg.EnvConfig(**WIDE_CASES[case]), tcfg.EnvConfig(**WIDE_CASES[case])
    return jcfg.PRESETS[case](), tcfg.PRESETS[case]()


def random_boards(cfg, n, rng, fill=0.5):
    """Random boards with forced full rows/cols, and a row that is full but
    for its first cell (so a 1x1 at (4, 0) clears it; the last row on a
    board of fewer than 5 rows; the full row 3 is the last on a board of
    fewer than 4)."""
    b = (rng.random((n, cfg.num_cells)) < fill).astype(np.uint8)
    grid = b.reshape(n, cfg.height, cfg.width)
    r4 = min(4, cfg.height - 1)
    grid[0, min(3, cfg.height - 1), :] = 1
    grid[1, :, 7] = 1
    grid[2, 0, :] = 1
    grid[2, :, 0] = 1
    grid[3::4, r4, :] = 1
    grid[3::4, r4, 0] = 0
    return b


def apply_inputs(cfg, n, rng, fill=0.4):
    t = rules.tables_for(cfg)
    board = random_boards(cfg, n, rng, fill)
    g = rng.integers(0, t.cover.shape[0], n)      # incl. invalid anchors
    g[3::4] = 4 * cfg.width                        # 1x1 at (4, 0): clears row 4
    return board, t.cover[g], t.valid[g]


def apply_cases(cfg, n, rng, fill=0.4):
    """``apply_inputs`` (legal and illegal actions, invalid anchors) plus
    crafted envs, 1x1 actions all (piece 0): one that completes row
    min(4, H - 1) (env 5), one over a full row 0 (env 6: illegal, a strict
    no-op although the row is full), an invalid anchor (env 7), with regions
    one that completes a region of rows 0 .. rs - 1 whose columns straddle
    the first two words where a row is wider than 32 (env 8), a full board
    (the last: its action illegal) and an empty one (legal)."""
    t = rules.tables_for(cfg)
    assert t.piece_cells[0] == 1
    board, cover, valid = apply_inputs(cfg, n, rng, fill)
    grid = board.reshape(n, cfg.height, cfg.width)

    def one(env, r, c):
        cover[env], valid[env] = t.cover[r * cfg.width + c], t.valid[r * cfg.width + c]

    r4 = min(4, cfg.height - 1)
    grid[5, r4, 1:], grid[5, r4, 0] = 1, 0
    one(5, r4, 0)
    grid[6, 0, :] = 1
    one(6, 0, 0)
    bad = np.flatnonzero(~t.valid)[0]
    cover[7], valid[7] = t.cover[bad], False
    if cfg.region_clear:
        rs = cfg.region_size
        c0 = 32 // rs * rs if cfg.width > 32 else 0
        grid[8, :rs, c0 : c0 + rs] = 1
        grid[8, 0, c0] = 0
        one(8, 0, c0)
    board[n - 1], board[n - 2] = 1, 0
    one(n - 2, min(2, cfg.height - 1), min(2, cfg.width - 1))
    return board, cover, valid


def assert_apply_cases(cfg, board, want):
    """What ``apply_cases``' crafted envs must give: (board, k, legal)."""
    new_board, k, legal = want
    n, grid = len(board), new_board.reshape(len(board), cfg.height, cfg.width)
    r4 = min(4, cfg.height - 1)
    assert legal[5] and k[5] >= 1 and not grid[5, r4].any()
    for env in (6, 7, n - 1):
        assert not legal[env] and k[env] == 0 and (new_board[env] == board[env]).all()
    if cfg.region_clear:
        rs = cfg.region_size
        c0 = 32 // rs * rs if cfg.width > 32 else 0
        assert legal[8] and k[8] >= 1 and not grid[8, :rs, c0 : c0 + rs].any()
    assert legal[n - 2] and new_board[n - 2].sum() == 1 and k[n - 2] == 0
    assert legal.any() and (~legal).any()


def emulate_mask_kernel(cfg, board, queue):
    """csrc/mask.cu's per-thread test, vectorized over anchors."""
    table = piece_table(cfg)
    n, hw = board.shape
    anchors = np.arange(hw)
    r, c = anchors // cfg.width, anchors % cfg.width
    out = np.zeros((n, cfg.queue_size, hw), bool)
    for e in range(n):
        for s in range(cfg.queue_size):
            pid = queue[e, s]
            if not 0 <= pid < table.shape[0]:
                continue
            ph, pw, ncells = table[pid, :3]
            legal = (r + ph <= cfg.height) & (c + pw <= cfg.width)
            for off in table[pid, 3 : 3 + ncells]:
                idx = np.where(legal, anchors + off, 0)
                legal &= board[e, idx] == 0
            out[e, s] = legal
    return out.reshape(n, -1)


def emulate_legality_kernel(cfg, board):
    """csrc/legality.cu's per-thread test (piece_fits.cuh), vectorized
    over anchors."""
    table = piece_table(cfg)
    n, hw = board.shape
    anchors = np.arange(hw)
    r, c = anchors // cfg.width, anchors % cfg.width
    out = np.zeros((n, table.shape[0], hw), bool)
    for e in range(n):
        for p, (ph, pw, ncells) in enumerate(table[:, :3]):
            legal = (r + ph <= cfg.height) & (c + pw <= cfg.width)
            for off in table[p, 3 : 3 + ncells]:
                legal &= board[e, np.where(legal, anchors + off, 0)] == 0
            out[e, p] = legal
    return out


def emulate_clear_kernel(cfg, board):
    """csrc/clear.cu: clear_lines.cuh's judge-then-clear on every board."""
    cells_t, lens = line_cell_table(line_masks(cfg))
    out, ks = board.copy(), np.zeros(len(board), np.int32)
    for e in range(len(board)):
        full = [out[e, cells_t[l, : lens[l]]].sum() == lens[l] for l in range(len(lens))]
        for l, f in enumerate(full):
            if f:
                out[e, cells_t[l, : lens[l]]] = 0
        ks[e] = sum(full)
    return out, ks


def emulate_apply_kernel(cfg, board, cover, valid):
    """csrc/collision.cu's per-warp logic with clear_lines.cuh's table."""
    cells_t, lens = line_cell_table(line_masks(cfg))
    out, ks, legals = board.copy(), np.zeros(len(board), np.int32), []
    for e in range(len(board)):
        legal = bool(valid[e]) and not np.any(board[e] & cover[e])
        legals.append(legal)
        if not legal:
            continue
        cells = board[e] | cover[e]
        full = [cells[cells_t[l, : lens[l]]].sum() == lens[l] for l in range(len(lens))]
        for l, f in enumerate(full):
            if f:
                cells[cells_t[l, : lens[l]]] = 0
        out[e], ks[e] = cells, sum(full)
    return out, ks, np.array(legals)


# --------------------------------------------------------------------------
# numpy emulations of the bit-row kernels (csrc/mask.cu mask_rows_kernel,
# csrc/clear.cu clear_rows_kernel, csrc/collision.cu apply_rows_kernel,
# csrc/legality.cu legality_rows_kernel, csrc/bit_rows.cuh), block by block;
# in a block every lane of every warp at once, as (warps, 32) arrays, with
# the warp helpers of test_torch_packed.py.  ``addr`` is an input's start
# address mod 16: the staged loads take any start.
# --------------------------------------------------------------------------


def emulate_stage_bytes(flat, lo, hi, addr):
    """bit_rows.cuh stage_bytes: bytes [lo, hi) of ``flat`` into a block
    buffer, byte lo + i at buf[d + i], d = (addr + lo) mod 16: the
    unaligned head byte by byte, whole 16-byte chunks as one vector each
    (16-byte aligned on both sides), the tail byte by byte."""
    length = hi - lo
    d = (addr + lo) % 16
    head = min((16 - d) % 16, length)
    nvec = (length - head) // 16
    buf = np.full(d + length, -1, np.int64)         # -1: never written
    buf[d : d + head] = flat[lo : lo + head]
    assert nvec == 0 or (d + head) % 16 == 0 and (addr + lo + head) % 16 == 0
    for v in range(nvec):
        at = head + 16 * v
        buf[d + at : d + at + 16] = flat[lo + at : lo + at + 16]
    tail = head + 16 * nvec
    buf[d + tail : d + length] = flat[lo + tail : hi]
    assert (buf[d:] >= 0).all()
    # the rest of the allocation (smem_bytes: 32 bytes past the span) holds
    # whatever shared memory held: pack_row reads some of it
    junk = np.random.default_rng(lo).integers(0, 256, 32 + d + length)
    buf = np.concatenate([buf, junk[:32]])
    buf[:d] = junk[32 : 32 + d]
    return buf, d


def emulate_pack_row(buf, start, width, active):
    """bit_rows.cuh pack_row for each lane whose row starts at buf[start]:
    the (W + 6) // 4 aligned 32-bit words holding the row, each nonzero
    byte marked in its top bit, a word's four top bits gathered by one
    multiply, the whole shifted by start mod 4 and masked to W bits."""
    at = np.where(active, start, 0)
    nibbles = np.zeros(start.shape, np.int64)
    for i in range((width + 6) // 4):
        word = at // 4 * 4 + 4 * i
        v = sum(buf[word + j] << (8 * j) for j in range(4))
        assert (buf[word + 3] >= 0).all() and (word + 3 < len(buf)).all()
        top = (((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v) & 0x80808080
        nibbles |= (((top * 0x00204081) & U32) >> 28) << (4 * i)
    x = (nibbles >> (at % 4)) & ((1 << width) - 1)
    want = sum((buf[at + c] != 0).astype(np.int64) << c for c in range(width))
    assert (x == want).all()                      # the gather's arithmetic
    return np.where(active, x, 0)


def emulate_store_rows(rows, out, start, nbytes, width):
    """bit_rows.cuh store_rows: 16 output bits a vector, assembled from the
    staged row words, spread 4 bits to 4 bytes; the tail byte by byte."""
    assert start % 16 == 0                        # the uint4 stores' alignment
    for i in range(nbytes // 16):
        q = 16 * i
        row = int(_small_div(q, width))
        col, got, bits = q - row * width, 0, 0
        while got < 16:
            assert rows[row] >= 0
            bits |= (int(rows[row]) >> col) << got
            got, row, col = got + width - col, row + 1, 0
        vec = [_spread4(bits >> (4 * v)) for v in range(4)]
        out[start + q : start + q + 16] = np.array(vec, "<u4").view(np.uint8)
    for q in range(nbytes // 16 * 16, nbytes):
        row = int(_small_div(q, width))
        assert rows[row] >= 0
        out[start + q] = (int(rows[row]) >> (q - row * width)) & 1


def emulate_smear(v, rw):
    """csrc/mask.cu smear: OR_{u < rw} v >> u by doubling steps."""
    assert (rw <= 8).all()
    s2 = v | v >> 1
    s4 = s2 | s2 >> 2
    s = np.where(rw >= 4, s4, np.where(rw >= 2, s2, v))
    k = np.where(rw >= 4, 4, np.where(rw >= 2, 2, 1))
    out = np.where(rw > 0, s | s >> np.maximum(rw - k, 0), 0)
    want = np.zeros_like(v)
    for u in range(8):
        want |= np.where(u < rw, v >> u, 0)
    assert (out == want).all()
    return out


def emulate_mask_rows_kernel(cfg, board, queue, mk, addr=0):
    """csrc/mask.cu mask_rows_kernel on ``mk``'s piece table and launch
    shape: a segment of H lanes per env-slot, lane = anchor row; vertical
    OR of each rectangle's rows by shuffles, smear by its columns."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    hw, n = cfg.num_cells, len(board)
    pieces = mk.piece_table.numpy().astype(np.int64) & U32
    per_warp, warps = mk.shape
    per_block, total = warps * per_warp, n * s
    _, l, sw, lane, _, _ = _warp_layout(h)
    tx = np.arange(warps * 32).reshape(warps, 32)
    seg = tx // 32 * per_warp + sw
    out = np.full(total * hw, 2, np.uint8)          # 2: never written
    for first in range(0, total, per_block):
        count = min(per_block, total - first)
        env0 = first // s
        buf, d = emulate_stage_bytes(
            board.reshape(-1), env0 * hw, ((first + count - 1) // s + 1) * hw, addr)
        active = (sw < per_warp) & (seg < count)
        pid = np.where(active, queue.reshape(-1)[first + np.where(active, seg, 0)], -1)
        has = (pid >= 0) & (pid < mk.num_pieces)
        pc = np.where(has[..., None], pieces[np.where(has, pid, 0)],
                      np.array([h + 1, w + 1, 0, 0]))
        env = _small_div(first - env0 * s + seg, s)
        x = emulate_pack_row(buf, d + env * hw + lane * w, w, active)
        r1, r2 = pc[..., 2], pc[..., 3]
        v1, v2 = np.zeros_like(x), np.zeros_like(x)
        for t in range(mk.max_h):
            y = _shfl(x, l + t)
            v1 |= np.where((t >= r1 & 0xFF) & (t - (r1 & 0xFF) < (r1 >> 16) & 0xFF), y, 0)
            v2 |= np.where((t >= r2 & 0xFF) & (t - (r2 & 0xFF) < (r2 >> 16) & 0xFF), y, 0)
        blocked = (emulate_smear(v1, r1 >> 24) >> ((r1 >> 8) & 0xFF)
                   | emulate_smear(v2, r2 >> 24) >> ((r2 >> 8) & 0xFF))
        anchors = w - pc[..., 1] + 1
        span = (_shl32(1, np.maximum(anchors, 0)) - 1) & U32
        legal = np.where((lane + pc[..., 0] <= h) & (anchors > 0), ~blocked & span, 0)
        rows = np.full(per_block * h, -1, np.int64)
        rows[(seg * h + lane)[active]] = legal[active]
        emulate_store_rows(rows, out, first * hw, count * hw, w)
    assert (out < 2).all()
    return out.reshape(n, s * hw).astype(bool)


def _wide_div(q, d):
    """bit_rows.cuh wide_div: the high word of q times floor(2^32 / d) + 1
    (q itself for d = 1); equal to the integer quotient while q * d < 2^32."""
    assert 0 <= q and q * d < 1 << 32 and 1 <= d <= 32
    got = (q * (U32 // d + 1)) >> 32 if d > 1 else q
    assert got == q // d
    return got


def emulate_store_span(rows, out, at, nbytes, width):
    """bit_rows.cuh store_span: store_rows from any byte offset ``at`` of
    the (16-byte aligned) output: the bytes up to the first boundary and the
    ragged tail one by one, the vectors between from the staged words."""
    head = min((16 - at % 16) % 16, nbytes)
    nvec = (nbytes - head) // 16
    for i in range(nvec):
        q = head + 16 * i
        assert (at + q) % 16 == 0                   # the uint4 stores' alignment
        row = _wide_div(q, width)
        col, got, bits = q - row * width, 0, 0
        while got < 16:
            assert rows[row] >= 0
            bits |= (int(rows[row]) >> col) << got
            got, row, col = got + width - col, row + 1, 0
        vec = [_spread4(bits >> (4 * v)) for v in range(4)]
        out[at + q : at + q + 16] = np.array(vec, "<u4").view(np.uint8)
    for j in range(nbytes - 16 * nvec):
        q = j if j < head else j + 16 * nvec
        row = _wide_div(q, width)
        assert rows[row] >= 0 and out[at + q] == 2  # written once
        out[at + q] = (int(rows[row]) >> (q - row * width)) & 1


def _block_layout(height, shape):
    """bit_rows.cuh seat for every thread of a block of ``shape``'s warps:
    (per_block, l, s, lane, base, segmask, seg), each (warps, 32) or (32,)."""
    per_warp, warps = shape
    _, l, sw, lane, base, segmask = _warp_layout(height)
    seg = np.arange(warps)[:, None] * per_warp + sw
    return warps * per_warp, l, sw, lane, base, segmask, seg


def emulate_clear_segment(x, active, l, sw, lane, base, segmask, h, w, rs):
    """bit_rows.cuh clear_segment: full rows by ballot, columns by an AND
    over the segment, regions by band shuffles; k by popcounts.  Returns
    the cleared words and k."""
    full = (_shl32(1, w) - 1) & U32
    rows_full = _ballot(active & (x == full)) & segmask
    cols = _reduce(x, sw, np.bitwise_and)
    k = _popc(rows_full) + _popc(cols)
    reg = np.zeros_like(x)
    if rs:
        b0 = lane - lane % rs
        whole = b0 + rs <= h
        band = np.full_like(x, U32)
        for t in range(rs):
            band &= _shfl(x, np.where(whole, base + b0 + t, l))
        tiles = np.zeros_like(x)
        for t in range(0, w - rs + 1, rs):
            tile = (((1 << rs) - 1) << t) & U32
            hit = whole & ((band & tile) == tile)
            reg |= np.where(hit, tile, 0)
            tiles += hit & (lane == b0)
        k = k + _reduce(tiles, sw, np.add)
    return x & ~(np.where(x == full, full, 0) | cols | reg) & U32, k


def emulate_clear_rows_kernel(cfg, board, ck, addr=0):
    """csrc/clear.cu clear_rows_kernel on ``ck``'s launch shape: a segment
    of H lanes per env, lane = row word, through ``clear_segment``."""
    h, w, hw, n = cfg.height, cfg.width, cfg.num_cells, len(board)
    rs = cfg.region_size if cfg.region_clear else 0
    per_block, l, sw, lane, base, segmask, seg = _block_layout(h, ck.shape)
    out, ks = np.full(n * hw, 2, np.uint8), np.full(n, -1, np.int64)
    for first in range(0, n, per_block):
        count = min(per_block, n - first)
        buf, d = emulate_stage_bytes(board.reshape(-1), first * hw, (first + count) * hw, addr)
        active = (sw < ck.shape[0]) & (seg < count)
        x = np.where(active, emulate_pack_row(buf, d + seg * hw + lane * w, w, active), U32)
        cleared, k = emulate_clear_segment(x, active, l, sw, lane, base, segmask, h, w, rs)
        rows = np.full(per_block * h, -1, np.int64)
        rows[(seg * h + lane)[active]] = cleared[active]
        head = active & (lane == 0)
        ks[first + seg[head]] = k[head]
        emulate_store_rows(rows, out, first * hw, count * hw, w)
    assert (out < 2).all() and (ks >= 0).all()
    return out.reshape(n, hw), ks.astype(np.int32)


def emulate_apply_rows_kernel(cfg, board, cover, valid, ak, addr=0, cover_addr=0):
    """csrc/collision.cu apply_rows_kernel on ``ak``'s launch shape: both
    spans staged (each at its own offset from a 16-byte boundary), a board
    word and a cover word per lane, overlap by a ballot over the segment,
    the placed word through ``clear_segment``; an illegal env keeps its
    input word and k = 0."""
    h, w, hw, n = cfg.height, cfg.width, cfg.num_cells, len(board)
    rs = cfg.region_size if cfg.region_clear else 0
    per_block, l, sw, lane, base, segmask, seg = _block_layout(h, ak.shape)
    out = np.full(n * hw, 2, np.uint8)
    ks, legals = np.full(n, -1, np.int64), np.full(n, -1, np.int64)
    for first in range(0, n, per_block):
        count = min(per_block, n - first)
        lo, hi = first * hw, (first + count) * hw
        boards, db = emulate_stage_bytes(board.reshape(-1), lo, hi, addr)
        covers, dc = emulate_stage_bytes(cover.reshape(-1), lo, hi, cover_addr)
        active = (sw < ak.shape[0]) & (seg < count)
        ok = active & valid[first + np.where(active, seg, 0)]
        at = seg * hw + lane * w
        x = emulate_pack_row(boards, db + at, w, active)
        y = emulate_pack_row(covers, dc + at, w, active)
        overlap = _ballot((x & y) != 0) & segmask
        legal = ok & (overlap == 0)
        cleared, k = emulate_clear_segment(
            np.where(active, x | y, U32), active, l, sw, lane, base, segmask, h, w, rs)
        rows = np.full(per_block * h, -1, np.int64)
        rows[(seg * h + lane)[active]] = np.where(legal, cleared, x)[active]
        head = active & (lane == 0)
        ks[first + seg[head]] = np.where(legal, k, 0)[head]
        legals[first + seg[head]] = legal[head]
        emulate_store_rows(rows, out, lo, count * hw, w)
    assert (out < 2).all() and (ks >= 0).all() and (legals >= 0).all()
    return out.reshape(n, hw), ks.astype(np.int32), legals.astype(bool)


def emulate_legality_rows_kernel(cfg, board, lk, addr=0):
    """csrc/legality.cu legality_rows_kernel on ``lk``'s piece table, shape
    set and launch shape: a segment of H lanes per env, lane = anchor row;
    each lane's smears S(rh, rw) for every shape in use into a table row of
    blockDim + 8 words, then the piece loop: two table reads dr lanes below,
    two shifts, the anchor column mask and the row test.  Table words that
    the reading lane's warp did not write hold junk, as shared memory
    would."""
    h, w, hw, n = cfg.height, cfg.width, cfg.num_cells, len(board)
    num_pieces, shapes = lk.num_pieces, lk.shapes
    pieces = lk.piece_table.numpy().astype(np.int64) & U32
    per_block, l, sw, lane, base, _, seg = _block_layout(h, lk.shape)
    warps = lk.shape[1]
    stride = 32 * warps + 8                         # blockDim + kPad
    assert stride == SHAPE_STRIDE                   # what the piece table was built on
    tx = np.arange(32 * warps).reshape(warps, 32)
    nshapes = int(shapes).bit_count()
    out = np.full(n * num_pieces * hw, 2, np.uint8)
    for first in range(0, n, per_block):
        count = min(per_block, n - first)
        buf, d = emulate_stage_bytes(board.reshape(-1), first * hw, (first + count) * hw, addr)
        active = (sw < lk.shape[0]) & (seg < count)
        x = emulate_pack_row(buf, d + seg * hw + lane * w, w, active)
        junk = np.random.default_rng(first).integers(0, 1 << 32, (warps, nshapes * stride))
        stab = junk.copy()                          # warp i's view of the table: row i
        below = np.zeros_like(x)
        for rh in range(1, lk.max_h + 1):
            below |= _shfl(x, l + rh - 1)
            s = np.zeros_like(x)
            for rw in range(1, lk.max_w + 1):
                s |= below >> (rw - 1)
                bit = 8 * (rh - 1) + rw - 1
                if shapes >> bit & 1:
                    row = int(shapes & ((1 << bit) - 1)).bit_count()
                    for i in range(warps):
                        stab[i, row * stride + tx[i]] = s[i]
        rows = np.full(per_block * num_pieces * h, -1, np.int64)
        for p in range(num_pieces):
            ph, amask, r1, r2 = pieces[p]
            blocked = np.stack([
                stab[i, tx[i] + (r1 & 0xFFFF)] >> (r1 >> 16)
                | stab[i, tx[i] + (r2 & 0xFFFF)] >> (r2 >> 16) for i in range(warps)])
            legal = np.where(lane + ph <= h, ~blocked & amask, 0)
            rows[((seg * num_pieces + p) * h + lane)[active]] = legal[active]
        emulate_store_span(rows, out, first * num_pieces * hw, count * num_pieces * hw, w)
    assert (out < 2).all()
    return out.reshape(n, num_pieces, hw).astype(bool)


# --------------------------------------------------------------------------
# numpy emulations of the wide kernels (csrc/mask.cu mask_wide_kernel,
# csrc/clear.cu clear_wide_kernel, bit_rows.cuh clear_words and
# store_words): the bit-row kernels on rows held as NW = ceil(W / 32) words,
# each a list of NW (warps, 32) arrays, word 0 lowest.
# --------------------------------------------------------------------------


def _fshr(lo, hi, k):
    """__funnelshift_r(lo, hi, k): the low 32 bits of (hi:lo) >> (k & 31)."""
    k = np.asarray(k) & 31
    return ((np.asarray(lo, np.int64) >> k) | (np.asarray(hi, np.int64) << (32 - k))) & U32


def _shr_words(v, k):
    """mask.cu shr_words: the NW-word number ``v`` >> k (0 <= k < 32), word i
    funnel-shifted with word i + 1, the top word with zeros; checked
    against the shift of the whole number."""
    nw = len(v)
    out = [_fshr(v[i], v[i + 1] if i + 1 < nw else 0, k) for i in range(nw)]
    whole = sum(np.asarray(v[i]).astype(object) << (32 * i) for i in range(nw))
    whole = whole >> np.broadcast_to(k, whole.shape).astype(object)
    assert all(((whole >> (32 * i)) & U32 == out[i]).all() for i in range(nw))
    return out


def emulate_smear_words(v, rw):
    """mask.cu smear_words: ``emulate_smear``'s doubling steps, every shift
    a ``_shr_words``; checked against OR_{u < rw} v >> u."""
    assert (rw <= 8).all()
    s2 = [a | b for a, b in zip(v, _shr_words(v, 1))]
    s4 = [a | b for a, b in zip(s2, _shr_words(s2, 2))]
    s = [np.where(rw >= 4, c, np.where(rw >= 2, b, a)) for a, b, c in zip(v, s2, s4)]
    k = np.where(rw >= 4, 4, np.where(rw >= 2, 2, 1))
    out = [np.where(rw > 0, a | b, 0)
           for a, b in zip(s, _shr_words(s, np.where(rw > 0, rw - k, 0)))]
    want = [np.zeros_like(a) for a in v]
    for u in range(8):
        for i, a in enumerate(_shr_words(v, u)):
            want[i] |= np.where(u < rw, a, 0)
    assert all((a == b).all() for a, b in zip(out, want))
    return out


def emulate_pack_words(buf, start, width, active):
    """The wide kernels' pack: one ``pack_row`` a word, word i from 32 i
    bytes into the row, min(32, W - 32 i) cells."""
    return [emulate_pack_row(buf, start + 32 * i, min(32, width - 32 * i), active)
            for i in range(-(-width // 32))]


def emulate_store_words(rows, out, start, nbytes, width, nw):
    """bit_rows.cuh store_words: 16 output bits a vector from row q / W,
    column c = q % W: the funnel-shifted pair of words holding column c (the
    top word's pair zeros) and, where fewer than 16 columns are left in the
    row, the next row's first word shifted up past them; the tail byte by
    byte.  Rows are ``nw`` staged words each."""
    assert start % 16 == 0                        # the uint4 stores' alignment
    for i in range(nbytes // 16):
        q = 16 * i
        row = int(_small_div(q, width))
        c = q - row * width
        w = c >> 5
        lo = rows[row * nw + w]
        hi = rows[row * nw + w + 1] if w + 1 < nw else 0
        assert lo >= 0 and hi >= 0
        bits = int(_fshr(lo, hi, c & 31))
        if width - c < 16:
            assert rows[(row + 1) * nw] >= 0
            bits |= (int(rows[(row + 1) * nw]) << (width - c)) & U32
        vec = [_spread4(bits >> (4 * v)) for v in range(4)]
        out[start + q : start + q + 16] = np.array(vec, "<u4").view(np.uint8)
    for q in range(nbytes // 16 * 16, nbytes):
        row = int(_small_div(q, width))
        c = q - row * width
        assert rows[row * nw + (c >> 5)] >= 0
        out[start + q] = (int(rows[row * nw + (c >> 5)]) >> (c & 31)) & 1


def emulate_mask_wide_kernel(cfg, board, queue, mk, addr=0):
    """csrc/mask.cu mask_wide_kernel on ``mk``'s piece table and launch
    shape: ``emulate_mask_rows_kernel`` on rows of NW words, each
    rectangle's vertical OR a word at a time, its smear and shift by dc on
    the NW-word number, the legal row masked a word at a time."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    hw, n, nw = cfg.num_cells, len(board), -(-cfg.width // 32)
    pieces = mk.piece_table.numpy().astype(np.int64) & U32
    per_warp, warps = mk.shape
    per_block, total = warps * per_warp, n * s
    _, l, sw, lane, _, _ = _warp_layout(h)
    tx = np.arange(warps * 32).reshape(warps, 32)
    seg = tx // 32 * per_warp + sw
    out = np.full(total * hw, 2, np.uint8)          # 2: never written
    for first in range(0, total, per_block):
        count = min(per_block, total - first)
        env0 = first // s
        buf, d = emulate_stage_bytes(
            board.reshape(-1), env0 * hw, ((first + count - 1) // s + 1) * hw, addr)
        active = (sw < per_warp) & (seg < count)
        pid = np.where(active, queue.reshape(-1)[first + np.where(active, seg, 0)], -1)
        has = (pid >= 0) & (pid < mk.num_pieces)
        pc = np.where(has[..., None], pieces[np.where(has, pid, 0)],
                      np.array([h + 1, w + 1, 0, 0]))
        env = _small_div(first - env0 * s + seg, s)
        x = emulate_pack_words(buf, d + env * hw + lane * w, w, active)
        r1, r2 = pc[..., 2], pc[..., 3]
        v1, v2 = [np.zeros_like(x[0]) for _ in x], [np.zeros_like(x[0]) for _ in x]
        for t in range(mk.max_h):
            in1 = (t >= r1 & 0xFF) & (t - (r1 & 0xFF) < (r1 >> 16) & 0xFF)
            in2 = (t >= r2 & 0xFF) & (t - (r2 & 0xFF) < (r2 >> 16) & 0xFF)
            for i in range(nw):
                y = _shfl(x[i], l + t)
                v1[i] |= np.where(in1, y, 0)
                v2[i] |= np.where(in2, y, 0)
        b1 = _shr_words(emulate_smear_words(v1, r1 >> 24), (r1 >> 8) & 0xFF)
        b2 = _shr_words(emulate_smear_words(v2, r2 >> 24), (r2 >> 8) & 0xFF)
        anchors = w - pc[..., 1] + 1
        fits = (lane + pc[..., 0] <= h) & (anchors > 0)
        rows = np.full(per_block * h * nw, -1, np.int64)
        for i in range(nw):
            a = anchors - 32 * i
            span = np.where(a >= 32, U32, np.where(a > 0, (1 << np.clip(a, 0, 31)) - 1, 0))
            legal = np.where(fits, ~(b1[i] | b2[i]) & span, 0)
            rows[((seg * h + lane) * nw + i)[active]] = legal[active]
        emulate_store_words(rows, out, first * hw, count * hw, w, nw)
    assert (out < 2).all()
    return out.reshape(n, s * hw).astype(bool)


def emulate_clear_words(x, active, l, sw, lane, base, segmask, h, w, rs):
    """bit_rows.cuh clear_words: a row full when every word equals its
    column mask (a ballot), columns by an AND a word over the segment,
    regions by band shuffles a word and each field read from the
    funnel-shifted pair holding its first column, marked in both words
    where it straddles them; k by popcounts.  Returns the cleared words
    and k."""
    nw = len(x)
    tail = w - 32 * (nw - 1)
    colmask = [U32] * (nw - 1) + [(1 << tail) - 1 if tail < 32 else U32]
    full = np.logical_and.reduce([x[i] == colmask[i] for i in range(nw)])
    k = _popc(_ballot(active & full) & segmask)
    cols = [_reduce(a, sw, np.bitwise_and) for a in x]
    k = k + sum(_popc(c) for c in cols)
    reg = [np.zeros_like(a) for a in x]
    if rs:
        b0 = lane - lane % rs
        whole = b0 + rs <= h
        band = [np.full_like(a, U32) for a in x]
        for t in range(rs):
            src = np.where(whole, base + b0 + t, l)
            band = [b & _shfl(a, src) for a, b in zip(x, band)]
        tiles = np.zeros_like(x[0])
        tile0 = (1 << rs) - 1
        c0 = 0
        for i in range(nw):
            while c0 < 32 * (i + 1) and c0 + rs <= w:
                b = c0 - 32 * i
                field = _fshr(band[i], band[i + 1] if i + 1 < nw else 0, b) & tile0
                hit = whole & (field == tile0)
                reg[i] |= np.where(hit, (tile0 << b) & U32, 0)
                if i + 1 < nw and b + rs > 32:
                    reg[i + 1] |= np.where(hit, tile0 >> (32 - b), 0)
                tiles += hit & (lane == b0)
                c0 += rs
        k = k + _reduce(tiles, sw, np.add)
    cleared = [x[i] & ~(np.where(full, colmask[i], 0) | cols[i] | reg[i]) & U32
               for i in range(nw)]
    return cleared, k


def emulate_clear_wide_kernel(cfg, board, ck, addr=0, apply=None):
    """csrc/clear.cu clear_wide_kernel on ``ck``'s launch shape: a segment
    of H lanes per env, lane = a row of NW words, through
    ``clear_words``, stored by ``store_words``.  Its apply instance, given
    ``apply = (cover, valid, cover_addr)``: the cover span staged beside the
    board span (each at its own offset from a 16-byte boundary), a cover
    word packed beside each board word, overlap by one ballot over the
    segment, ``clear_words`` on the placed words; an illegal env keeps its
    input words (beside the placed ones in each lane) and k = 0.  Returns
    (board, k), and legal for the apply."""
    h, w, hw, n = cfg.height, cfg.width, cfg.num_cells, len(board)
    nw = -(-w // 32)
    rs = cfg.region_size if cfg.region_clear else 0
    per_block, l, sw, lane, base, segmask, seg = _block_layout(h, ck.shape)
    out, ks = np.full(n * hw, 2, np.uint8), np.full(n, -1, np.int64)
    legals = np.full(n, -1, np.int64)
    for first in range(0, n, per_block):
        count = min(per_block, n - first)
        lo, hi = first * hw, (first + count) * hw
        buf, d = emulate_stage_bytes(board.reshape(-1), lo, hi, addr)
        active = (sw < ck.shape[0]) & (seg < count)
        at = seg * hw + lane * w
        x = [np.where(active, a, U32) for a in emulate_pack_words(buf, d + at, w, active)]
        x_in, legal = x, np.ones_like(active)                        # the input words
        if apply is not None:
            cover, valid, cover_addr = apply
            covers, dc = emulate_stage_bytes(cover.reshape(-1), lo, hi, cover_addr)
            y = emulate_pack_words(covers, dc + at, w, active)       # 0: no env
            hit = np.logical_or.reduce([(a & b) != 0 for a, b in zip(x, y)])
            ok = active & valid[first + np.where(active, seg, 0)]
            legal = ok & ((_ballot(hit) & segmask) == 0)
            x = [a | b for a, b in zip(x, y)]
        cleared, k = emulate_clear_words(x, active, l, sw, lane, base, segmask, h, w, rs)
        rows = np.full(per_block * h * nw, -1, np.int64)
        for i in range(nw):
            rows[((seg * h + lane) * nw + i)[active]] = np.where(
                legal, cleared[i], x_in[i])[active]
        head = active & (lane == 0)
        ks[first + seg[head]] = np.where(legal, k, 0)[head]
        legals[first + seg[head]] = legal[head]
        emulate_store_words(rows, out, lo, count * hw, w, nw)
    assert (out < 2).all() and (ks >= 0).all()
    if apply is None:
        return out.reshape(n, hw), ks.astype(np.int32)
    assert (legals >= 0).all()
    return out.reshape(n, hw), ks.astype(np.int32), legals.astype(bool)


def emulate_apply_wide_kernel(cfg, board, cover, valid, ak, addr=0, cover_addr=0):
    """csrc/clear.cu clear_wide_kernel's apply instance on ``ak``'s launch
    shape (``emulate_clear_wide_kernel``): (board, k, legal)."""
    return emulate_clear_wide_kernel(cfg, board, ak, addr, (cover, valid, cover_addr))


@pytest.mark.parametrize("preset", MASK_CASES)
@pytest.mark.parametrize("n", [16, 11])
def test_mask_matches_pallas_mask_kernel(preset, n, rng):
    """Includes empty-slot sentinels (and an id below 0), invalid anchors,
    full and empty boards and a ragged N (the JAX kernel runs it as one
    tile of n; the port takes any N).  The empty board's rows are the
    pieces' in-bounds anchors: a piece overhanging the right or bottom
    edge is illegal there.  Against the Pallas kernel (interpret mode) and
    the JAX u8 engine's shift mask; the general kernel's emulation on
    every board, and the bit-row or wide kernel's where the wrapper picks
    it."""
    cj, ct = _pair(preset)
    board = random_boards(ct, n, rng, fill=0.4)
    t = rules.tables_for(ct)
    num_pieces = t.num_pieces
    queue = rng.integers(0, num_pieces + 1, (n, ct.queue_size)).astype(np.int32)
    queue[0] = num_pieces                                   # all slots empty
    queue[1, 0] = -1
    board[n - 1], board[n - 2] = 1, 0                       # full, empty
    queue[n - 2] = (7 * np.arange(ct.queue_size) + 5) % num_pieces
    want = np.asarray(jk.MaskKernel(cj, tile_n=min(8, n) if n % 8 == 0 else n)(
        jnp.asarray(board), jnp.asarray(queue), interpret=True))
    # the engine's own hands hold ids 0..P (P: the empty slot); its shift
    # mask reads an id below 0 as an index from the end, so the env with
    # one is left out there
    engine = jax_make_env(cj, state_impl="u8", mask_impl="shift").action_mask(
        jnp.asarray(board), jnp.asarray(queue))
    dealt = (queue >= 0).all(axis=1)
    np.testing.assert_array_equal(np.asarray(engine)[dealt], want[dealt])
    mk = MaskKernel(ct, "cpu")
    got = mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulate_mask_kernel(ct, board, queue), want)
    if mk.wide:
        np.testing.assert_array_equal(emulate_mask_wide_kernel(ct, board, queue, mk), want)
    elif mk.shape is not None:
        np.testing.assert_array_equal(emulate_mask_rows_kernel(ct, board, queue, mk), want)
    hw = ct.num_cells
    assert not want[[0, n - 1]].any() and not want[1, :hw].any()
    for s, p in enumerate(queue[n - 2]):
        np.testing.assert_array_equal(want[n - 2, s * hw : (s + 1) * hw],
                                      t.valid[p * hw : (p + 1) * hw])
    # the plain version is no launch
    assert (mk.launches, mk.wide_launches, mk.general_launches) == (0, 0, 0)


@pytest.mark.parametrize("preset", PRESETS)
def test_apply_matches_pallas_apply_kernel(preset, rng):
    cj, ct = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    board, cover, valid = apply_inputs(ct, 16, rng)
    want = jk.ApplyKernel(cj, tile_n=8)(
        jnp.asarray(board), jnp.asarray(cover), jnp.asarray(valid),
        interpret=True)
    ak = ApplyKernel(ct, "cpu")
    got = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    emu = emulate_apply_kernel(ct, board, cover, valid)
    rows = emulate_apply_rows_kernel(ct, board, cover, valid, ak)
    for w, g, e, r, name in zip(want, got, emu, rows, ("board", "k", "legal")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        np.testing.assert_array_equal(e, np.asarray(w), name)
        np.testing.assert_array_equal(r, np.asarray(w), name)
    assert int(np.asarray(want[1]).sum()) > 0  # the clear path ran


@pytest.mark.parametrize("preset", U8_CASES)
@pytest.mark.parametrize("n", [16, 11])
def test_apply_kernels_match_pallas_apply_kernel(preset, n, rng):
    """Against the Pallas kernel (interpret mode; the ragged N runs as one
    tile of n).  Legal and illegal actions, invalid anchors, an action that
    completes a row, a full and an empty board, a board holding a full 3x3
    region crossed by a full row under a 1x1 placed beside them, and an
    action that overlaps a board's full row (a strict no-op).  The general
    kernel's emulation on every board, and the bit-row or wide kernel's
    where the wrapper picks it."""
    cj, ct = _pair(preset)
    t = rules.tables_for(ct)
    board, cover, valid = apply_inputs(ct, n, rng)
    grid = board.reshape(n, ct.height, ct.width)
    one = lambda r, c: (t.cover[r * ct.width + c], t.valid[r * ct.width + c])
    grid[5] = 0
    grid[5, 3:6, 3:6] = 1                    # a full 3x3 region ...
    grid[5, 4, :] = 1                        # ... crossed by a full row;
    cover[5], valid[5] = one(0, 0)           # the 1x1 lands clear of both
    grid[6, 0, :] = 1                        # a full row 0 under the action
    cover[6], valid[6] = one(0, 0)
    board[n - 1], board[n - 2] = 1, 0        # full, empty
    cover[n - 2], valid[n - 2] = one(2, 2)
    want = [np.asarray(x) for x in jk.ApplyKernel(cj, tile_n=8 if n % 8 == 0 else n)(
        jnp.asarray(board), jnp.asarray(cover), jnp.asarray(valid), interpret=True)]
    ak = ApplyKernel(ct, "cpu")
    got = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    emus = [emulate_apply_kernel(ct, board, cover, valid)]
    if ak.kind != "general":
        emulate = emulate_apply_rows_kernel if ak.kind == "rows" else emulate_apply_wide_kernel
        emus.append(emulate(ct, board, cover, valid, ak))
    for i, name in enumerate(("board", "k", "legal")):
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        for emu in emus:
            np.testing.assert_array_equal(emu[i], want[i], name)
    new_board, k, legal = want
    assert legal[5] and k[5] == 1 + bool(ct.region_clear)
    assert not legal[6] and k[6] == 0 and (new_board[6] == board[6]).all()
    assert not legal[n - 1] and k[n - 1] == 0 and new_board[n - 1].all()
    assert legal[n - 2] and new_board[n - 2].sum() == 1
    assert legal[3] and k[3] >= 1 and not new_board[3].reshape(grid.shape[1:])[4].any()
    assert (ak.launches, ak.general_launches) == (0, 0)


@pytest.mark.parametrize("case", WIDE_CASES)
@pytest.mark.parametrize("n", [16, 11])
def test_apply_wide_matches_pallas_apply_kernel(case, n, rng):
    """K2 on rows of 33 to 128 cells: the Pallas apply kernel in interpret
    mode (the ragged N as one tile of n), the wrapper (plain version on the
    CPU) and the wide kernel's apply instance's emulation, bit-equal, on
    ``apply_cases``: legal and illegal actions, an invalid anchor, an action
    that completes a row, one over a full row (a strict no-op), on 9x36 one
    that completes a 3x3 region across the row's two words, a full board
    and an empty one."""
    cj, ct = _pair(case)
    board, cover, valid = apply_cases(ct, n, rng)
    want = [np.asarray(x) for x in jk.ApplyKernel(cj, tile_n=8 if n % 8 == 0 else n)(
        jnp.asarray(board), jnp.asarray(cover), jnp.asarray(valid), interpret=True)]
    ak = ApplyKernel(ct, "cpu")
    assert (ak.kind, ak.name, ak.shape) == ("wide", "apply_wide", wide_launch_shape(ct))
    got = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    emu = emulate_apply_wide_kernel(ct, board, cover, valid, ak)
    for i, name in enumerate(("board", "k", "legal")):
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    assert_apply_cases(ct, board, want)
    assert ak.wide_launches == ak.general_launches == 0


@pytest.mark.parametrize("case", ["wide40", "wide36r3", "wide100"])
@pytest.mark.parametrize("addr", [3, 13])
def test_apply_wide_emulation_takes_any_address(case, addr):
    """Boards and covers that start off a 16-byte boundary, each at its own
    offset: the wide apply's emulation stages both spans' unaligned heads
    and tails byte by byte and still equals the plain version (N = 13: the
    last block short of its envs)."""
    _, ct = _pair(case)
    n, r = 13, np.random.default_rng(addr)
    board, cover, valid = apply_cases(ct, n, r)
    ak = ApplyKernel(ct, "cpu")
    want = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    for cover_addr in (addr, (addr + 7) % 16):
        emu = emulate_apply_wide_kernel(ct, board, cover, valid, ak, addr, cover_addr)
        for e, p in zip(emu, want):
            np.testing.assert_array_equal(e, p.numpy())


@pytest.mark.parametrize("preset", MASK_CASES)
@pytest.mark.parametrize("n", [16, 11])
def test_clear_matches_pallas_clear_kernel(preset, n, rng):
    """Against the Pallas kernel (interpret mode; the ragged N runs as one
    tile of n) and the JAX engine's ``clear_scan``.  Boards hold full rows
    and columns, a full and an empty board and, with regions, a full 3x3
    region crossing a full row (the last row on a board of fewer than 5
    rows) and, where a row is wider than 32, a full region whose columns
    straddle the first two words.  The general kernel's emulation on every
    board, and the bit-row or wide kernel's where the wrapper picks it."""
    cj, ct = _pair(preset)
    board = random_boards(ct, n, rng, fill=0.6)
    grid = board.reshape(n, ct.height, ct.width)
    r4 = min(4, ct.height - 1)
    grid[5, 3:6, 3:6] = 1                   # a full 3x3 region ...
    grid[5, r4, :] = 1                      # ... crossed by a full row
    rs = ct.region_size
    straddle = ct.region_clear and ct.width > 32 and 32 % rs
    if straddle:                            # a region on columns 30..32 (rs = 3)
        c0 = 32 // rs * rs
        grid[6, :rs, c0 : c0 + rs] = 1
    board[n - 1], board[n - 2] = 1, 0       # full, empty
    want = jk.ClearScanKernel(cj, tile_n=8 if n % 8 == 0 else n)(
        jnp.asarray(board), interpret=True)
    engine = jax_make_env(cj, state_impl="u8").clear_scan(jnp.asarray(board))
    ck = ClearScanKernel(ct, "cpu")
    got = ck(torch.as_tensor(board))
    emus = [emulate_clear_kernel(ct, board)]
    if ck.wide:
        emus.append(emulate_clear_wide_kernel(ct, board, ck))
    elif ck.shape is not None:
        emus.append(emulate_clear_rows_kernel(ct, board, ck))
    for i, name in enumerate(("board", "k")):
        w = np.asarray(want[i])
        np.testing.assert_array_equal(got[i].numpy(), w, name)
        np.testing.assert_array_equal(np.asarray(engine[i]), w, name)
        for emu in emus:
            np.testing.assert_array_equal(emu[i], w, name)
    k, cleared = np.asarray(want[1]), np.asarray(want[0]).reshape(grid.shape)
    assert k.min() == 0 and not cleared[5, r4].any() and not cleared[n - 1].any()
    assert k[n - 1] == ct.height + ct.width + (
        (ct.height // ct.region_size) * (ct.width // ct.region_size) if ct.region_clear else 0)
    if ct.region_clear:  # the shared cell counts for both, cleared once
        assert k[5] >= 2 and not cleared[5, 3:6, 3:6].any()
    if straddle:
        assert k[6] >= 1 and not cleared[6, :rs, c0 : c0 + rs].any()
    assert (ck.launches, ck.wide_launches, ck.general_launches) == (0, 0, 0)


@pytest.mark.parametrize("preset", ["default", "tenten", "big"])
def test_legality_matches_pallas_legality_kernel(preset, rng):
    """Against the Pallas kernel (interpret mode, 128-lane action tiles)
    and the JAX u8 engine's ``legal_all_pieces``."""
    cj, ct = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    board = random_boards(ct, 16, rng, fill=0.3)
    want = np.asarray(jk.LegalityKernel(cj, tile_n=8, tile_a=128)(
        jnp.asarray(board), interpret=True))
    engine = jax_make_env(cj, state_impl="u8").legal_all_pieces(jnp.asarray(board))
    lk = LegalityKernel(ct, "cpu")
    got = lk(torch.as_tensor(board)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(engine), want)
    np.testing.assert_array_equal(emulate_legality_kernel(ct, board), want)
    np.testing.assert_array_equal(emulate_legality_rows_kernel(ct, board, lk), want)
    assert 0 < want.mean() < 1 and lk.launches == 0


@pytest.mark.parametrize("preset", U8_CASES + ["mini5"])
@pytest.mark.parametrize("n", [16, 11])
def test_legality_kernels_match_pallas_legality_kernel(preset, n, rng):
    """Against the Pallas kernel (interpret mode, 128-lane action tiles; a
    ragged N takes the JAX wrapper's reference) with a full and an empty
    board, whose rows are the pieces' in-bounds anchors; ``mini5`` is
    another piece set (P = 5, pieces of at most 2 rows and columns).  Both
    kernels' emulations where the wrapper picks the bit-row kernel, the
    general one's elsewhere (the wide board's pick, the wide mask's
    every-piece instance, is emulated in ``tests/test_torch_legality.py``)."""
    if preset == "mini5":
        cj, ct = jcfg.EnvConfig(piece_set="mini5"), tcfg.EnvConfig(piece_set="mini5")
    else:
        cj, ct = _pair(preset)
    board = random_boards(ct, n, rng, fill=0.3)
    board[n - 1], board[n - 2] = 1, 0                       # full, empty
    want = np.asarray(jk.LegalityKernel(cj, tile_n=8, tile_a=128)(
        jnp.asarray(board), interpret=True))
    lk = LegalityKernel(ct, "cpu")
    np.testing.assert_array_equal(lk(torch.as_tensor(board)).numpy(), want)
    np.testing.assert_array_equal(emulate_legality_kernel(ct, board), want)
    if lk.kind == "rows":
        np.testing.assert_array_equal(emulate_legality_rows_kernel(ct, board, lk), want)
    t = rules.tables_for(ct)
    assert not want[n - 1].any()
    np.testing.assert_array_equal(want[n - 2].reshape(-1), t.valid)
    assert 0 < want.mean() < 1 and (lk.launches, lk.general_launches) == (0, 0)


def test_apply_illegal_is_noop_even_with_full_line():
    """Twin of test_kernels.py: a board holding a full row and an action
    that overlaps it must come back untouched with k = 0."""
    cj, ct = jcfg.default_config(), tcfg.default_config()
    t = rules.tables_for(ct)
    board = np.zeros((8, ct.num_cells), np.uint8)
    board[:, :10] = 1
    cover, valid = t.cover[np.zeros(8, int)], t.valid[np.zeros(8, int)]
    want = jk.ApplyKernel(cj, tile_n=8)(
        jnp.asarray(board), jnp.asarray(cover), jnp.asarray(valid),
        interpret=True)
    ak = ApplyKernel(ct, "cpu")
    nb, k, legal = ak(
        torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    assert not legal.any() and int(k.sum()) == 0
    np.testing.assert_array_equal(nb.numpy(), board)
    rows = emulate_apply_rows_kernel(ct, board, cover, valid, ak)
    for w, g, r in zip(want, (nb, k, legal), rows):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(r, np.asarray(w))


@pytest.mark.parametrize("case", ["default", "big", "mini5"])
def test_kernel_tables_encode_rule_tables(case):
    """The piece table reproduces cover/valid, the line table the masks."""
    cfg = (tcfg.EnvConfig(piece_set="mini5") if case == "mini5"
           else tcfg.PRESETS[case]())
    t = rules.tables_for(cfg)
    table = piece_table(cfg)
    hw = cfg.num_cells
    for p in range(t.num_pieces):
        ph, pw, ncells = table[p, :3]
        for a in range(hw):
            r, c = divmod(a, cfg.width)
            ok = r + ph <= cfg.height and c + pw <= cfg.width
            assert ok == t.valid[p * hw + a]
            if ok:
                fp = np.zeros(hw, np.uint8)
                fp[a + table[p, 3 : 3 + ncells]] = 1
                np.testing.assert_array_equal(fp, t.cover[p * hw + a])
    masks = line_masks(cfg)
    cells, lens = line_cell_table(masks)
    for line in range(len(masks)):
        rebuilt = np.zeros(hw, np.uint8)
        rebuilt[cells[line, : lens[line]]] = 1
        np.testing.assert_array_equal(rebuilt, masks[line])


def test_wrappers_validate_inputs():
    cfg = tcfg.tenten_config()
    mk, ak = MaskKernel(cfg, "cpu"), ApplyKernel(cfg, "cpu")
    ck, lk = ClearScanKernel(cfg, "cpu"), LegalityKernel(cfg, "cpu")
    board = torch.zeros(4, cfg.num_cells, dtype=torch.uint8)
    queue = torch.zeros(4, cfg.queue_size, dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        mk(board.to(torch.int32), queue)
    with pytest.raises(ValueError):
        mk(board, queue[:, :1])
    with pytest.raises(ValueError):
        ak(board, board, valid.to(torch.uint8))
    with pytest.raises(ValueError):
        ak(board[:, :10], board[:, :10], valid)
    for k in (ck, lk):
        with pytest.raises(ValueError):
            k(board.to(torch.int32))
        with pytest.raises(ValueError):
            k(board[:, :10])


def test_wrappers_never_fall_back_off_cpu():
    """A device that is neither CPU nor CUDA raises; so do tensors on
    another device than the wrapper's tables."""
    cfg = tcfg.default_config()
    meta = torch.device("meta")
    board = torch.zeros(4, cfg.num_cells, dtype=torch.uint8, device=meta)
    queue = torch.zeros(4, 1, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no mask kernel"):
        MaskKernel(cfg, meta)(board, queue)
    with pytest.raises(ValueError, match="no apply kernel"):
        ApplyKernel(cfg, meta)(board, board, torch.ones(4, dtype=torch.bool, device=meta))
    with pytest.raises(ValueError, match="no clear kernel"):
        ClearScanKernel(cfg, meta)(board)
    with pytest.raises(ValueError, match="no legality kernel"):
        LegalityKernel(cfg, meta)(board)
    with pytest.raises(ValueError, match="kernel tables on cpu"):
        MaskKernel(cfg, "cpu")(board, queue)
    for k in (ClearScanKernel(cfg, "cpu"), LegalityKernel(cfg, "cpu")):
        with pytest.raises(ValueError, match="kernel tables on cpu"):
            k(board)
    with pytest.raises(ValueError, match="kernel tables on cpu"):
        ApplyKernel(cfg, "cpu")(board, board, torch.ones(4, dtype=torch.bool, device=meta))
    # the same on a board that takes the wide mask, clear, apply and
    # legality, on one that takes the tall ones, on one that takes the deep
    # ones, on one that takes the xwide ones, on one whose rows take the
    # xwide kernels' long-row instances (one env or env-slot a warp), and on
    # one that takes the general kernels of all four
    for shape, kinds in ((WIDE40, ("wide",) * 4), (dict(height=33, width=9), ("tall",) * 4),
                         (dict(height=130, width=9), ("deep",) * 4),
                         (dict(height=8, width=136), ("xwide",) * 4),
                         (dict(height=1, width=1056), ("xwide",) * 4),
                         (dict(height=1, width=4128), ("general",) * 4)):
        cfg = tcfg.EnvConfig(**shape)
        board = torch.zeros(4, cfg.num_cells, dtype=torch.uint8, device=meta)
        mk, ck, ak = MaskKernel(cfg, meta), ClearScanKernel(cfg, meta), ApplyKernel(cfg, meta)
        lk = LegalityKernel(cfg, meta)
        assert (mk.kind, ck.kind, ak.kind, lk.kind) == kinds
        assert mk.wide == ck.wide == (kinds[0] == "wide")
        assert tuple(k.shape is not None for k in (mk, ck, ak, lk)) == tuple(
            k != "general" for k in kinds)
        with pytest.raises(ValueError, match="no mask kernel"):
            mk(board, queue)
        with pytest.raises(ValueError, match="no clear kernel"):
            ck(board)
        with pytest.raises(ValueError, match="no apply kernel"):
            ApplyKernel(cfg, meta)(board, board, torch.ones(4, dtype=torch.bool, device=meta))
        with pytest.raises(ValueError, match="no legality kernel"):
            LegalityKernel(cfg, meta)(board)


@pytest.mark.parametrize("wrapper", [
    MaskKernel, ApplyKernel, ClearScanKernel, LegalityKernel, PackedApplyKernel,
    PackedMaskKernel, PackedTailKernel], ids=lambda w: w.__name__)
def test_wrappers_default_to_the_card(wrapper, monkeypatch):
    """Built without a device, a wrapper asks ``_build.resolve_device`` for
    CUDA: where there is no card it raises, and never runs the plain
    version on the CPU."""
    cfg = tcfg.default_config()
    assert inspect.signature(wrapper).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert wrapper(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wrapper(cfg)
    asked = []
    monkeypatch.setattr(_build, "resolve_device",
                        lambda device: asked.append(device) or torch.device("cpu"))
    wrapper(cfg)
    assert asked == ["cuda"]


@pytest.mark.parametrize("case", ["default", "tenten", "woodoku", "big", "tall33",
                                  "tall130", *WIDE_CASES])
def test_u8_wrappers_pick_their_kernel_by_shape(case):
    """The bit-row mask, clear, apply and legality where H <= 32 and
    W <= 32: the first three with B7's launch shape, the mask with the
    rectangle piece table, the legality with four warps a block, its own
    table and a block that fits a plain launch's shared memory; the wide
    mask, clear and apply where H <= 32 and 32 < W <= 128, with the same
    launch shape rule and the rectangle piece table, beside the wide
    legality (the wide mask's every-piece instance); the tall mask, clear,
    apply and legality where 32 < H <= 128 (one board a warp,
    ``tall_launch_shape``, the rectangle piece table); on a board taller
    than that the deep ones (``deep_launch_shape``).  The legality's launch
    shape beyond 32x32 is the mask's at S = P (``every_piece_shape``), its
    table the mask's.  The apply's launch shape is ``apply_launch_shape``:
    the clear's where a block's two staged spans fit, fewer turns or warps
    where not."""
    cfg = (tcfg.EnvConfig(height=33, width=9) if case == "tall33"
           else tcfg.EnvConfig(height=130, width=9) if case == "tall130"
           else _pair(case)[1])
    mk, ck = MaskKernel(cfg, "cpu"), ClearScanKernel(cfg, "cpu")
    ak, lk = ApplyKernel(cfg, "cpu"), LegalityKernel(cfg, "cpu")
    rows = cfg.height <= 32 and cfg.width <= 32
    wide = cfg.height <= 32 and 32 < cfg.width <= 128
    tall = 32 < cfg.height <= 128 and cfg.width <= 128
    deep = cfg.height > 128 and cfg.width <= 128
    assert [k.shape is not None for k in (mk, ck, ak, lk)] == [rows or wide or tall or deep] * 4
    assert mk.wide == ck.wide == wide
    kind = "rows" if rows else "wide" if wide else "tall" if tall else "deep"
    assert (mk.kind, ck.kind, ak.kind, lk.kind) == (kind,) * 4
    assert (mk.name, ck.name, ak.name, lk.name) == tuple(
        k + {"rows": ""}.get(kind, "_" + kind) for k in ("mask", "clear", "apply", "legality"))
    if kind != "rows":
        every = dataclasses.replace(cfg, queue_size=lk.num_pieces)
        assert lk.shape == every_piece_shape(cfg) == u8_launch_shape(every)
        assert ("bp_" + lk.name) in _build.SIGNATURES
        np.testing.assert_array_equal(lk.piece_table.numpy(), piece_rows_table(cfg))
    assert ak.shape == apply_launch_shape(cfg)
    if kind != "rows":
        assert ("bp_" + ak.name) in _build.SIGNATURES
        assert apply_smem_bytes(cfg, ak.shape[0] * ak.shape[1]) <= 227 * 1024
    if tall:
        assert mk.shape == ck.shape == tall_launch_shape(cfg) == (4, 16)
        np.testing.assert_array_equal(mk.piece_table.numpy(), piece_rows_table(cfg))
    elif wide:
        shape = (32 // cfg.height, mask_block_warps(cfg.height, cfg.width))
        assert mk.shape == ck.shape == ak.shape == lk.shape == wide_launch_shape(cfg) == shape
        np.testing.assert_array_equal(mk.piece_table.numpy(), piece_rows_table(cfg))
    elif rows:
        assert mk.shape == ck.shape == ak.shape == PackedMaskKernel(cfg, "cpu").shape
        np.testing.assert_array_equal(mk.piece_table.numpy(), piece_rows_table(cfg))
        assert lk.shape == legality_launch_shape(cfg) == (32 // cfg.height, LEGALITY_WARPS)
        np.testing.assert_array_equal(lk.piece_table.numpy(), legality_rows_table(cfg))
        per_block = lk.shape[0] * lk.shape[1]
        assert legality_smem_bytes(cfg, per_block) <= 48 * 1024
        # a block's byte offsets times W stay under 2^32 (store_span's division)
        assert per_block * lk.num_pieces * cfg.num_cells * cfg.width < 1 << 32
    else:
        assert deep and mk.shape == ck.shape == deep_launch_shape(cfg) == (1, 16)
        np.testing.assert_array_equal(mk.piece_table.numpy(), piece_rows_table(cfg))


@pytest.mark.parametrize("preset", ["tenten", "woodoku", "big"])
@pytest.mark.parametrize("addr", [3, 8, 13])
def test_bit_row_emulations_take_any_board_address(preset, addr):
    """Boards that start off a 16-byte boundary: every block stages an
    unaligned head and tail byte by byte, and the four bit-row kernels'
    emulations still equal the plain versions (the last block short of
    its env-slots at N = 13).  The apply's cover starts at another offset
    than its board."""
    _, ct = _pair(preset)
    n, r = 13, np.random.default_rng(addr)
    board = random_boards(ct, n, r, fill=0.5)
    board[n - 1] = 1
    num_pieces = rules.tables_for(ct).num_pieces
    queue = r.integers(-1, num_pieces + 2, (n, ct.queue_size)).astype(np.int32)
    mk, ck = MaskKernel(ct, "cpu"), ClearScanKernel(ct, "cpu")
    tb, tq = torch.as_tensor(board), torch.as_tensor(queue)
    np.testing.assert_array_equal(emulate_mask_rows_kernel(ct, board, queue, mk, addr),
                                  mk(tb, tq).numpy())
    for e, p in zip(emulate_clear_rows_kernel(ct, board, ck, addr), ck(tb)):
        np.testing.assert_array_equal(e, p.numpy())
    ak, lk = ApplyKernel(ct, "cpu"), LegalityKernel(ct, "cpu")
    _, cover, valid = apply_inputs(ct, n, r)
    want = ak(tb, torch.as_tensor(cover), torch.as_tensor(valid))
    assert want[2].any() and not want[2].all()
    for cover_addr in (addr, (addr + 7) % 16):
        emu = emulate_apply_rows_kernel(ct, board, cover, valid, ak, addr, cover_addr)
        for e, p in zip(emu, want):
            np.testing.assert_array_equal(e, p.numpy())
    np.testing.assert_array_equal(emulate_legality_rows_kernel(ct, board, lk, addr),
                                  lk(tb).numpy())


@pytest.mark.parametrize("case", ["wide40", "wide36r3", "wide100"])
@pytest.mark.parametrize("addr", [3, 13])
def test_wide_emulations_take_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary: the wide mask and clear's
    emulations stage an unaligned head and tail byte by byte and still
    equal the plain versions (N = 13: the last block short of its
    env-slots)."""
    _, ct = _pair(case)
    n, r = 13, np.random.default_rng(addr)
    board = random_boards(ct, n, r, fill=0.5)
    board[n - 1] = 1
    num_pieces = rules.tables_for(ct).num_pieces
    queue = r.integers(-1, num_pieces + 2, (n, ct.queue_size)).astype(np.int32)
    mk, ck = MaskKernel(ct, "cpu"), ClearScanKernel(ct, "cpu")
    tb, tq = torch.as_tensor(board), torch.as_tensor(queue)
    assert mk.wide and ck.wide
    np.testing.assert_array_equal(emulate_mask_wide_kernel(ct, board, queue, mk, addr),
                                  mk(tb, tq).numpy())
    for e, p in zip(emulate_clear_wide_kernel(ct, board, ck, addr), ck(tb)):
        np.testing.assert_array_equal(e, p.numpy())


def test_wide_block_division_is_exact_for_every_byte():
    """``store_words`` divides a block's output byte q by W with
    ``small_div`` (float32 reciprocal): for every board the wide kernels
    take (H <= 32, 32 < W <= 128) and every q below the block's bytes, the
    float32 arithmetic the card does gives q // W; a block's bytes stay
    under the 2^21 the proof needs and its shared memory under the 227 KB
    a block may opt in to (the mask's span holding E + 1 envs, S = 1, the
    most any hand needs)."""
    most = {}
    for h in range(1, 33):
        for w in range(33, 129):
            per_warp, warps = wide_launch_shape(tcfg.EnvConfig(height=h, width=w))
            e = per_warp * warps
            nbytes = e * h * w
            assert nbytes <= 1 << 16
            nrows = e * h * -(-w // 32)
            smem = (4 * nrows + 15) // 16 * 16 + (e + 1) * h * w + 32  # smem_bytes
            assert smem <= 227 * 1024
            most[w] = max(most.get(w, 0), nbytes)
    for w, nbytes in most.items():
        q = np.arange(nbytes)
        inv = np.float32(1) / np.float32(w)
        got = ((q.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
        np.testing.assert_array_equal(got, q // w)


def test_bit_row_piece_table_rebuilds_every_footprint():
    """``piece_rows_table``'s <= 2 rectangles, unpacked, cover exactly
    each piece's cells inside its bounding box."""
    for name in ("default", "mini5"):
        cfg = tcfg.EnvConfig(piece_set=name) if name == "mini5" else tcfg.default_config()
        t = rules.tables_for(cfg)
        table = piece_rows_table(cfg).view(np.uint32)
        for p in range(t.num_pieces):
            h, w = table[p, :2]
            grid = np.zeros((t.max_h, t.max_w), np.uint8)
            for rect in table[p, 2:]:
                dr, dc, rh, rw = ((int(rect) >> sh) & 0xFF for sh in (0, 8, 16, 24))
                assert dr + rh <= h and dc + rw <= w
                grid[dr : dr + rh, dc : dc + rw] = 1
            np.testing.assert_array_equal(grid, t.pieces[p])


@pytest.mark.parametrize("case", ["default", "big", "mini5"])
def test_legality_rows_table_rebuilds_every_footprint(case):
    """``legality_rows_table``'s rectangles, read back through
    ``rect_shapes``' rows, cover exactly each piece's cells; its column mask
    keeps the anchors whose bounding box fits the row."""
    cfg = (tcfg.EnvConfig(piece_set="mini5") if case == "mini5"
           else tcfg.PRESETS[case]())
    t = rules.tables_for(cfg)
    shapes = rect_shapes(cfg)
    by_row = [divmod(b, 8) for b in range(64) if shapes >> b & 1]
    stride = SHAPE_STRIDE
    table = legality_rows_table(cfg).view(np.uint32)
    assert table.shape == (t.num_pieces, 4) and len(by_row) <= t.max_h * t.max_w
    for p in range(t.num_pieces):
        h, amask = int(table[p, 0]), int(table[p, 1])
        assert h == t.piece_h[p]
        assert amask == (1 << max(cfg.width - t.piece_w[p] + 1, 0)) - 1
        grid = np.zeros((t.max_h, t.max_w), np.uint8)
        for rect in table[p, 2:]:
            row, dr = divmod(int(rect) & 0xFFFF, stride)
            dc = int(rect) >> 16
            rh, rw = by_row[row][0] + 1, by_row[row][1] + 1
            assert dr + rh <= h and dc + rw <= t.piece_w[p] and dr < 8
            grid[dr : dr + rh, dc : dc + rw] = 1
        np.testing.assert_array_equal(grid, t.pieces[p])
