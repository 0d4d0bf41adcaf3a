"""The port's kernels on the CPU against the JAX package's Pallas kernels.

Each case makes its inputs with numpy from a seed and runs them through
``MaskKernel``/``ApplyKernel``/``ClearScanKernel``/``LegalityKernel`` of
the JAX package in interpret mode and through the port's wrappers, which
run the plain torch versions for CPU tensors.  A numpy emulation of each
CUDA kernel's per-thread/per-warp logic, fed the very tables the wrappers
hand to the kernels, closes the loop on the CPU (the kernels themselves
run only on the card: ``chip_smoke.py`` and the ``gpu``-marked tests in
test_torch_rollout.py).  Each u8 wrapper has two kernels: the bit-row
kernel on boards of at most 32 rows of at most 32 cells (every preset) and
the general kernel, which the wrappers pick for any other board;
``wide40`` (8 rows of 40 cells) is such a board.  All outputs are integers
or bools and must be bit-equal.
"""

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
    _build,
)
from blockpuzzle_tpu_torch.kernels.clear import line_cell_table, line_masks
from blockpuzzle_tpu_torch.kernels.collision import (
    LEGALITY_WARPS, SHAPE_STRIDE, legality_launch_shape, legality_rows_table,
    legality_smem_bytes, piece_table, rect_shapes,
)
from blockpuzzle_tpu_torch.kernels.mask import piece_rows_table
from test_torch_packed import (
    U32, _ballot, _popc, _reduce, _shfl, _shl32, _small_div, _spread4, _warp_layout,
)

PRESETS = ["default", "tenten", "woodoku"]
# every preset, and a board too wide for a row word (the general kernels)
U8_CASES = PRESETS + ["big", "wide40"]
WIDE40 = dict(height=8, width=40)


def _pair(case):
    if case == "wide40":
        return jcfg.EnvConfig(**WIDE40), tcfg.EnvConfig(**WIDE40)
    return jcfg.PRESETS[case](), tcfg.PRESETS[case]()


def random_boards(cfg, n, rng, fill=0.5):
    """Random boards with forced full rows/cols, and a row that is full but
    for its first cell (so a 1x1 at (4, 0) clears it)."""
    b = (rng.random((n, cfg.num_cells)) < fill).astype(np.uint8)
    grid = b.reshape(n, cfg.height, cfg.width)
    grid[0, 3, :] = 1
    grid[1, :, 7] = 1
    grid[2, 0, :] = 1
    grid[2, :, 0] = 1
    grid[3::4, 4, :] = 1
    grid[3::4, 4, 0] = 0
    return b


def apply_inputs(cfg, n, rng, fill=0.4):
    t = rules.tables_for(cfg)
    board = random_boards(cfg, n, rng, fill)
    g = rng.integers(0, t.cover.shape[0], n)      # incl. invalid anchors
    g[3::4] = 4 * cfg.width                        # 1x1 at (4, 0): clears row 4
    return board, t.cover[g], t.valid[g]


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


@pytest.mark.parametrize("preset", U8_CASES)
@pytest.mark.parametrize("n", [16, 11])
def test_mask_matches_pallas_mask_kernel(preset, n, rng):
    """Includes empty-slot sentinels (and an id below 0), invalid anchors,
    full and empty boards and a ragged N (the JAX kernel runs it as one
    tile of n; the port takes any N).  The empty board's rows are the
    pieces' in-bounds anchors: a piece overhanging the right or bottom
    edge is illegal there.  Both kernels' emulations where the wrapper
    picks the bit-row kernel, the general one's elsewhere."""
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
    mk = MaskKernel(ct, "cpu")
    got = mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulate_mask_kernel(ct, board, queue), want)
    if mk.shape is not None:
        np.testing.assert_array_equal(emulate_mask_rows_kernel(ct, board, queue, mk), want)
    hw = ct.num_cells
    assert not want[[0, n - 1]].any() and not want[1, :hw].any()
    for s, p in enumerate(queue[n - 2]):
        np.testing.assert_array_equal(want[n - 2, s * hw : (s + 1) * hw],
                                      t.valid[p * hw : (p + 1) * hw])
    assert (mk.launches, mk.general_launches) == (0, 0)  # the plain version is no launch


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
    action that overlaps a board's full row (a strict no-op).  Both
    kernels' emulations where the wrapper picks the bit-row kernel, the
    general one's elsewhere."""
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
    if ak.shape is not None:
        emus.append(emulate_apply_rows_kernel(ct, board, cover, valid, ak))
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


@pytest.mark.parametrize("preset", U8_CASES)
@pytest.mark.parametrize("n", [16, 11])
def test_clear_matches_pallas_clear_kernel(preset, n, rng):
    """Against the Pallas kernel (interpret mode; the ragged N runs as one
    tile of n) and the JAX engine's ``clear_scan``.  Boards hold full rows
    and columns, a full and an empty board and, on woodoku, a full 3x3
    region crossing a full row.  Both kernels' emulations where the wrapper
    picks the bit-row kernel, the general one's elsewhere."""
    cj, ct = _pair(preset)
    board = random_boards(ct, n, rng, fill=0.6)
    grid = board.reshape(n, ct.height, ct.width)
    grid[5, 3:6, 3:6] = 1                   # a full 3x3 region ...
    grid[5, 4, :] = 1                       # ... crossed by a full row
    board[n - 1], board[n - 2] = 1, 0       # full, empty
    want = jk.ClearScanKernel(cj, tile_n=8 if n % 8 == 0 else n)(
        jnp.asarray(board), interpret=True)
    engine = jax_make_env(cj, state_impl="u8").clear_scan(jnp.asarray(board))
    ck = ClearScanKernel(ct, "cpu")
    got = ck(torch.as_tensor(board))
    emus = [emulate_clear_kernel(ct, board)]
    if ck.shape is not None:
        emus.append(emulate_clear_rows_kernel(ct, board, ck))
    for i, name in enumerate(("board", "k")):
        w = np.asarray(want[i])
        np.testing.assert_array_equal(got[i].numpy(), w, name)
        np.testing.assert_array_equal(np.asarray(engine[i]), w, name)
        for emu in emus:
            np.testing.assert_array_equal(emu[i], w, name)
    k, cleared = np.asarray(want[1]), np.asarray(want[0]).reshape(grid.shape)
    assert k.min() == 0 and not cleared[5, 4].any() and not cleared[n - 1].any()
    assert k[n - 1] == ct.height + ct.width + (
        (ct.height // ct.region_size) * (ct.width // ct.region_size) if ct.region_clear else 0)
    if ct.region_clear:  # the shared cell counts for both, cleared once
        assert k[5] >= 2 and not cleared[5, 3:6, 3:6].any()
    assert (ck.launches, ck.general_launches) == (0, 0)


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
    general one's elsewhere."""
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
    if lk.shape is not None:
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
    # the same on a board that takes the general apply and legality
    wide = tcfg.EnvConfig(**WIDE40)
    board = torch.zeros(4, wide.num_cells, dtype=torch.uint8, device=meta)
    assert ApplyKernel(wide, meta).shape is None and LegalityKernel(wide, meta).shape is None
    with pytest.raises(ValueError, match="no apply kernel"):
        ApplyKernel(wide, meta)(board, board, torch.ones(4, dtype=torch.bool, device=meta))
    with pytest.raises(ValueError, match="no legality kernel"):
        LegalityKernel(wide, meta)(board)


@pytest.mark.parametrize("wrapper", [
    MaskKernel, ApplyKernel, ClearScanKernel, LegalityKernel, PackedApplyKernel,
    PackedMaskKernel], ids=lambda w: w.__name__)
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


@pytest.mark.parametrize("case", ["default", "tenten", "woodoku", "big", "wide40", "tall33"])
def test_u8_wrappers_pick_their_kernel_by_shape(case):
    """The bit-row mask, clear, apply and legality where H <= 32 and
    W <= 32: the first three with B7's launch shape, the mask with the
    rectangle piece table, the legality with four warps a block, its own
    table and a block that fits a plain launch's shared memory; the general
    kernels, with the per-cell piece table, on a board wider or taller than
    that."""
    cfg = (tcfg.EnvConfig(height=33, width=9) if case == "tall33"
           else _pair(case)[1])
    mk, ck = MaskKernel(cfg, "cpu"), ClearScanKernel(cfg, "cpu")
    ak, lk = ApplyKernel(cfg, "cpu"), LegalityKernel(cfg, "cpu")
    rows = cfg.height <= 32 and cfg.width <= 32
    assert [k.shape is not None for k in (mk, ck, ak, lk)] == [rows] * 4
    assert lk.shape == legality_launch_shape(cfg)
    if rows:
        assert mk.shape == ck.shape == ak.shape == PackedMaskKernel(cfg, "cpu").shape
        np.testing.assert_array_equal(mk.piece_table.numpy(), piece_rows_table(cfg))
        assert lk.shape == (32 // cfg.height, LEGALITY_WARPS)
        np.testing.assert_array_equal(lk.piece_table.numpy(), legality_rows_table(cfg))
        per_block = lk.shape[0] * lk.shape[1]
        assert legality_smem_bytes(cfg, per_block) <= 48 * 1024
        # a block's byte offsets times W stay under 2^32 (store_span's division)
        assert per_block * lk.num_pieces * cfg.num_cells * cfg.width < 1 << 32
    else:
        np.testing.assert_array_equal(mk.piece_table.numpy(), piece_table(cfg))
        np.testing.assert_array_equal(lk.piece_table.numpy(), piece_table(cfg))


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
