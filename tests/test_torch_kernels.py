"""The port's kernels on the CPU against the JAX package's Pallas kernels.

Each case makes its inputs with numpy from a seed and runs them through
``MaskKernel``/``ApplyKernel``/``ClearScanKernel``/``LegalityKernel`` of
the JAX package in interpret mode and through the port's wrappers, which
run the plain torch versions for CPU tensors.  A numpy emulation of each
CUDA kernel's per-thread/per-warp logic, fed the very tables the wrappers
hand to the kernels, closes the loop on the CPU (the kernels themselves
run only on the card: ``chip_smoke.py`` and the ``gpu``-marked tests in
test_torch_rollout.py).  The u8 mask and clear have two kernels each: the
bit-row kernel on boards of at most 32 rows of at most 32 cells (every
preset) and the general kernel, which the wrappers pick for any other
board; ``wide40`` (8 rows of 40 cells) is such a board.  All outputs are
integers or bools and must be bit-equal.
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
from blockpuzzle_tpu_torch.kernels.collision import piece_table
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
# csrc/clear.cu clear_rows_kernel, csrc/bit_rows.cuh), block by block; in a
# block every lane of every warp at once, as (warps, 32) arrays, with the
# warp helpers of test_torch_packed.py.  ``addr`` is the board's start
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


def emulate_clear_rows_kernel(cfg, board, ck, addr=0):
    """csrc/clear.cu clear_rows_kernel on ``ck``'s launch shape: a segment
    of H lanes per env, lane = row word; full rows by ballot, columns by an
    AND over the segment, regions by band shuffles; k by popcounts."""
    h, w, hw, n = cfg.height, cfg.width, cfg.num_cells, len(board)
    rs = cfg.region_size if cfg.region_clear else 0
    per_warp, warps = ck.shape
    per_block = warps * per_warp
    _, l, sw, lane, base, segmask = _warp_layout(h)
    tx = np.arange(warps * 32).reshape(warps, 32)
    seg = tx // 32 * per_warp + sw
    full = (_shl32(1, w) - 1) & U32
    out, ks = np.full(n * hw, 2, np.uint8), np.full(n, -1, np.int64)
    for first in range(0, n, per_block):
        count = min(per_block, n - first)
        buf, d = emulate_stage_bytes(board.reshape(-1), first * hw, (first + count) * hw, addr)
        active = (sw < per_warp) & (seg < count)
        x = np.where(active, emulate_pack_row(buf, d + seg * hw + lane * w, w, active), U32)
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
        cleared = x & ~(np.where(x == full, full, 0) | cols | reg) & U32
        rows = np.full(per_block * h, -1, np.int64)
        rows[(seg * h + lane)[active]] = cleared[active]
        head = active & (lane == 0)
        ks[first + seg[head]] = k[head]
        emulate_store_rows(rows, out, first * hw, count * hw, w)
    assert (out < 2).all() and (ks >= 0).all()
    return out.reshape(n, hw), ks.astype(np.int32)


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
    got = ApplyKernel(ct, "cpu")(
        torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    emu = emulate_apply_kernel(ct, board, cover, valid)
    for w, g, e, name in zip(want, got, emu, ("board", "k", "legal")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        np.testing.assert_array_equal(e, np.asarray(w), name)
    assert int(np.asarray(want[1]).sum()) > 0  # the clear path ran


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
    assert 0 < want.mean() < 1 and lk.launches == 0


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
    nb, k, legal = ApplyKernel(ct, "cpu")(
        torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    assert not legal.any() and int(k.sum()) == 0
    np.testing.assert_array_equal(nb.numpy(), board)
    for w, g in zip(want, (nb, k, legal)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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
    """The bit-row mask and clear where H <= 32 and W <= 32, with B7's
    launch shape and the rectangle piece table; the general kernels, with
    the per-cell piece table, on a board wider or taller than that."""
    cfg = (tcfg.EnvConfig(height=33, width=9) if case == "tall33"
           else _pair(case)[1])
    mk, ck = MaskKernel(cfg, "cpu"), ClearScanKernel(cfg, "cpu")
    rows = cfg.height <= 32 and cfg.width <= 32
    assert (mk.shape is not None, ck.shape is not None) == (rows, rows)
    if rows:
        assert mk.shape == ck.shape == PackedMaskKernel(cfg, "cpu").shape
        np.testing.assert_array_equal(mk.piece_table.numpy(), piece_rows_table(cfg))
    else:
        np.testing.assert_array_equal(mk.piece_table.numpy(), piece_table(cfg))


@pytest.mark.parametrize("preset", ["tenten", "woodoku", "big"])
@pytest.mark.parametrize("addr", [3, 8, 13])
def test_bit_row_emulations_take_any_board_address(preset, addr):
    """Boards that start off a 16-byte boundary: every block stages an
    unaligned head and tail byte by byte, and both bit-row kernels'
    emulations still equal the plain versions (the last block short of
    its env-slots at N = 13)."""
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
