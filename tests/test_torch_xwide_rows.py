"""The u8 clear and apply on rows of 1025 to 4096 cells, on the CPU,
against the JAX package.

Past 1024 cells a row (NW = ceil(W / 32) > 32 words) the xwide clear (K3,
``clear_xwide_long``) and apply (K2, ``apply_xwide_long``) hold one env a
warp: lane l holds words l + 32 j of every row in slot j < NJ =
ceil(NW / 32) (``csrc/clear.cu`` ``clear_xwide_kernel``'s NJ instances),
so every lane works and only the last slot is ragged (a slot past NW holds
no word). A row is full when each of a lane's slots is (the AND over them,
then one reduction over the warp); the top word's pad bits belong to word
NW - 1 wherever it lies; a 3x3 region's field may cross from word 32 j + 31
(lane 31, slot j) to word 32 (j + 1) (lane 0, slot j + 1), which the band
shuffles round the warp carry. The mask and the all-pieces legality take
their own long-row instances there (``test_torch_mask_rows.py``). Numpy emulations of the NJ form (every lane of
a block at once, as (warps, 32, NJ) arrays), fed the tables and launch
shapes the wrappers hand the kernels and boards staged at byte offsets 0,
3 and 13, are held bit-equal to the wrappers' plain versions and to the
JAX package: the Pallas clear and apply kernels in interpret mode and the
u8 engine's ``clear_scan`` on 2x1056 (the smoke's ``w1056`` board), 3x1030
(33 words, a 6-bit top word), 2x2048 (NJ = 2 exactly, no ragged slot) and
9x1035 with 3x3 regions and a hand of three (fields across the lane-31
border at columns 1023..1025); on 33x1030, more than 32 rows (the windowed
form, the covers ORed over the staged boards), the Pallas kernels in
interpret mode only, with rule tables of line masks alone (the full tables
would take 5 HW^2 = 5.8 GB in each package). Rows of more than 4096 cells
keep the general clear and apply. The kernels themselves run only on the
card (``chip_smoke.py``). Everything is integer or bool and must be
bit-equal.
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
from blockpuzzle_tpu_torch.kernels import (
    ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel,
)
from blockpuzzle_tpu_torch.kernels.clear import check_general_fits
from blockpuzzle_tpu_torch.kernels.collision import every_piece_shape
from blockpuzzle_tpu_torch.kernels.packed import (
    MAX_XWIDE, SMEM_OPT_IN, U32, XWIDE_APPLY_WARPS, XWIDE_SEGMENT, XWIDE_WARPS,
    apply_launch_shape, clear_launch_shape, u8_launch_shape, xwide_apply_smem_bytes,
    xwide_clear_smem_bytes, xwide_windows,
)
from blockpuzzle_tpu_torch.utils.bounds import COSTS, bound
from test_torch_kernels import _fshr, apply_cases, assert_apply_cases
from test_torch_packed import _popc, _reduce, _shfl
from test_torch_tall import emulate_store_tall
from test_torch_xwide import (
    emulate_stage_words, emulate_store_apply_words, xwide_cells,
)

LONG = {"2x1056": dict(height=2, width=1056, piece_set="mini5"),
        "3x1030": dict(height=3, width=1030, piece_set="mini5"),
        "2x2048": dict(height=2, width=2048, piece_set="mini5"),
        "9x1035r3": dict(height=9, width=1035, region_clear=True, region_size=3,
                         queue_size=3, piece_set="mini5")}
# more than 32 rows: the windowed form (the apply's covers ORed over the
# staged boards, one warp a block)
LONG_TALL = dict(height=33, width=1030, piece_set="mini5")
# four envs a block of the clear and of the one-window apply: four blocks,
# the last ragged
N = 14


def _pair(case):
    return jcfg.EnvConfig(**LONG[case]), tcfg.EnvConfig(**LONG[case])


@pytest.fixture(autouse=True)
def _drop_new_tables():
    """Drop the rule tables a test built from both packages' caches when it
    ends (9x1035's take about 0.43 GB in each)."""
    import blockpuzzle_tpu.rules as jrules

    caches = (rules._TABLE_CACHE, jrules._TABLE_CACHE)
    before = [set(c) for c in caches]
    yield
    for cache, old in zip(caches, before):
        for cfg in set(cache) - old:
            del cache[cfg]


@functools.lru_cache(maxsize=1)
def jax_engine(case):
    """The JAX u8 engine on ``case`` (one at a time: each holds its rule
    tables)."""
    return jax_make_env(_pair(case)[0], state_impl="u8")


def long_cells(cfg, n, rng, fill):
    """``xwide_cells`` (full first and last rows, full columns either side
    of the first word border and at the right edge, a row full but for its
    first cell, the first column of every word but the first, 3x3 regions
    across the first two word borders, a full board and an empty one), plus
    full columns either side of the lane-31 border, 1023 and 1024 (env 7),
    a row full but for column 1024, the first of lane 0's second slot (env
    8), and with regions a full 3x3 region across it, columns 1023..1025
    (env 9)."""
    cells = xwide_cells(cfg, n, rng, fill).reshape(n, cfg.height, cfg.width)
    cells[7][:, [1023, 1024]] = 1
    cells[8, 0, :] = 1
    cells[8, 0, 1024] = 0
    if cfg.region_clear:
        cells[9, 3:6, 1023:1026] = 1
    return cells.reshape(n, -1)


def emulate_clear_xwide_long_kernel(cfg, board, ck, addr=0, apply=None):
    """csrc/clear.cu clear_xwide_kernel at NJ > 1 on ``ck``'s launch shape
    (one env a warp): the block loads its envs' boards as row words
    (``stage_words``); lane l holds words l + 32 j in slot j (a slot past
    NW none). Pass 1 ANDs each slot's rows into its full columns (a slot of
    no word: none); pass 2 walks windows of 32 rows (32 - 32 mod rs with
    regions): bit i of a lane's word marks row w0 + i full in every slot
    (the top word's bits past W set; a slot of no word counts as full), one
    reduction over the warp giving the window's full rows; then a band of
    rs rows at a time (a row without regions): each slot's band AND, word
    w + 1's band by a shuffle from lane l + 1 mod 32 (lane 31 takes its
    slot j + 1's, 0 past the last), each field that starts in word w read
    from the funnel-shifted pair, the part of a full field past word w
    handed up by a shuffle from lane l - 1 mod 32 (lane 0 takes its slot
    j - 1's), then each row cleared in place. k = the full rows + the
    warp's sum of every slot's full columns and fields. The apply instance,
    given ``apply = (cover, valid, cover_addr)``, as
    ``test_torch_xwide.emulate_clear_xwide_kernel``'s: covers beside the
    boards on a board of one window (the overlap the OR over a lane's slots
    and rows, one reduction), ORed over them above (``stage_words<true>``,
    an illegal env's input stored back). Returns (board, k), and legal for
    the apply."""
    h, w, hw, n = cfg.height, cfg.width, cfg.num_cells, len(board)
    nw = -(-w // 32)
    nj = -(-nw // 32)
    assert nj > 1 and ck.shape[0] == 1
    rs = cfg.region_size if cfg.region_clear else 0
    warps = ck.shape[1]
    per_block = warps
    l = np.arange(32)
    lane = np.broadcast_to(l, (warps, 32))
    sw = np.zeros(32, np.int64)                               # one segment: the warp
    seg = np.broadcast_to(np.arange(warps)[:, None], (warps, 32))
    wd = lane[..., None] + 32 * np.arange(nj)                 # (warps, 32, NJ): the words
    has = wd < nw
    assert has[..., : nj - 1].all()                           # only the last slot ragged
    tail = w - 32 * (nw - 1)
    pad = np.where((wd + 1 == nw) & (tail < 32), (U32 << tail) & U32, 0)
    tile0 = (1 << rs) - 1 if rs else 0
    win = 32 - 32 % rs if rs else 32
    out, ks = np.full(n * hw, 2, np.uint8), np.full(n, -1, np.int64)
    legals = np.full(n, -1, np.int64)
    zero = np.zeros((warps, 32, 1), np.int64)

    def slots(v):
        """(warps, 32) per slot -> (warps, 32, NJ)."""
        return np.stack(v, axis=-1)

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
        active = seg < count
        at = np.where(active, seg, 0)
        wc = np.minimum(wd, nw - 1)
        x = np.where(has[..., None], words[at[..., None], :, wc], 0)  # (warps, 32, NJ, H)
        write = active
        if placed:
            write = active & valid[first + at] & ~keep[at]
        elif apply is not None:                               # the covers beside them
            cover, valid, cover_addr = apply
            covers = emulate_stage_words(cover.reshape(-1), lo, hi, cover_addr, w,
                                         nw).reshape(count, h, nw)
            y = np.where(has[..., None], covers[at[..., None], :, wc], 0)
            hit = ((x & y) != 0).any(axis=(2, 3)).astype(np.int64)
            overlap = _reduce(hit, sw, np.bitwise_or)
            write = active & valid[first + at] & (overlap == 0)
            x = np.where(write[..., None, None], x | y, x)    # placed in place
        cols = np.where(has, np.bitwise_and.reduce(x, axis=3), 0)
        got = _popc(cols).sum(axis=2)
        cleared = np.full_like(x, -1)
        g = rs or 1
        c1 = -(-32 * wd // rs) * rs if rs else 0
        k = np.zeros((warps, 32), np.int64)
        for w0 in range(0, h, win):
            w1 = min(w0 + win, h)
            full = sum((~has | ((x[..., r] | pad) == U32)).all(axis=2).astype(np.int64)
                       << (r - w0) for r in range(w0, w1))
            assert (full >> 32 == 0).all()                    # one 32-bit word a window
            rows_full = _reduce(full, sw, np.bitwise_and)
            k += _popc(rows_full)
            for r0 in range(w0, w1, g):
                rows_here = min(g, w1 - r0)
                reg = np.zeros_like(cols)
                if rs:
                    band = np.where(has, np.bitwise_and.reduce(x[..., r0 : r0 + rows_here],
                                                               axis=3), U32)
                    rot = slots([_shfl(band[..., j], (l + 1) % 32) for j in range(nj)])
                    nxt = np.where((lane < 31)[..., None], rot,
                                   np.concatenate([rot[..., 1:], zero], axis=2))
                    hi_word = np.where(wd + 1 < nw, nxt, 0)
                    spill = np.zeros_like(cols)
                    if rows_here == rs:
                        for c0 in c1[None] + rs * np.arange(-(-32 // rs) + 1)[:, None, None,
                                                                             None]:
                            ok = (c0 < 32 * (wd + 1)) & (c0 + rs <= w)
                            b = np.where(ok, c0 - 32 * wd, 0)
                            hit = ok & ((_fshr(band, hi_word, b) & tile0) == tile0)
                            reg |= np.where(hit, (tile0 << b) & U32, 0)
                            spill |= np.where(hit & (b + rs > 32), tile0 >> (32 - b), 0)
                            got += hit.sum(axis=2)
                    up = slots([_shfl(spill[..., j], (l + 31) % 32) for j in range(nj)])
                    reg |= np.where((lane > 0)[..., None], up,
                                    np.concatenate([zero, up[..., :-1]], axis=2))
                for r in range(r0, r0 + rows_here):
                    cleared[..., r] = np.where(((rows_full >> (r - w0)) & 1)[..., None], 0,
                                               x[..., r] & ~(cols | reg) & U32)
        k = k + _reduce(got, sw, np.add)
        staged = np.full(per_block * h * nw, -1, np.int64)
        mine = (active[..., None] & has)                      # (warps, 32, NJ)
        for r in range(h):                                    # an illegal env: as staged
            at_r = (seg[..., None] * h + r) * nw + wd
            assert (staged[at_r[mine]] == -1).all()           # each word staged once
            staged[at_r[mine]] = np.where(write[..., None], cleared[..., r], x[..., r])[mine]
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


def emulate_apply_xwide_long_kernel(cfg, board, cover, valid, ak, addr=0, cover_addr=0):
    """csrc/clear.cu clear_xwide_kernel's apply instance at NJ > 1 on
    ``ak``'s launch shape (``emulate_clear_xwide_long_kernel``): (board, k,
    legal)."""
    return emulate_clear_xwide_long_kernel(cfg, board, ak, addr, (cover, valid, cover_addr))


def long_apply_cases(cfg, n, rng):
    """``apply_cases`` (legal and illegal actions, an invalid anchor, an
    action that completes a row, one over a full row, a full board and an
    empty one), plus 1x1 actions: one that completes row 0 at column 1024,
    lane 0's second slot (env 9), one that overlaps a board cell there (env
    10: illegal), and with regions one that completes the 3x3 region of
    columns 1023..1025 across the lane-31 border (env 11).  (board, cover,
    valid)."""
    t = rules.tables_for(cfg)
    board, cover, valid = apply_cases(cfg, n, rng)
    grid = board.reshape(n, cfg.height, cfg.width)
    w = cfg.width
    grid[9, 0, :] = 1
    grid[9, 0, 1024] = 0
    grid[10, 0, 1024] = 1
    for env in (9, 10):
        cover[env], valid[env] = t.cover[1024], t.valid[1024]
    if cfg.region_clear:
        grid[11] = 0
        grid[11, 3:6, 1023:1026] = 1
        grid[11, 4, 1024] = 0
        cover[11], valid[11] = t.cover[4 * w + 1024], t.valid[4 * w + 1024]
    return board, cover, valid


def assert_long_apply_cases(cfg, board, want):
    """What ``long_apply_cases``' envs must give: ``assert_apply_cases``,
    row 0 completed at column 1024 and cleared (env 9), the overlap there a
    strict no-op (env 10), the region across the lane-31 border completed
    and cleared (env 11)."""
    assert_apply_cases(cfg, board, want)
    new_board, k, legal = want
    grid = new_board.reshape(len(board), cfg.height, cfg.width)
    assert legal[9] and k[9] >= 1 and not grid[9, 0].any()
    assert not legal[10] and k[10] == 0 and (new_board[10] == board[10]).all()
    if cfg.region_clear:
        assert legal[11] and k[11] == 1 and not grid[11].any()


@pytest.mark.parametrize("case", LONG)
def test_long_rows_wrappers_pick_the_xwide_clear_and_apply(case):
    """Rows of 1025 to 4096 cells: the clear and the apply take the xwide
    kernel's long-row instances (one env a warp, ``XWIDE_WARPS`` warps a
    block), and so do the mask and the legality (one env-slot a warp; the
    mask's launch shape, at S and at S = P)."""
    _, ct = _pair(case)
    ck, ak = ClearScanKernel(ct, "cpu"), ApplyKernel(ct, "cpu")
    assert (ck.kind, ck.instance, ck.name, ck.shape) == (
        "xwide", "xwide_long", "clear_xwide_long", (1, XWIDE_WARPS))
    assert (ak.kind, ak.instance, ak.name, ak.shape) == (
        "xwide", "xwide_long", "apply_xwide_long", (1, XWIDE_WARPS))
    assert ck.xwide_long_launches == ak.xwide_long_launches == 0
    assert u8_launch_shape(ct) == every_piece_shape(ct) == (1, XWIDE_WARPS)
    if ct.num_cells <= 4096:  # (their rule tables take 5 HW^2 bytes)
        mk, lk = MaskKernel(ct, "cpu"), LegalityKernel(ct, "cpu")
        assert (mk.kind, mk.name, mk.shape) == ("xwide", "mask_xwide_long", (1, XWIDE_WARPS))
        assert (lk.kind, lk.name, lk.shape) == ("xwide", "legality_xwide_long",
                                                (1, XWIDE_WARPS))


@pytest.mark.parametrize("case", LONG)
def test_long_rows_clear_matches_jax_clear_kernel(case):
    """K3 on rows of more than 1024 cells: the Pallas clear kernel in
    interpret mode, the JAX u8 engine's ``clear_scan``, the wrapper (plain
    version on the CPU) and the NJ form's emulation, bit-equal: full first
    and last rows (across every lane and slot), full columns either side of
    the first word border, of the lane-31 border and at the right edge, rows
    full but for one cell (its first, or column 1024), 3x3 regions across
    word borders and across the lane-31 border, a full board and an empty
    one."""
    cj, ct = _pair(case)
    board = long_cells(ct, N, np.random.default_rng(31), fill=0.6)
    want = [np.asarray(x) for x in jk.ClearScanKernel(cj, tile_n=N)(
        jnp.asarray(board), interpret=True)]
    engine = jax_engine(case).clear_scan(jnp.asarray(board))
    ck = ClearScanKernel(ct, "cpu")
    got = ck(torch.as_tensor(board))
    emu = emulate_clear_xwide_long_kernel(ct, board, ck)
    for i, name in enumerate(("board", "k")):
        np.testing.assert_array_equal(np.asarray(engine[i]), want[i], name)
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    h, w = ct.height, ct.width
    k, cleared = want[1], want[0].reshape(N, h, w)
    regions = (h // ct.region_size) * (w // ct.region_size) if ct.region_clear else 0
    assert k[N - 1] == h + w + regions and not cleared[N - 1].any() and k[N - 2] == 0
    assert k[1] >= 1 and not cleared[1, 0].any() and k[2] >= 1 and not cleared[2, h - 1].any()
    assert k[7] >= 2 and not cleared[7][:, [1023, 1024]].any()
    assert cleared[8, 0].any()                                # not a full row
    if ct.region_clear:
        assert k[9] >= 1 and not cleared[9, 3:6, 1023:1026].any()
    assert ck.xwide_long_launches == ck.general_launches == 0


@pytest.mark.parametrize("case", LONG)
@pytest.mark.parametrize("addr", [3, 13])
def test_long_rows_clear_emulation_takes_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary: the NJ form's emulation
    stages an unaligned head and tail byte by byte and still equals the
    plain version."""
    _, ct = _pair(case)
    board = long_cells(ct, N, np.random.default_rng(addr), fill=0.55)
    ck = ClearScanKernel(ct, "cpu")
    for e, p in zip(emulate_clear_xwide_long_kernel(ct, board, ck, addr),
                    ck(torch.as_tensor(board))):
        np.testing.assert_array_equal(e, p.numpy())


@pytest.mark.parametrize("case", LONG)
def test_long_rows_apply_matches_pallas_apply_kernel(case):
    """K2 on rows of more than 1024 cells: the Pallas apply kernel in
    interpret mode, ``place_and_clear`` over the JAX engine's
    ``clear_scan``, the wrapper (plain version on the CPU) and the NJ form's
    emulation, bit-equal on ``long_apply_cases``: legal and illegal actions
    (invalid, or overlapping: a strict no-op with k = 0, also over a full
    row), actions that complete a row at column 1024 and a 3x3 region
    across the lane-31 border."""
    cj, ct = _pair(case)
    board, cover, valid = long_apply_cases(ct, N, np.random.default_rng(33))
    want = [np.asarray(x) for x in jk.ApplyKernel(cj, tile_n=N)(
        jnp.asarray(board), jnp.asarray(cover), jnp.asarray(valid), interpret=True)]
    env = jax_engine(case)
    overlap = (board & cover).astype(np.int32).sum(axis=1) > 0
    legal = valid & ~overlap
    placed = np.where(legal[:, None], board | cover, board)
    cleared, k = (np.asarray(x) for x in env.clear_scan(jnp.asarray(placed)))
    np.testing.assert_array_equal(np.where(legal[:, None], cleared, board), want[0])
    np.testing.assert_array_equal(np.where(legal, k, 0), want[1])
    np.testing.assert_array_equal(legal, want[2])
    ak = ApplyKernel(ct, "cpu")
    got = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    emu = emulate_apply_xwide_long_kernel(ct, board, cover, valid, ak)
    for i, name in enumerate(("board", "k", "legal")):
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    assert_long_apply_cases(ct, board, want)
    assert ak.xwide_long_launches == ak.general_launches == 0


@pytest.mark.parametrize("case", LONG)
@pytest.mark.parametrize("addr", [3, 13])
def test_long_rows_apply_emulation_takes_any_address(case, addr):
    """Boards and covers that start off a 16-byte boundary, each at its own
    offset: the NJ form's apply emulation loads both as row words and still
    equals the plain version."""
    _, ct = _pair(case)
    board, cover, valid = long_apply_cases(ct, N, np.random.default_rng(addr))
    ak = ApplyKernel(ct, "cpu")
    want = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    assert want[2].any() and not want[2].all()
    for cover_addr in (addr, (addr + 7) % 16):
        emu = emulate_apply_xwide_long_kernel(ct, board, cover, valid, ak, addr, cover_addr)
        for e, p in zip(emu, want):
            np.testing.assert_array_equal(e, p.numpy())


def _line_tables_only(package, cfg):
    """``package``'s rule tables for ``cfg`` with the line masks alone: the
    pieces of ``cfg``'s piece set, no anchors (an empty cover), and the row,
    column (and region) masks ``build_tables`` makes, which are all the
    clear and the apply read."""
    h, w = cfg.height, cfg.width
    small = package.build_tables(dataclasses.replace(cfg, height=3, width=3))
    cell = np.arange(h * w)
    r, c = cell // w, cell % w
    rows = r == np.arange(h)[:, None]
    cols = c == np.arange(w)[:, None]
    regions = np.zeros((0, h * w), bool)
    if cfg.region_clear:
        rs = cfg.region_size
        tile = np.where((r < h // rs * rs) & (c < w // rs * rs),
                        r // rs * (w // rs) + c // rs, -1)
        regions = tile == np.arange((h // rs) * (w // rs))[:, None]
    return dataclasses.replace(
        small, cover=np.zeros((0, h * w), np.uint8), valid=np.zeros(0, bool),
        row_masks=rows.astype(np.uint8), col_masks=cols.astype(np.uint8),
        region_masks=regions.astype(np.uint8))


@pytest.fixture
def long_tall():
    """33x1030 in both packages, its rule tables the line masks alone
    (``_line_tables_only``), dropped from the caches at the end."""
    import blockpuzzle_tpu.rules as jrules

    cj, ct = jcfg.EnvConfig(**LONG_TALL), tcfg.EnvConfig(**LONG_TALL)
    # the stand-in's masks are build_tables' on smaller boards
    for shape in (dict(height=33, width=40), dict(height=9, width=39, region_clear=True,
                                                  region_size=3)):
        small = tcfg.EnvConfig(**shape, piece_set="mini5")
        full, lines = rules.build_tables(small), _line_tables_only(rules, small)
        for f in ("row_masks", "col_masks", "region_masks", "pieces"):
            np.testing.assert_array_equal(getattr(lines, f), getattr(full, f), f)
    jrules._TABLE_CACHE[cj] = _line_tables_only(jrules, cj)
    rules._TABLE_CACHE[ct] = _line_tables_only(rules, ct)
    yield cj, ct


def _rect(cfg, r, c, ph, pw):
    """The cover of a ph x pw rectangle anchored at (r, c)."""
    cover = np.zeros((cfg.height, cfg.width), np.uint8)
    cover[r : r + ph, c : c + pw] = 1
    return cover.reshape(-1)


def tall_long_cases(cfg, n, rng):
    """Random 0/1 boards and 1x2 or 2x1 covers, ~90% valid, plus: a full
    row 32 past the window border (env 0), the full columns 1023 and 1024
    (env 1), a row 32 full but for column 1024 that a 1x1 action completes
    (env 2), the same action over a set cell (env 3: illegal), an invalid
    action on a board holding full lines (env 4), a full board and an empty
    one.  (board, cover, valid)."""
    h, w, hw = cfg.height, cfg.width, cfg.num_cells
    board = (rng.random((n, h, w)) < 0.5).astype(np.uint8)
    cover = np.zeros((n, hw), np.uint8)
    for e in range(n):
        tall = bool(rng.integers(2))
        cover[e] = _rect(cfg, int(rng.integers(h - tall)), int(rng.integers(w - 1 + tall)),
                         1 + tall, 2 - tall)
    valid = rng.random(n) < 0.9
    board[0, 32, :] = 1
    board[1][:, [1023, 1024]] = 1
    board[2, 32, :] = 1
    board[2, 32, 1024] = 0
    board[3, 32, 1024] = 1
    for e in (2, 3):
        cover[e], valid[e] = _rect(cfg, 32, 1024, 1, 1), True
    board[4, 0, :] = 1
    board[4][:, 7] = 1
    valid[4] = False
    board[n - 1], board[n - 2] = 1, 0
    cover[n - 2], valid[n - 2] = _rect(cfg, 0, 0, 1, 1), True
    return board.reshape(n, -1), cover, valid


def test_long_rows_windowed_form_matches_pallas_kernels(long_tall):
    """33x1030: more than 32 rows of more than 1024 cells, the NJ form's
    windows (the clear's pass 2 in windows of 32 rows; the apply's covers
    ORed over the staged boards, one warp a block, an illegal env's input
    stored back).  The Pallas clear and apply kernels in interpret mode,
    the wrappers (plain versions) and the emulations, bit-equal, also on
    boards and covers off a 16-byte boundary."""
    cj, ct = long_tall
    n = 7
    assert xwide_windows(ct)
    board, cover, valid = tall_long_cases(ct, n, np.random.default_rng(35))
    ck, ak = ClearScanKernel(ct, "cpu"), ApplyKernel(ct, "cpu")
    assert (ck.name, ck.shape) == ("clear_xwide_long", (1, XWIDE_WARPS))
    assert (ak.name, ak.shape) == ("apply_xwide_long", (1, XWIDE_APPLY_WARPS))
    want = [np.asarray(x) for x in jk.ClearScanKernel(cj, tile_n=n)(
        jnp.asarray(board), interpret=True)]
    got = ck(torch.as_tensor(board))
    for addr in (0, 13):
        for i, name in enumerate(("board", "k")):
            np.testing.assert_array_equal(got[i].numpy(), want[i], name)
            np.testing.assert_array_equal(
                emulate_clear_xwide_long_kernel(ct, board, ck, addr)[i], want[i], name)
    assert want[1][0] >= 1 and not want[0][0].reshape(33, -1)[32].any()
    assert want[1][1] >= 2 and want[1][n - 1] == 33 + 1030
    want = [np.asarray(x) for x in jk.ApplyKernel(cj, tile_n=n)(
        jnp.asarray(board), jnp.asarray(cover), jnp.asarray(valid), interpret=True)]
    got = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    for addr, cover_addr in ((0, 0), (3, 10)):
        emu = emulate_apply_xwide_long_kernel(ct, board, cover, valid, ak, addr, cover_addr)
        for i, name in enumerate(("board", "k", "legal")):
            np.testing.assert_array_equal(got[i].numpy(), want[i], name)
            np.testing.assert_array_equal(emu[i], want[i], name)
    new_board, k, legal = want
    assert legal[2] and k[2] >= 1 and not new_board[2].reshape(33, -1)[32].any()
    for e in (3, 4, n - 1):
        assert not legal[e] and k[e] == 0 and (new_board[e] == board[e]).all()
    assert legal[n - 2] and new_board[n - 2].sum() == 1


def test_long_rows_launch_shapes_fit():
    """The long-row launch shapes on boards of 1 to 1000 rows of 1025 to
    4096 cells: one env a warp, ``XWIDE_WARPS`` warps a block for the clear
    and for the apply on a board of one window, ``XWIDE_APPLY_WARPS`` above,
    wherever they fit what a block may opt in to and stage fewer than 2^21
    bytes; fewer warps where the next would not fit; None only where one
    warp does not; and none past 4096 cells a row."""
    for h in (1, 2, 3, 9, 32, 33, 40, 100, 129, 400, 1000):
        for w in (1025, 1030, 1056, 2048, 2049, 3000, 4096):
            cfg = tcfg.EnvConfig(height=h, width=w)
            for shape, smem, most in (
                    (clear_launch_shape(cfg), xwide_clear_smem_bytes, XWIDE_WARPS),
                    (apply_launch_shape(cfg), xwide_apply_smem_bytes,
                     XWIDE_APPLY_WARPS if xwide_windows(cfg) else XWIDE_WARPS)):
                if shape is None:
                    assert smem(cfg, 1) > SMEM_OPT_IN or cfg.num_cells >= 1 << 21
                    continue
                per_warp, warps = shape
                assert per_warp == 1 and 1 <= warps <= most
                assert smem(cfg, warps) <= SMEM_OPT_IN and warps * cfg.num_cells < 1 << 21
                if warps < most:
                    assert (smem(cfg, warps + 1) > SMEM_OPT_IN
                            or (warps + 1) * cfg.num_cells >= 1 << 21)
    # shared memory: the clear's rows of NW words; the apply's two arrays on
    # a board of one window, its placed rows and a word an env above
    cfg = tcfg.EnvConfig(height=2, width=1056)
    assert xwide_clear_smem_bytes(cfg, 4) == 4 * 4 * 2 * 33
    assert xwide_apply_smem_bytes(cfg, 4) == 8 * 4 * 2 * 33
    cfg = tcfg.EnvConfig(height=33, width=1030)
    assert xwide_apply_smem_bytes(cfg, 1) == 4 * (33 * 33 + 1)
    # one warp's 1000 rows of 128 words pass 227 KB; 400 rows fit
    assert clear_launch_shape(tcfg.EnvConfig(height=1000, width=4096)) is None
    assert clear_launch_shape(tcfg.EnvConfig(height=400, width=4096)) == (1, 1)
    for w in (MAX_XWIDE + 1, 4128, 5000):
        cfg = tcfg.EnvConfig(height=2, width=w)
        assert clear_launch_shape(cfg) is None and apply_launch_shape(cfg) is None
    assert MAX_XWIDE == 4 * 32 * 32                          # NJ = 4 at most
    # up to XWIDE_SEGMENT cells a row the clear keeps the mask's launch shape
    for h, w in ((10, 10), (8, 40), (33, 9), (130, 8), (8, 136), (40, 136), (600, 136),
                 (2, XWIDE_SEGMENT), (2000, XWIDE_SEGMENT)):
        cfg = tcfg.EnvConfig(height=h, width=w)
        assert clear_launch_shape(cfg) == u8_launch_shape(cfg)


def test_rows_past_4096_cells_keep_the_general_clear_and_apply():
    """1x4128 (129 words a row, past the NJ = 4 instances): the clear, the
    apply, the mask and the legality keep their general kernels (whose
    one-warp block stages the board and its line flags), and the clear's
    plain version equals the Pallas clear kernel in interpret mode on
    boards holding a full row and full columns at the lane-31 and last
    borders."""
    shape = dict(height=1, width=4128, piece_set="mini5")
    cj, ct = jcfg.EnvConfig(**shape), tcfg.EnvConfig(**shape)
    ck, ak = ClearScanKernel(ct, "cpu"), ApplyKernel(ct, "cpu")
    assert (ck.kind, ck.name, ck.shape) == ("general", "clear_general", None)
    assert (ak.kind, ak.name, ak.shape) == ("general", "apply_general", None)
    assert (MaskKernel(ct, "cpu").kind, LegalityKernel(ct, "cpu").kind) == ("general",) * 2
    check_general_fits(ct, ct.height + ct.width)
    n = 4
    board = (np.random.default_rng(37).random((n, ct.num_cells)) < 0.6).astype(np.uint8)
    board[1] = 1
    board[2, [1023, 4095, 4127]] = 1
    want = [np.asarray(x) for x in jk.ClearScanKernel(cj, tile_n=n)(
        jnp.asarray(board), interpret=True)]
    got = ck(torch.as_tensor(board))
    for i, name in enumerate(("board", "k")):
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
    assert want[1][1] == 1 + 4128 and want[1][2] >= 3


@pytest.mark.parametrize("name", ["clear_xwide_long", "apply_xwide_long"])
def test_long_row_kernels_are_bytes_bound_on_2x1056(name):
    """The long-row clear and apply at N = 49152 on 2x1056 move the
    general kernels' bytes (the clear 4228 B an env: the board in, the
    cleared board and k out, 0.062034 ms at 3.35 TB/s; the apply 6342 B:
    board and cover in, a valid byte; board, k and legal out, 0.093051 ms),
    above their operations at the integer rate."""
    cfg, n = tcfg.EnvConfig(height=2, width=1056, piece_set="mini5"), 49152
    hw = cfg.num_cells
    board, flags = torch.zeros(n, hw, dtype=torch.uint8), torch.zeros(n, dtype=torch.bool)
    k = torch.zeros(n, dtype=torch.int32)
    if name == "clear_xwide_long":
        inputs, outputs, per_env, ms = (board,), (board, k), 4228, 0.062034
    else:
        inputs, outputs, per_env, ms = (board, board, flags), (board, k, flags), 6342, 0.093051
    nbytes, ops = COSTS[name](cfg, inputs, outputs)
    general, _ = COSTS[name.replace("_xwide_long", "_general")](cfg, inputs, outputs)
    assert nbytes == general == per_env * n
    assert ops == COSTS[name.removesuffix("_long")](cfg, inputs, outputs)[1]
    b = bound(list(inputs) + list(outputs), ops)
    assert b["bound_by"] == "bytes" and round(b["bound_ms"], 6) == ms
