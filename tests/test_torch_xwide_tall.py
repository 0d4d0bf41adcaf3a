"""The u8 mask, clear, apply and all-pieces legality on boards of more
than 32 rows of 129 to 1024 cells, on the CPU, against the JAX package;
and the general clear and apply on boards of more than 12288 cells.

Rows of more than 128 cells take the xwide kernels of the u8 mask (K1,
``mask_xwide``), clear (K3, ``clear_xwide``), apply (K2, ``apply_xwide``,
the clear kernel's apply instance) and legality (K4, ``legality_xwide``,
the mask kernel's every-piece instance) at any height: a segment of NW =
ceil(W / 32) lanes an env-slot or env, lane w holding word w of every
row. The mask's row loop holds the 8 rows below the anchor row in a ring
whatever H is; where S = 1 its legal rows go over the board rows they were
read from (the emulation checks that no word is read after it is
written). The clear walks its rows in windows of 32 (32 - 32 mod rs with
regions of size rs, so no band crosses a window): a full-row word and one
reduction a window. The apply is the clear with each board's cover ORed
over its row words as the block loads them, an overlap found by the
cover's atomics, and an illegal env's input bytes stored back; the
legality is the mask of a hand holding every piece, each env's rows
staged once for all its slots. Numpy emulations of all four
(``test_torch_xwide.py``, ``test_torch_legality.py``, every lane of a
block at once), fed the tables and launch shapes the wrappers hand the
kernels, boards (and covers) staged at byte offsets 0, 3 and 13, and
blocks of 1 to 3 warps (what the launch shape gives where 4 do not fit),
are held bit-equal to the wrappers' plain versions and to the JAX package:
the u8 engine's shift mask for K1, the Pallas clear kernel in interpret
mode and the engine's ``clear_scan`` for K3, the Pallas apply kernel in
interpret mode and ``place_and_clear`` over the engine's ``clear_scan`` for
K2, the engine's ``legal_all_pieces`` for K4. The boards: 33x129 (one row
past a window, a one-column top word, a 5-cell vertical bar across row
32), 40x136, 36x135 with 3x3 regions and a hand of three (fields across
word borders and a band at the window border of 30 rows) and 66x130 (two
window borders), all but the first with the five pieces of at most 2x2
cells (their rule tables stay small).

The line tables no longer refuse a board of more than 12288 cells and
lines (100x124): the general clear and apply stage an env in one warp's
shared memory and refuse only what one warp cannot hold.
The kernels themselves run only on the card (``chip_smoke.py``).
Everything is integer or bool and must be bit-equal.
"""

import dataclasses
import functools
import types

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
from blockpuzzle_tpu_torch.kernels.clear import GENERAL_WARPS, check_general_fits, general_warps
from blockpuzzle_tpu_torch.kernels.collision import every_piece_shape, place_and_clear
from blockpuzzle_tpu_torch.kernels.packed import (
    SMEM_OPT_IN, XWIDE_APPLY_WARPS, XWIDE_WARPS, apply_launch_shape, xwide_launch_shape,
)
from blockpuzzle_tpu_torch.utils.bounds import COSTS, bound
from test_torch_kernels import apply_cases, assert_apply_cases
from test_torch_legality import emulate_legality_instance, legality_boards
from test_torch_xwide import (
    bar_piece, emulate_apply_xwide_kernel, emulate_clear_xwide_kernel,
    emulate_mask_xwide_kernel, xwide_cells, xwide_hands,
)

XTALL = {"33x129": dict(height=33, width=129),
         "40x136": dict(height=40, width=136, piece_set="mini5"),
         "36x135r3": dict(height=36, width=135, region_clear=True, region_size=3,
                          queue_size=3, piece_set="mini5"),
         "66x130": dict(height=66, width=130, piece_set="mini5")}
# two blocks on every board, the last one ragged (three hands a block of
# 24 env-slots: five on 36x135)
N = 37


def _pair(case):
    return jcfg.EnvConfig(**XTALL[case]), tcfg.EnvConfig(**XTALL[case])


@functools.lru_cache(maxsize=1)
def jax_engine(case):
    """The JAX u8 engine with the shift mask (one at a time: each holds its
    rule table)."""
    return jax_make_env(_pair(case)[0], state_impl="u8", mask_impl="shift")


@pytest.fixture(autouse=True)
def _drop_new_tables():
    """A board here has a rule table of hundreds of MB in each package
    (both keep them in a dict by config): drop the ones a test built when
    it ends, so that the tests of this file do not pile them up."""
    import blockpuzzle_tpu.rules as jrules

    caches = (rules._TABLE_CACHE, jrules._TABLE_CACHE)
    before = [set(c) for c in caches]
    yield
    for cache, old in zip(caches, before):
        for cfg in set(cache) - old:
            del cache[cfg]


def tall_cells(cfg, n, rng, fill):
    """``xwide_cells``, plus a full row past every window border (rows 32
    and 64; 30 and 60 with regions) on env 7, row 32 occupied at the first
    column of every word on env 8 (a vertical bar across it meets one), and
    with regions a full 3x3 region across the first word border in the
    band at rows 30..32 on env 9."""
    cells = xwide_cells(cfg, n, rng, fill).reshape(n, cfg.height, cfg.width)
    win = 32 - 32 % cfg.region_size if cfg.region_clear else 32
    cells[7, win :: win, :] = 1
    cells[8] = 0
    cells[8, 32, ::32] = 1
    if cfg.region_clear:
        cells[9, 30:33, 30:33] = 1
    return cells.reshape(n, -1)


def tall_hands(cfg, n, rng):
    """``xwide_hands``, plus the tallest one-column piece (the 5-cell
    vertical bar in classic19, 1x2 in mini5) on env 8."""
    t = rules.tables_for(cfg)
    queue = xwide_hands(cfg, n, rng)
    queue[8, 0] = int(np.argmax(np.where(t.piece_w == 1, t.piece_h, 0)))
    return queue


def with_warps(kernel, warps):
    """``kernel``'s fields with its launch shape at ``warps`` warps a block."""
    return types.SimpleNamespace(**{**vars(kernel), "shape": (kernel.shape[0], warps)})


@pytest.mark.parametrize("case", XTALL)
def test_xtall_wrappers_pick_the_xwide_mask_and_clear(case):
    """On boards of more than 32 rows of 129 to 1024 cells the mask, the
    clear, the apply and the legality take their xwide kernels on their
    launch shapes (4 warps a block, all fitting 48 KB here; the legality's
    the mask's at S = P; the apply's one warp a block)."""
    _, ct = _pair(case)
    shape = xwide_launch_shape(ct)
    assert shape == (32 // -(-ct.width // 32), XWIDE_WARPS)
    assert apply_launch_shape(ct) == (shape[0], XWIDE_APPLY_WARPS)
    mk, ck = MaskKernel(ct, "cpu"), ClearScanKernel(ct, "cpu")
    assert (mk.kind, mk.name, mk.shape) == ("xwide", "mask_xwide", shape)
    assert (ck.kind, ck.name, ck.shape) == ("xwide", "clear_xwide", shape)
    del mk
    ak, lk = ApplyKernel(ct, "cpu"), LegalityKernel(ct, "cpu")
    assert (ak.kind, ak.name, ak.shape) == ("xwide", "apply_xwide", (shape[0], 1))
    every = xwide_launch_shape(dataclasses.replace(ct, queue_size=lk.num_pieces))
    assert (lk.kind, lk.name, lk.shape) == ("xwide", "legality_xwide", every)
    assert every == every_piece_shape(ct) == (shape[0], XWIDE_WARPS)


@pytest.mark.parametrize("case", XTALL)
def test_xtall_mask_matches_jax_mask(case):
    """K1 on boards of more than 32 rows of rows of more than 128 cells:
    the wrapper (plain version on the CPU) against the JAX u8 engine's
    shift mask on the envs whose hand ids lie in [0, P], and the xwide
    kernel's emulation against the wrapper on every env: pieces across word
    borders and row 32, a one-column bar across a row of word borders, a
    full board and an empty one."""
    _, ct = _pair(case)
    rng = np.random.default_rng(25)
    board = tall_cells(ct, N, rng, fill=0.3)
    queue = tall_hands(ct, N, rng)
    t = rules.tables_for(ct)
    dealt = ((queue >= 0) & (queue <= t.num_pieces)).all(axis=1)
    want = np.asarray(jax_engine(case).action_mask(jnp.asarray(board), jnp.asarray(queue)))
    mk = MaskKernel(ct, "cpu")
    got = mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy()
    np.testing.assert_array_equal(got[dealt], want[dealt])
    np.testing.assert_array_equal(emulate_mask_xwide_kernel(ct, board, queue, mk), got)
    h, w, hw = ct.height, ct.width, ct.num_cells
    assert 0 < got.mean() < 1 and not got[[0, N - 1]].any() and not got[[1, 2], :hw].any()
    # the vertical bar over row 32's cells at every word's first column:
    # anchors whose rows reach row 32 in those columns are illegal
    pid = int(queue[8, 0])
    ph = t.piece_h[pid]
    bar = got[8, :hw].reshape(h, w)
    expect = np.zeros((h, w), bool)
    expect[: h - ph + 1] = True
    expect[32 - ph + 1 : 33, ::32] = False
    np.testing.assert_array_equal(bar, expect)
    assert ph > 1 and not bar[32 - ph + 1, 32] and bar[32 - ph, 32] and bar[32 - ph + 1, 33]
    # the empty board: a piece's anchors up to the right and bottom edges
    pid = int(queue[N - 2, 0])
    if pid < t.num_pieces:
        anchors = got[N - 2, :hw].reshape(h, w)
        ph, pw = t.piece_h[pid], t.piece_w[pid]
        assert anchors.sum() == (h - ph + 1) * (w - pw + 1)
    assert mk.xwide_launches == mk.general_launches == 0


@pytest.mark.parametrize("case", ["33x129", "36x135r3"])
@pytest.mark.parametrize("addr", [3, 13])
def test_xtall_mask_emulation_takes_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary (a block's output span
    starts off one too: 129 and 135 cells a row): the xwide mask's
    emulation still equals the plain version."""
    _, ct = _pair(case)
    rng = np.random.default_rng(addr)
    board = tall_cells(ct, N, rng, fill=0.4)
    queue = tall_hands(ct, N, rng)
    mk = MaskKernel(ct, "cpu")
    np.testing.assert_array_equal(
        emulate_mask_xwide_kernel(ct, board, queue, mk, addr),
        mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy())


@pytest.mark.parametrize("case", XTALL)
def test_xtall_clear_matches_jax_clear_kernel(case):
    """K3 on boards of more than 32 rows of rows of more than 128 cells: the
    Pallas clear kernel in interpret mode, the JAX u8 engine's
    ``clear_scan``, the wrapper (plain version on the CPU) and the xwide
    kernel's emulation, bit-equal: full rows in the first and last windows
    and past each window border, full columns either side of a word border
    and at the right edge, a row full but for one cell, 3x3 regions across
    word borders and in the band at the window border, a full board (k = H
    + W + regions) and an empty one."""
    cj, ct = _pair(case)
    board = tall_cells(ct, N, np.random.default_rng(26), fill=0.6)
    want = [np.asarray(x) for x in jk.ClearScanKernel(cj, tile_n=N)(
        jnp.asarray(board), interpret=True)]
    engine = jax_engine(case).clear_scan(jnp.asarray(board))
    ck = ClearScanKernel(ct, "cpu")
    got = ck(torch.as_tensor(board))
    emu = emulate_clear_xwide_kernel(ct, board, ck)
    for i, name in enumerate(("board", "k")):
        np.testing.assert_array_equal(np.asarray(engine[i]), want[i], name)
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    h, w = ct.height, ct.width
    k, cleared = want[1], want[0].reshape(N, h, w)
    rs = ct.region_size
    regions = (h // rs) * (w // rs) if ct.region_clear else 0
    assert k[N - 1] == h + w + regions and not cleared[N - 1].any() and k[N - 2] == 0
    assert k[2] >= 1 and not cleared[2, h - 1].any()
    win = 32 - 32 % rs if ct.region_clear else 32
    assert k[7] >= len(range(win, h, win)) and not cleared[7, win::win].any()
    if ct.region_clear:
        assert k[6] >= 2 and k[9] >= 1 and not cleared[9, 30:33, 30:33].any()
    assert ck.xwide_launches == ck.general_launches == 0


@pytest.mark.parametrize("case", ["33x129", "36x135r3", "66x130"])
@pytest.mark.parametrize("addr", [3, 13])
def test_xtall_clear_emulation_takes_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary: the xwide clear's
    emulation stages an unaligned head and tail byte by byte and still
    equals the plain version."""
    _, ct = _pair(case)
    board = tall_cells(ct, N, np.random.default_rng(addr), fill=0.55)
    ck = ClearScanKernel(ct, "cpu")
    for e, p in zip(emulate_clear_xwide_kernel(ct, board, ck, addr), ck(torch.as_tensor(board))):
        np.testing.assert_array_equal(e, p.numpy())


@pytest.mark.parametrize("warps", [1, 2, 3])
def test_xtall_emulations_at_fewer_warps(warps):
    """Blocks of fewer than ``XWIDE_WARPS`` warps, which the launch shape
    takes where a block of four passes what a block may opt in to (boards
    of several hundred rows, too large for a rule table here): the mask's
    and the clear's emulations at 1 to 3 warps a block on 40x136, with
    hands of one and of three, equal the plain versions."""
    for queue_size in (1, 3):
        ct = tcfg.EnvConfig(**XTALL["40x136"], queue_size=queue_size)
        rng = np.random.default_rng(warps)
        board = tall_cells(ct, N, rng, fill=0.5)
        queue = tall_hands(ct, N, rng)
        mk, ck = MaskKernel(ct, "cpu"), ClearScanKernel(ct, "cpu")
        np.testing.assert_array_equal(
            emulate_mask_xwide_kernel(ct, board, queue, with_warps(mk, warps), addr=5),
            mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy())
        for e, p in zip(emulate_clear_xwide_kernel(ct, board, with_warps(ck, warps), 5),
                        ck(torch.as_tensor(board))):
            np.testing.assert_array_equal(e, p.numpy())


def tall_apply_cases(cfg, n, rng):
    """``apply_cases`` (legal and illegal actions, an invalid anchor, an
    action that completes a row, one over a full row, with regions one that
    completes a 3x3 region across the first word border), plus: on env 9 a
    full row past every window border (rows 32 and 64; 30 and 60 with
    regions), the first but for its first cell, which a 1x1 action there
    completes; on env 10 the tallest one-column piece anchored so that its
    last cell lands on row 32 in column 40, which the board holds (an
    overlap at row 32: illegal); on env 11 the same action over a row 32
    full but for column 40 on an otherwise empty board (legal: it completes
    the row).  (board, cover, valid)."""
    t = rules.tables_for(cfg)
    board, cover, valid = apply_cases(cfg, n, rng)
    grid = board.reshape(n, cfg.height, cfg.width)
    hw, w = cfg.num_cells, cfg.width
    win = 32 - 32 % cfg.region_size if cfg.region_clear else 32
    grid[9, win::win, :] = 1
    grid[9, win, 0] = 0
    cover[9], valid[9] = t.cover[win * w], t.valid[win * w]
    pid = int(np.argmax(np.where(t.piece_w == 1, t.piece_h, 0)))
    g = pid * hw + (33 - t.piece_h[pid]) * w + 40
    grid[10, 32, 40] = 1
    grid[11] = 0
    grid[11, 32, :] = 1
    grid[11, 32, 40] = 0
    for env in (10, 11):
        cover[env], valid[env] = t.cover[g], t.valid[g]
    return board, cover, valid


def assert_tall_apply_cases(cfg, board, want):
    """What ``tall_apply_cases``' envs must give: ``assert_apply_cases``, and
    the full rows past the window borders cleared (env 9), the overlap at
    row 32 a strict no-op (env 10), row 32 completed and cleared with the
    rest of the bar left above it (env 11)."""
    assert_apply_cases(cfg, board, want)
    new_board, k, legal = want
    h, w = cfg.height, cfg.width
    grid = new_board.reshape(len(board), h, w)
    win = 32 - 32 % cfg.region_size if cfg.region_clear else 32
    assert legal[9] and k[9] >= len(range(win, h, win)) and not grid[9, win::win].any()
    assert not legal[10] and k[10] == 0 and (new_board[10] == board[10]).all()
    t = rules.tables_for(cfg)
    ph = int(t.piece_h[t.piece_w == 1].max())                # the bar's cells
    assert legal[11] and k[11] == 1 and grid[11].sum() == ph - 1
    assert grid[11, 33 - ph : 32, 40].all()


@pytest.mark.parametrize("case", XTALL)
def test_xtall_apply_matches_pallas_apply_kernel(case):
    """K2 on boards of more than 32 rows of rows of more than 128 cells: the
    Pallas apply kernel in interpret mode, ``place_and_clear`` over the JAX
    u8 engine's ``clear_scan`` (the JAX u8 step's overlap, place and clear),
    the wrapper (plain version on the CPU) and the xwide apply's emulation,
    bit-equal, on ``tall_apply_cases``: full rows past each window border,
    an overlap at row 32, a piece that completes row 32, an invalid anchor,
    a full row under an illegal action, a region across a word border on
    36x135, a full board and an empty one."""
    cj, ct = _pair(case)
    board, cover, valid = tall_apply_cases(ct, N, np.random.default_rng(28))
    want = [np.asarray(x) for x in jk.ApplyKernel(cj, tile_n=N)(
        jnp.asarray(board), jnp.asarray(cover), jnp.asarray(valid), interpret=True)]
    engine = jax_engine(case)

    def jax_clear(placed):
        return tuple(torch.as_tensor(np.array(x))
                     for x in engine.clear_scan(jnp.asarray(placed.numpy())))

    glue = place_and_clear(torch.as_tensor(board), torch.as_tensor(cover),
                           torch.as_tensor(valid), jax_clear)
    ak = ApplyKernel(ct, "cpu")
    assert (ak.kind, ak.name) == ("xwide", "apply_xwide")
    got = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    emu = emulate_apply_xwide_kernel(ct, board, cover, valid, ak)
    for i, name in enumerate(("board", "k", "legal")):
        np.testing.assert_array_equal(glue[i].numpy(), want[i], name)
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    assert_tall_apply_cases(ct, board, want)
    assert ak.xwide_launches == ak.general_launches == 0


@pytest.mark.parametrize("case", ["33x129", "36x135r3", "66x130"])
@pytest.mark.parametrize("addr", [3, 13])
def test_xtall_apply_emulation_takes_any_address(case, addr):
    """Boards and covers that start off a 16-byte boundary, each at its own
    offset: the xwide apply's emulation loads the boards and ORs the covers
    over them, the unaligned heads and tails byte by byte, stores an
    illegal env's input bytes byte by byte where the board and the output
    do not share their offset, and still equals the plain version."""
    _, ct = _pair(case)
    board, cover, valid = tall_apply_cases(ct, N, np.random.default_rng(addr))
    ak = ApplyKernel(ct, "cpu")
    want = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    for cover_addr in (addr, (addr + 7) % 16):
        emu = emulate_apply_xwide_kernel(ct, board, cover, valid, ak, addr, cover_addr)
        for e, p in zip(emu, want):
            np.testing.assert_array_equal(e, p.numpy())


@pytest.mark.parametrize("warps", [2, 3, 4])
def test_xtall_apply_emulation_at_more_warps(warps):
    """The xwide apply's emulation at 2 to 4 warps a block on 40x136 (its
    launch shape takes one), boards and covers off a 16-byte boundary,
    equals the plain version."""
    _, ct = _pair("40x136")
    board, cover, valid = tall_apply_cases(ct, N, np.random.default_rng(40 + warps))
    ak = ApplyKernel(ct, "cpu")
    want = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    emu = emulate_apply_xwide_kernel(ct, board, cover, valid, with_warps(ak, warps), 5, 11)
    for e, p in zip(emu, want):
        np.testing.assert_array_equal(e, p.numpy())


@pytest.mark.parametrize("case", XTALL)
def test_xtall_legality_matches_jax_legal_all_pieces(case):
    """K4 on boards of more than 32 rows of rows of more than 128 cells: the
    JAX u8 engine's ``legal_all_pieces``, the wrapper (plain version on the
    CPU) and the emulation of the xwide mask's every-piece instance (a hand
    of every piece, env-slot q reading piece q mod P), bit-equal: full rows
    and columns, a full board (no legal anchor) and an empty one (every
    piece's in-bounds anchors)."""
    _, ct = _pair(case)
    board = legality_boards(ct, N, np.random.default_rng(29))
    want = np.asarray(jax_engine(case).legal_all_pieces(jnp.asarray(board)))
    lk = LegalityKernel(ct, "cpu")
    assert (lk.kind, lk.name) == ("xwide", "legality_xwide")
    np.testing.assert_array_equal(lk(torch.as_tensor(board)).numpy(), want)
    np.testing.assert_array_equal(emulate_legality_instance(ct, board, lk), want)
    assert not want[N - 1].any() and 0 < want.mean() < 1
    np.testing.assert_array_equal(want[N - 2].reshape(-1), rules.tables_for(ct).valid)
    assert lk.xwide_launches == lk.general_launches == 0


@pytest.mark.parametrize("case", ["33x129", "36x135r3", "66x130"])
@pytest.mark.parametrize("addr", [3, 13])
def test_xtall_legality_emulation_takes_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary (the block's span of envs
    starts at env first / P, its output span at env-slot first): the xwide
    legality instance's emulation still equals the plain version."""
    _, ct = _pair(case)
    board = legality_boards(ct, N, np.random.default_rng(addr))
    lk = LegalityKernel(ct, "cpu")
    np.testing.assert_array_equal(emulate_legality_instance(ct, board, lk, addr),
                                  lk(torch.as_tensor(board)).numpy())


@pytest.mark.parametrize("warps", [1, 2, 3])
def test_xtall_legality_emulation_at_fewer_warps(warps):
    """The xwide legality instance's emulation at 1 to 3 warps a block on
    40x136, a board off a 16-byte boundary, equals the plain version."""
    _, ct = _pair("40x136")
    board = legality_boards(ct, N, np.random.default_rng(50 + warps))
    lk = LegalityKernel(ct, "cpu")
    np.testing.assert_array_equal(
        emulate_legality_instance(ct, board, with_warps(lk, warps), addr=5),
        lk(torch.as_tensor(board)).numpy())


def test_xtall_launch_shape_takes_fewer_warps_where_four_do_not_fit():
    """600x136 (S = 1): four warps' rows pass 227 KB, three fit; 1000x1024:
    one segment a warp, and one warp's rows fit; 2000x1024: they do not, so
    the general kernels take it."""
    cfg = tcfg.EnvConfig(height=600, width=136)
    assert xwide_launch_shape(cfg) == (6, 3)
    assert 4 * 24 * 600 * 5 > SMEM_OPT_IN >= 4 * 18 * 600 * 5
    assert xwide_launch_shape(tcfg.EnvConfig(height=1000, width=1024)) == (1, 1)
    assert xwide_launch_shape(tcfg.EnvConfig(height=2000, width=1024)) is None
    assert 4 * 2000 * 32 > SMEM_OPT_IN


@pytest.mark.parametrize("name", ["mask_xwide", "clear_xwide", "apply_xwide",
                                  "legality_xwide"])
def test_xwide_kernels_are_bytes_bound_on_40x136(name):
    """The xwide mask and clear at N = 49152 on 40x136 (classic19, S = 1)
    move the general kernels' bytes (10,884 B an env: the board and the
    hand id in, the mask or the cleared board and k out), 0.1597 ms at
    3.35 TB/s, above their operations at the integer rate; the apply the
    general apply's (16,326 B an env: board and cover in, a valid byte;
    board, k and legal out), 0.239539 ms; the legality the general
    legality's (108,800 B an env: the board in, P * HW bools out),
    1.596340 ms."""
    cfg, n = tcfg.EnvConfig(height=40, width=136), 49152
    hw = cfg.num_cells
    board, queue = torch.zeros(n, hw, dtype=torch.uint8), torch.zeros(n, 1, dtype=torch.int32)
    flags, k = torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32)
    per_env, ms, digits = 10884, 0.1597, 4
    if name == "mask_xwide":
        inputs, outputs = (board, queue), (torch.zeros(n, hw, dtype=torch.bool),)
    elif name == "clear_xwide":
        inputs, outputs = (board,), (board, k)
    elif name == "apply_xwide":
        inputs, outputs = (board, board, flags), (board, k, flags)
        per_env, ms, digits = 16326, 0.239539, 6
    else:  # the (N, P, HW) map, 5.3 GB, counted from an expanded view
        p = rules.tables_for(cfg).num_pieces
        inputs = (board,)
        outputs = (torch.zeros(1, p, hw, dtype=torch.bool).expand(n, p, hw),)
        per_env, ms, digits = hw * (1 + p), 1.596340, 6
    nbytes, ops = COSTS[name](cfg, inputs, outputs)
    general, _ = COSTS[name.replace("_xwide", "_general")](cfg, inputs, outputs)
    assert nbytes == general == per_env * n
    b = bound(list(inputs) + list(outputs), ops)
    assert b["bound_by"] == "bytes" and round(b["bound_ms"], digits) == ms


def test_line_tables_take_a_board_of_more_than_12288_cells():
    """100x124 with the five small pieces, a board the JAX package's u8
    engine builds and steps: the port's clear and apply wrappers construct
    (their line tables refused it before, at more than 12288 cells and
    lines), taking the tall kernels there, and the clear equals the JAX
    Pallas clear kernel in interpret mode, full rows, columns and a full
    board among the boards."""
    shape = dict(height=100, width=124, piece_set="mini5")
    cj, ct = jcfg.EnvConfig(**shape), tcfg.EnvConfig(**shape)
    assert ct.num_cells + ct.height + ct.width > 12288
    ck, ak = ClearScanKernel(ct, "cpu"), ApplyKernel(ct, "cpu")
    assert (ck.kind, ak.kind) == ("tall", "tall")
    n = 6
    rng = np.random.default_rng(27)
    board = (rng.random((n, ct.height, ct.width)) < 0.7).astype(np.uint8)
    board[0, 17, :] = 1
    board[1, :, 123] = 1
    board[2, 99, :] = 1
    board[2, :, 0] = 1
    board[n - 1] = 1
    board = board.reshape(n, -1)
    want = [np.asarray(x) for x in jk.ClearScanKernel(cj, tile_n=n)(
        jnp.asarray(board), interpret=True)]
    got = ck(torch.as_tensor(board))
    for i, name in enumerate(("board", "k")):
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
    assert list(want[1][:3]) == [1, 1, 2] and want[1][n - 1] == 100 + 124
    cover = np.zeros_like(board)
    valid = np.ones(n, bool)
    out = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    np.testing.assert_array_equal(out[0].numpy(), want[0])
    np.testing.assert_array_equal(out[1].numpy(), want[1])


def test_general_clear_and_apply_refuse_only_what_one_warp_cannot_stage():
    """The general clear and apply (``bp_clear``, ``bp_apply``) stage an env's
    board and a flag a line, hw + L bytes, in one warp's shared memory: four
    warps a block, opting in above 48 KB, fewer where four do not fit what a
    block may opt in to, and a refusal only where one warp's do not (about
    232,000 cells, whose rule table alone would take 5 HW^2 bytes, 270 GB):
    the boards between 12288 and 232,448 bytes a warp all run."""
    assert general_warps(100, 20) == GENERAL_WARPS == 4
    assert general_warps(48 * 1024 // 4, 1) == 4                  # opted in above 48 KB
    assert general_warps(SMEM_OPT_IN // 4, 1) == 3
    assert general_warps(SMEM_OPT_IN // 2, 0) == 2
    assert general_warps(SMEM_OPT_IN - 500, 500) == 1
    assert general_warps(SMEM_OPT_IN - 500, 501) == 0
    for h, w in ((100, 124), (200, 300), (300, 700), (480, 482)):
        cfg = tcfg.EnvConfig(height=h, width=w, piece_set="mini5")
        assert general_warps(cfg.num_cells, h + w) >= 1
        check_general_fits(cfg, h + w)
    cfg = tcfg.EnvConfig(height=482, width=482, piece_set="mini5")
    assert cfg.num_cells + 964 > SMEM_OPT_IN
    with pytest.raises(ValueError, match="too large"):
        check_general_fits(cfg, 964)
