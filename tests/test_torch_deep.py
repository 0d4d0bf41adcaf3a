"""The kernels of boards taller than 128 rows on the CPU, against the JAX
package.

Above 128 rows the tall kernels' register slots run out, so four kernels
walk a board in windows: the u8 mask's deep kernel (K1, ``mask_deep``:
a warp an env-slot, two slots of 32 rows a lane, the second moved up after
each window), the u8 clear's (K3, ``clear_deep``: a warp an env, windows
of 32 rows, or of 32 - 32 mod rs with regions so that no band crosses a
window; the full columns after the last window), the packed apply's
general kernel (B1, a warp an env, windows as the clear's) and the packed
mask's (B7, a warp an env-slot, two rows a lane as K1's).  Their numpy
emulations (``test_torch_tall.py`` ``emulate_mask_deep_kernel``,
``emulate_clear_deep_kernel``, ``emulate_packed_apply_deep``,
``emulate_packed_mask_deep``), fed the tables and launch shapes the
wrappers hand the kernels, are held bit-equal to the wrappers' plain
versions and to the JAX package: the u8 engine's shift mask for K1, the
Pallas clear kernel in interpret mode and the u8 engine's ``clear_scan``
for K3, the packed engine's ``_cover_words``/``_clear_scan_packed`` block
for B1 and its ``_bitboard_mask_from_words`` for B7.  The boards cover a
window seam inside a piece (rows 31/32, 63/64, 127/128), last windows of
1, 2 and 1 live rows (129, 130, 257 rows), 160 rows of 9 cells, and 3x3
regions on 135 rows (windows of 30 rows); the kernels themselves run only
on the card (``chip_smoke.py``).  Everything is integer or bool and must
be bit-equal.
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
    ApplyKernel, ClearScanKernel, MaskKernel, PackedApplyKernel, PackedMaskKernel,
)
from blockpuzzle_tpu_torch.kernels.packed import (
    MAX_TALL, SMEM_OPT_IN, apply_launch_shape, deep_launch_shape, tall_block_warps,
    tall_smem_bytes,
)
from test_torch_kernels import apply_cases, assert_apply_cases
from test_torch_packed import chosen_actions, jax_apply, np_words
from test_torch_tall import (
    emulate_apply_deep_kernel, emulate_clear_deep_kernel, emulate_legal_general,
    emulate_mask_deep_kernel, emulate_packed_apply_deep, emulate_packed_mask_deep,
    emulate_packed_words_deep, tall_cells,
)

DEEP = {"deep129": dict(height=129, width=8), "deep130": dict(height=130, width=8),
        "deep160x9": dict(height=160, width=9), "deep257": dict(height=257, width=8),
        "deep135r3": dict(height=135, width=9, region_clear=True, region_size=3,
                          queue_size=3)}
# the deep clear also on rows of two words, 3x3 regions whose fields
# straddle them (columns 30..32) in windows of 30 rows
DEEP_WORDS = {"deep132x36r3": dict(height=132, width=36, region_clear=True, region_size=3)}
N = 16


def _pair(case):
    shape = {**DEEP, **DEEP_WORDS}[case]
    return jcfg.EnvConfig(**shape), tcfg.EnvConfig(**shape)


def deep_cells(cfg, n, rng, fill):
    """``tall_cells`` plus full rows on the later window seams (63, 64, 127,
    128) and the last row, a row 128 full but for its first cell, and a 3x3
    region across rows 119..121 (the seam of windows of 30 rows at 120)."""
    h = cfg.height
    cells = tall_cells(cfg, n, rng, fill)
    cells[6::9, 63, :] = 1
    cells[7::9, 64, :] = 1
    cells[8::9, 127:129, :] = 1
    cells[9::11, h - 1, :] = 1
    cells[10::11, 128, 1:] = 1
    cells[10::11, 128, 0] = 0
    cells[11::13, 119:122, 3:6] = 1
    return cells


def _hands(cfg, n, rng):
    """Hands with the empty sentinel, an id below 0 and ids past it."""
    num_pieces = rules.tables_for(cfg).num_pieces
    queue = rng.integers(0, num_pieces + 1, (n, cfg.queue_size)).astype(np.int32)
    queue[0] = num_pieces
    queue[1, 0] = -1
    queue[2, 0] = num_pieces + 3
    queue[3, 0] = 4                                       # a 1x5 bar: 5 rows
    return queue


@functools.cache
def jax_mask_engine(case):
    return jax_make_env(_pair(case)[0], state_impl="u8", mask_impl="shift")


@functools.cache
def jax_packed_engine(case):
    return jax_make_env(_pair(case)[0], state_impl="packed")


@pytest.mark.parametrize("case", DEEP)
def test_deep_mask_matches_jax_mask(case):
    """K1 on boards of more than 128 rows: the wrapper (plain version on the
    CPU) against the JAX u8 engine's shift mask on the envs whose hand ids
    lie in [0, P], and the deep kernel's emulation against the wrapper on
    every env (ids outside [0, P) read as empty slots)."""
    _, ct = _pair(case)
    rng = np.random.default_rng(5)
    board = deep_cells(ct, N, rng, fill=0.3).reshape(N, -1)
    board[N - 1], board[N - 2] = 1, 0
    queue = _hands(ct, N, rng)
    num_pieces = rules.tables_for(ct).num_pieces
    dealt = ((queue >= 0) & (queue <= num_pieces)).all(axis=1)
    want = np.asarray(jax_mask_engine(case).action_mask(
        jnp.asarray(board), jnp.asarray(queue)))
    mk = MaskKernel(ct, "cpu")
    assert (mk.kind, mk.name, mk.shape) == ("deep", "mask_deep", deep_launch_shape(ct))
    got = mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy()
    np.testing.assert_array_equal(got[dealt], want[dealt])
    np.testing.assert_array_equal(emulate_mask_deep_kernel(ct, board, queue, mk), got)
    assert 0 < got.mean() < 1 and not got[[0, N - 1]].any() and not got[2, : ct.num_cells].any()
    # on the empty board the last legal anchor row is H - h, in the last window
    t = rules.tables_for(ct)
    queue[N - 2, 0] = 4                                   # a 1x5 bar: 5 rows
    empty = mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy()[N - 2]
    anchors = empty[: ct.num_cells].reshape(ct.height, ct.width)
    last = ct.height - t.piece_h[4]
    assert anchors[: last + 1, 0].all() and not anchors[last + 1 :].any()
    np.testing.assert_array_equal(
        emulate_mask_deep_kernel(ct, board, queue, mk)[N - 2], empty)
    assert mk.deep_launches == mk.general_launches == 0


@pytest.mark.parametrize("case", ["deep130", "deep135r3"])
@pytest.mark.parametrize("addr", [3, 13])
def test_deep_mask_emulation_takes_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary: the deep mask's emulation
    stages an unaligned head and tail byte by byte (the block's output span
    may also start off a boundary: 135x9 has H*W = 1215) and still equals
    the plain version."""
    _, ct = _pair(case)
    rng = np.random.default_rng(addr)
    board = deep_cells(ct, N, rng, fill=0.4).reshape(N, -1)
    queue = _hands(ct, N, rng)
    mk = MaskKernel(ct, "cpu")
    np.testing.assert_array_equal(
        emulate_mask_deep_kernel(ct, board, queue, mk, addr),
        mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy())


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "reread"])
@pytest.mark.parametrize("case", DEEP)
def test_deep_packed_apply_matches_jax_packed_step(case, staged):
    """B1 on boards of more than 128 rows: JAX's packed apply block (cover
    words, overlap, place, clear), the wrapper (plain version) and the
    general kernel's emulation with its placed rows kept in shared memory
    and read again from the input, on legal, illegal and out-of-bounds
    actions, actions that complete a row at a window seam or the last row,
    and 3x3 regions across a window seam."""
    _, ct = _pair(case)
    rng = np.random.default_rng(6)
    cells = deep_cells(ct, N, rng, fill=0.35)
    h = ct.height
    cells[12, 128, :] = 1                                  # row 128 full but
    cells[12, 128, 0] = 0                                  # its first cell
    cells[13, h - 1, 1:] = 1                               # the last row likewise
    cells[13, h - 1, 0] = 0
    words = np_words(cells)
    attrs, r, c, valid = chosen_actions(ct, N, rng)
    for env, row in ((12, 128), (13, h - 1)):              # a 1x1 that completes it
        attrs[env], r[env], c[env], valid[env] = attrs[2], row, 0, True
    want = [np.asarray(x) for x in jax_apply(jax_packed_engine(case), words, attrs, r, c,
                                             valid)[:3]]
    want[0] = want[0].astype(np.int64)
    ak = PackedApplyKernel(ct, "cpu")
    assert (ak.kind, ak.name) == ("general", "packed_apply_general")
    got = ak(torch.as_tensor(words.astype(np.int64)),
             *(torch.as_tensor(x) for x in (attrs, r, c, valid)))
    emu = emulate_packed_apply_deep(ct, words, attrs, r, c, valid, staged)
    for g, e, w, name in zip(got, emu, want, ("words", "k", "legal")):
        np.testing.assert_array_equal(g.numpy(), w, name)
        np.testing.assert_array_equal(e, w, name)
    legal, k = want[2], want[1]
    assert legal[[12, 13]].all() and (k[[12, 13]] >= 1).all()
    assert (want[0][12, 128] == 0) and (want[0][13, h - 1] == 0)
    assert legal.any() and (~legal).any()
    np.testing.assert_array_equal(want[0][~legal], words[~legal])
    assert ak.general_launches == 0


def test_deep_launch_shapes_fit():
    """The deep mask's launch shape on boards of 129 to 4096 rows of 1 to
    128 cells: the tall kernels' choice (16 warps and 4, 2 or 1 turns in 48
    KB, else one turn and ``tall_block_warps``), down to 1 to 3 warps where 4
    do not fit what a block may opt in to, and None (the general kernel)
    where one warp does not; a block's output bytes under the 2^21 that
    ``small_div``'s proof needs."""
    seen = set()
    for h in (129, 130, 135, 160, 257, 512, 1000, 1500, 3000, 4096):
        for w in (1, 8, 9, 31, 32, 33, 64, 100, 128):
            cfg = tcfg.EnvConfig(height=h, width=w)
            shape = deep_launch_shape(cfg)
            if shape is None:
                assert tall_smem_bytes(cfg, 1) > SMEM_OPT_IN
                seen.add("none")
                continue
            per_warp, warps = shape
            smem = tall_smem_bytes(cfg, per_warp * warps)
            assert smem <= SMEM_OPT_IN and per_warp * warps * cfg.num_cells < 1 << 21
            if tall_smem_bytes(cfg, 16) <= 48 * 1024:     # no opt-in needed
                assert warps == 16 and smem <= 48 * 1024
                assert per_warp == 4 or tall_smem_bytes(cfg, 32 * per_warp) > 48 * 1024
                seen.add("16")
            elif warps >= 4:
                assert per_warp == 1 and warps == tall_block_warps(cfg)
                seen.add("4+")
            else:
                assert per_warp == 1 and tall_smem_bytes(cfg, warps + 1) > SMEM_OPT_IN
                seen.add("<4")
    assert seen == {"16", "4+", "<4", "none"}
    assert deep_launch_shape(tcfg.EnvConfig(height=MAX_TALL, width=9)) is None
    assert deep_launch_shape(tcfg.EnvConfig(height=130, width=129)) is None


def _clear_boards(cfg, n, rng, fill):
    """``deep_cells`` with a full board (the last) and an empty one, a
    column full in every row (env 12: only the AND across the windows finds
    it) and one full but for the last row (env 13, whose column 0 is empty,
    so that no row or region of it is full), and 3x3 blocks of rows
    117..122 (env 12), two aligned regions on either side of the seam of
    windows of 30 rows at 120."""
    cells = deep_cells(cfg, n, rng, fill)
    cells[12, :, 1] = 1
    cells[12, 117:123, 3:6] = 1
    cells[13, :, 2] = 1
    cells[13, cfg.height - 1, 2] = 0
    cells[13, :, 0] = 0
    if cfg.width > 32:
        cells[12, 120:123, 30:33] = 1                   # a field across two words
    board = cells.reshape(n, -1)
    board[n - 1], board[n - 2] = 1, 0
    return board


@pytest.mark.parametrize("case", [*DEEP, *DEEP_WORDS])
def test_deep_clear_matches_jax_clear_kernel(case):
    """K3 on boards of more than 128 rows: the Pallas clear kernel in
    interpret mode, the JAX u8 engine's ``clear_scan``, the wrapper (plain
    version on the CPU) and the deep kernel's emulation, bit-equal: full
    rows on the window seams, columns full across every window or all but
    the last row, 3x3 regions on either side of a seam of windows of 30
    rows (on 132x36 also fields across the two words of a row), a full
    board (k = H + W + regions) and an empty one."""
    cj, ct = _pair(case)
    board = _clear_boards(ct, N, np.random.default_rng(7), fill=0.6)
    want = [np.asarray(x) for x in jk.ClearScanKernel(cj, tile_n=N)(
        jnp.asarray(board), interpret=True)]
    engine = jax_make_env(cj, state_impl="u8").clear_scan(jnp.asarray(board))
    ck = ClearScanKernel(ct, "cpu")
    assert (ck.kind, ck.name, ck.shape) == ("deep", "clear_deep", deep_launch_shape(ct))
    got = ck(torch.as_tensor(board))
    emu = emulate_clear_deep_kernel(ct, board, ck)
    for i, name in enumerate(("board", "k")):
        np.testing.assert_array_equal(np.asarray(engine[i]), want[i], name)
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    h, w = ct.height, ct.width
    k, cleared = want[1], want[0].reshape(N, h, w)
    regions = (h // ct.region_size) * (w // ct.region_size) if ct.region_clear else 0
    assert k[N - 1] == h + w + regions and not cleared[N - 1].any()
    assert k[N - 2] == 0 and not board[N - 2].any()
    for env, row in ((1, 31), (2, 32), (6, 63), (7, 64), (8, 127), (8, 128)):
        assert not cleared[env, row].any() and k[env] >= 1, (env, row)
    assert not cleared[12, :, 1].any()                       # the column across windows
    assert cleared[13, : h - 1, 2].all()                     # not full: kept
    if ct.region_clear:
        assert not cleared[12, 117:123, 3:6].any() and k[12] >= 3
    if ct.width > 32:
        assert not cleared[12, 120:123, 30:33].any() and k[12] >= 4
    assert ck.deep_launches == ck.general_launches == 0


@pytest.mark.parametrize("case", ["deep130", "deep135r3"])
@pytest.mark.parametrize("addr", [3, 13])
def test_deep_clear_emulation_takes_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary: the deep clear's emulation
    stages an unaligned head and tail byte by byte (on 135x9 a block's
    output span also starts off a boundary, H*W = 1215) and still equals
    the plain version."""
    _, ct = _pair(case)
    board = _clear_boards(ct, N, np.random.default_rng(addr), fill=0.55)
    ck = ClearScanKernel(ct, "cpu")
    for e, p in zip(emulate_clear_deep_kernel(ct, board, ck, addr),
                    ck(torch.as_tensor(board))):
        np.testing.assert_array_equal(e, p.numpy())


def _packed_mask_inputs(ct, rng):
    """Packed boards (``deep_cells`` with a full board, the last, and an
    empty one holding a 1x5 bar) and ``_hands``."""
    cells = deep_cells(ct, N, rng, fill=0.3)
    cells[N - 1], cells[N - 2] = 1, 0
    queue = _hands(ct, N, rng)
    queue[N - 2, 0] = 4                                   # a 1x5 bar: 5 rows
    return np_words(cells), queue


@pytest.mark.parametrize("case", DEEP)
def test_deep_packed_mask_matches_jax(case):
    """B7 on boards of more than 128 rows: JAX's ``_bitboard_mask_from_words``
    on the envs whose hand ids lie in [0, P], the wrapper (plain version)
    and the windowed kernel's emulation on every env (ids outside [0, P)
    read as empty slots), also against the thread-an-anchor-row kernel's
    (``legal_row_general``) it replaces: a 1x5 bar whose anchor rows 28..31
    reach across the first window seam, on an empty board down to its last
    legal row H - 5, and a full board."""
    _, ct = _pair(case)
    words, queue = _packed_mask_inputs(ct, np.random.default_rng(8))
    num_pieces = rules.tables_for(ct).num_pieces
    dealt = ((queue >= 0) & (queue <= num_pieces)).all(axis=1)
    want = np.asarray(jax_packed_engine(case)._bitboard_mask_from_words(
        jnp.asarray(words), jnp.asarray(np.clip(queue, 0, num_pieces))))
    mk = PackedMaskKernel(ct, "cpu")
    assert (mk.kind, mk.name, mk.shape) == ("general", "packed_mask_general", None)
    got = mk(torch.as_tensor(words.astype(np.int64)), torch.as_tensor(queue)).numpy()
    np.testing.assert_array_equal(got[dealt], want[dealt])
    np.testing.assert_array_equal(emulate_packed_mask_deep(ct, words, queue, mk), got)
    rows = emulate_legal_general(ct, words, queue, mk)
    cells = (rows[..., None] >> np.arange(ct.width)) & 1
    np.testing.assert_array_equal(cells.reshape(N, -1).astype(bool), got)
    assert 0 < got.mean() < 1 and not got[[0, N - 1]].any() and not got[2, : ct.num_cells].any()
    bar = got[N - 2, : ct.num_cells].reshape(ct.height, ct.width)
    last = ct.height - rules.tables_for(ct).piece_h[4]
    assert bar[: last + 1, 0].all() and not bar[last + 1 :].any()
    assert mk.general_launches == mk.words_general_launches == 0


@pytest.mark.parametrize("case", ["deep130", "deep135r3"])
@pytest.mark.parametrize("addr", [3, 13])
def test_deep_packed_mask_emulation_takes_any_output_address(case, addr):
    """An output ``addr`` bytes past a 16-byte boundary: the windowed
    kernel stores from the boundary below it with every window's head and
    tail byte by byte, and still equals the plain version."""
    _, ct = _pair(case)
    words, queue = _packed_mask_inputs(ct, np.random.default_rng(addr))
    mk = PackedMaskKernel(ct, "cpu")
    np.testing.assert_array_equal(
        emulate_packed_mask_deep(ct, words, queue, mk, addr),
        mk(torch.as_tensor(words.astype(np.int64)), torch.as_tensor(queue)).numpy())


def test_deep_clear_launch_shapes_fit():
    """The deep clear takes the deep mask's launch shape: on boards of 129
    to 4096 rows of 1 to 128 cells its block's shared memory (its envs'
    cleared rows of ceil(W / 32) words, then their staged boards, as
    ``csrc/clear.cu`` ``launch_clear_deep`` lays them out) is at most the
    mask's, so it fits what a block may opt in to, and its output bytes stay
    under the 2^21 that ``small_div``'s proof needs; the shape is None
    only on boards of more than 12288 cells and lines (there the general
    clear runs, up to what one warp can stage)."""
    seen = 0
    for h in (129, 130, 135, 160, 257, 512, 1000, 1500, 3000, 4096):
        for w in (1, 8, 9, 31, 32, 33, 64, 100, 128):
            cfg = tcfg.EnvConfig(height=h, width=w)
            shape = deep_launch_shape(cfg)
            lines = h + w
            if shape is None:
                assert cfg.num_cells + lines > 12288
                continue
            per_block = shape[0] * shape[1]
            clear = (4 * per_block * h * -(-w // 32) + 15) // 16 * 16 + per_block * h * w + 32
            assert clear <= tall_smem_bytes(cfg, per_block) <= SMEM_OPT_IN
            assert per_block * cfg.num_cells < 1 << 21
            seen += 1
    assert seen > 40


def _deep_apply_cases(cfg, n, rng):
    """``apply_cases`` plus 1x1 actions across the windows: one that
    completes row 128 (env 9) and one the last row (env 10), one over a full
    row 64 (env 11: illegal, a strict no-op), one that completes column 1,
    full in every other row, so that only the AND across the windows finds
    it (env 12), and, with regions, one that completes the band of rows
    120..122 beside the full band 117..119 (env 13: both sides of the seam
    of windows of 30 rows at 120), else one that completes row 32."""
    t = rules.tables_for(cfg)
    board, cover, valid = apply_cases(cfg, n, rng)
    grid = board.reshape(n, cfg.height, cfg.width)
    h = cfg.height

    def one(env, r, c):
        cover[env], valid[env] = t.cover[r * cfg.width + c], t.valid[r * cfg.width + c]

    for env, row in ((9, 128), (10, h - 1)):
        grid[env, row, 1:], grid[env, row, 0] = 1, 0
        one(env, row, 0)
    grid[11, 64, :] = 1
    one(11, 64, 0)
    grid[12, :, 1] = 1
    grid[12, h - 1, 1] = 0
    one(12, h - 1, 1)
    if cfg.region_clear:
        grid[13, 117:123, 3:6] = 1
        grid[13, 120, 3] = 0
        one(13, 120, 3)
    else:
        grid[13, 32, 1:], grid[13, 32, 0] = 1, 0
        one(13, 32, 0)
    return board, cover, valid


@pytest.mark.parametrize("case", ["deep129", "deep130", "deep135r3"])
def test_deep_apply_matches_pallas_apply_kernel(case):
    """K2 on boards of more than 128 rows: the Pallas apply kernel in
    interpret mode, the wrapper (plain version on the CPU) and the deep
    kernel's apply instance's emulation, bit-equal: legal and illegal
    actions, an invalid anchor, actions that complete a row in the last
    window (1 or 2 live lanes of 32 on 129 and 130 rows) and at a seam, a
    column only the AND across the windows finds, with regions bands on
    both sides of a window seam, actions over a full row (strict no-ops), a
    full board and an empty one."""
    cj, ct = _pair(case)
    board, cover, valid = _deep_apply_cases(ct, N, np.random.default_rng(10))
    want = [np.asarray(x) for x in jk.ApplyKernel(cj, tile_n=N)(
        jnp.asarray(board), jnp.asarray(cover), jnp.asarray(valid), interpret=True)]
    ak = ApplyKernel(ct, "cpu")
    assert (ak.kind, ak.name, ak.shape) == ("deep", "apply_deep", apply_launch_shape(ct))
    got = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    emu = emulate_apply_deep_kernel(ct, board, cover, valid, ak)
    for i, name in enumerate(("board", "k", "legal")):
        np.testing.assert_array_equal(got[i].numpy(), want[i], name)
        np.testing.assert_array_equal(emu[i], want[i], name)
    assert_apply_cases(ct, board, want)
    new_board, k, legal = want
    h, grid = ct.height, new_board.reshape(N, ct.height, ct.width)
    for env, row in ((9, 128), (10, h - 1)):
        assert legal[env] and k[env] >= 1 and not grid[env, row].any(), env
    assert not legal[11] and k[11] == 0 and grid[11, 64].all()
    assert legal[12] and k[12] >= 1 and not grid[12, :, 1].any()
    if ct.region_clear:
        assert legal[13] and k[13] >= 2 and not grid[13, 117:123, 3:6].any()
    else:
        assert legal[13] and k[13] >= 1 and not grid[13, 32].any()
    assert ak.deep_launches == ak.general_launches == 0


@pytest.mark.parametrize("case", ["deep130", "deep135r3"])
@pytest.mark.parametrize("addr", [3, 13])
def test_deep_apply_emulation_takes_any_address(case, addr):
    """Boards and covers off a 16-byte boundary, each at its own offset: the
    deep apply's emulation stages both spans' unaligned heads and tails
    byte by byte (on 135x9 a block's output span also starts off a
    boundary) and still equals the plain version."""
    _, ct = _pair(case)
    board, cover, valid = _deep_apply_cases(ct, N, np.random.default_rng(addr))
    ak = ApplyKernel(ct, "cpu")
    want = ak(torch.as_tensor(board), torch.as_tensor(cover), torch.as_tensor(valid))
    for cover_addr in (addr, (addr + 7) % 16):
        emu = emulate_apply_deep_kernel(ct, board, cover, valid, ak, addr, cover_addr)
        for e, p in zip(emu, want):
            np.testing.assert_array_equal(e, p.numpy())


@pytest.mark.parametrize("case", ["deep130", "deep135r3", "deep257"])
@pytest.mark.parametrize("addr", [0, 5])
def test_deep_packed_words_match_jax_legal_words(case, addr):
    """B7w on boards of more than 128 rows: JAX's ``legal_words`` on the
    envs whose hand ids lie in [0, P], the wrapper's words entry (plain
    version) and the windowed kernel's words instance's emulation on every
    env, its output ``addr`` int64 words into a larger buffer, also
    against the thread-an-anchor-row kernel (``legal_row_general``) it
    replaces: a 1x5 bar on an empty board down to its last legal row H - 5,
    a full board, ids outside [0, P) as empty slots."""
    _, ct = _pair(case)
    words, queue = _packed_mask_inputs(ct, np.random.default_rng(11 + addr))
    num_pieces = rules.tables_for(ct).num_pieces
    dealt = ((queue >= 0) & (queue <= num_pieces)).all(axis=1)
    want = np.asarray(jwords.legal_words(
        jax_packed_engine(case), jnp.asarray(words),
        jnp.asarray(np.clip(queue, 0, num_pieces)))).astype(np.int64)
    mk = PackedMaskKernel(ct, "cpu")
    assert (mk.kind, mk.words_name) == ("general", "packed_legal_words_general")
    got = mk.words(torch.as_tensor(words.astype(np.int64)), torch.as_tensor(queue)).numpy()
    np.testing.assert_array_equal(got[dealt], want[dealt])
    np.testing.assert_array_equal(emulate_packed_words_deep(ct, words, queue, mk, addr), got)
    np.testing.assert_array_equal(emulate_legal_general(ct, words, queue, mk).reshape(N, -1),
                                  got)
    h = ct.height
    bar = got[N - 2, :h]
    last = h - rules.tables_for(ct).piece_h[4]
    assert (bar[: last + 1] & 1).all() and not bar[last + 1 :].any()
    assert not got[[0, N - 1]].any() and 0 < (got != 0).mean() < 1
    assert mk.words_general_launches == 0
