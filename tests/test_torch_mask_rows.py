"""The u8 mask and all-pieces legality on rows of 1025 to 4096 cells, on
the CPU, against the JAX package.

Past 1024 cells a row (NW = ceil(W / 32) > 32 words) the xwide mask (K1,
``mask_xwide_long``) and its every-piece instance, the legality (K4,
``legality_xwide_long``), hold one env-slot a warp: lane l holds words
l + 32 j of every row in slot j < NJ = ceil(NW / 32) (``csrc/mask.cu``
``mask_xwide_kernel``'s NJ instances), so every lane works and only the
last slot is ragged (a slot past NW holds no word: it reads 0 and stores
nothing). The vertical OR of each rectangle is lane-local a slot at a
time; the smear and the dc shift of word w take word w + 1 from the next
lane's slot j, but lane 31 from lane 0's slot j + 1 (one shuffle a slot
round the warp); the top word's next is 0 and its anchors stop at
W - w + 1, wherever word NW - 1 lies. Numpy emulations of the NJ form
(every lane of a block at once, as (warps, 32, NJ) arrays), fed the tables
and launch shapes the wrappers hand the kernels and boards staged at byte
offsets 0, 3 and 13, are held bit-equal to JAX's u8 shift mask and, where
their operands fit (HW <= 4096), to the wrappers' plain versions, the
JAX u8 engine's ``legal_all_pieces`` and the Pallas K1 and K4 in interpret
mode, on 2x1056 (the smoke's ``w1056`` board), 3x1030 with a hand of three
(33 words, a 6-bit top word; a block's span of envs starts mid-env),
2x2048 (NJ = 2 exactly, no ragged slot), 9x1035 with 3x3 regions and a
hand of three and 33x1025 (more than 32 rows). On the last two the full
rule tables would take 5 HW^2 bytes in each package (5.7 GB on 33x1025)
and the plain version's footprint table four times that, so both packages
get tables of the pieces and anchors alone (``_piece_tables_only``), and
JAX's shift mask runs on an engine holding only the tables it reads
(``jax_shift_mask``). A copy of the emulation in which lane 31 takes its
own slot's next word must fail. Rows of more than 4096 cells keep the
general mask and legality. The kernels themselves run only on the card
(``chip_smoke.py``). Everything is bool and must be bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blockpuzzle_tpu.rules as jrules
from blockpuzzle_tpu import config as jcfg
from blockpuzzle_tpu import kernels as jk
from blockpuzzle_tpu.env import make_env as jax_make_env
from blockpuzzle_tpu_torch import config as tcfg
from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.kernels import LegalityKernel, MaskKernel, _build
from blockpuzzle_tpu_torch.kernels.collision import (
    every_piece_shape, piece_rows_table, piece_table,
)
from blockpuzzle_tpu_torch.kernels.packed import (
    MAX_XWIDE, SMEM_OPT_IN, U32, XWIDE_SEGMENT, XWIDE_WARPS, clear_launch_shape,
    u8_launch_shape, xwide_long_launch_shape, xwide_smem_bytes, xwide_staged_envs,
)
from blockpuzzle_tpu_torch.utils.bounds import COSTS, bound
from test_torch_kernels import _shr_words, emulate_smear_words
from test_torch_packed import _shfl, _small_div
from test_torch_tall import emulate_store_tall
from test_torch_xwide import bar_piece, emulate_stage_words, xwide_cells, xwide_hands
from test_torch_xwide_rows import _line_tables_only

LONG = {"2x1056": dict(height=2, width=1056, piece_set="mini5"),
        "3x1030": dict(height=3, width=1030, queue_size=3, piece_set="mini5"),
        "2x2048": dict(height=2, width=2048, piece_set="mini5"),
        "9x1035r3": dict(height=9, width=1035, region_clear=True, region_size=3,
                         queue_size=3, piece_set="mini5"),
        "33x1025": dict(height=33, width=1025, piece_set="mini5")}
# the boards whose full rule tables, plain footprint table and Pallas
# operands fit a test (5 HW^2 bytes of tables, 20 HW^2 of the plain table)
SMALL = 4096
# four env-slots a block: four blocks or more, the last ragged
N = 14


def _piece_tables_only(package, cfg):
    """``package``'s rule tables for ``cfg`` with the pieces and anchors
    alone: ``_line_tables_only``'s (the piece set's pieces, the line
    masks), the in-bounds anchors (``valid``) and, in place of the
    (P HW, HW) footprint table, a view of one zero byte of that shape (the
    mask kernels read the pieces; nothing here reads the footprints)."""
    t = _line_tables_only(package, cfg)
    h, w, hw = cfg.height, cfg.width, cfg.num_cells
    cell = np.arange(hw)
    valid = ((cell // w <= h - t.piece_h[:, None]) & (cell % w <= w - t.piece_w[:, None]))
    return dataclasses.replace(
        t, cover=np.broadcast_to(np.zeros((1, 1), np.uint8), (t.num_pieces * hw, hw)),
        valid=valid.reshape(-1))


@pytest.fixture
def tables():
    """Both packages' rule tables for a case: the full ones where HW <=
    ``SMALL``, else ``_piece_tables_only`` (held to ``build_tables`` on a
    smaller board); every table a test built is dropped from both caches
    when it ends."""
    caches = (rules._TABLE_CACHE, jrules._TABLE_CACHE)
    before = [set(c) for c in caches]

    def load(case):
        cj, ct = jcfg.EnvConfig(**LONG[case]), tcfg.EnvConfig(**LONG[case])
        if ct.num_cells > SMALL:
            small = dataclasses.replace(ct, height=9, width=39)
            full, stand_in = rules.build_tables(small), _piece_tables_only(rules, small)
            for f in ("pieces", "piece_h", "piece_w", "piece_cells", "piece_rects", "valid"):
                np.testing.assert_array_equal(getattr(stand_in, f), getattr(full, f), f)
            assert stand_in.cover.shape == full.cover.shape
            p = full.num_pieces
            for package, cache, cfg in ((jrules, jrules._TABLE_CACHE, cj),
                                        (rules, rules._TABLE_CACHE, ct)):
                for s in {1, cfg.queue_size, p}:  # the hand's, JAX's stand-in's, S = P
                    c = dataclasses.replace(cfg, queue_size=s)
                    cache[c] = _piece_tables_only(package, c)
        return cj, ct

    yield load
    for cache, old in zip(caches, before):
        for cfg in set(cache) - old:
            del cache[cfg]


def jax_shift_mask(cj, board, queue):
    """JAX's u8 shift mask (``core.py`` ``VecBlockPuzzle._action_mask_shift``)
    on an engine that holds only the tables it reads, set as the engine's
    constructor sets them: the piece kernels and the taps some piece
    occupies.  ``cj``'s ``queue_size`` slots; held to the whole engine's
    ``action_mask`` on the boards whose tables fit."""
    from blockpuzzle_tpu.env.core import VecBlockPuzzle

    t = jrules.tables_for(dataclasses.replace(cj, queue_size=1))
    env = object.__new__(VecBlockPuzzle)
    env.cfg, env.tables, env.num_pieces = cj, t, t.num_pieces
    env._piece_iota = np.arange(t.num_pieces, dtype=np.int32)
    env._piece_kernel_bf16 = np.asarray(t.pieces.reshape(t.num_pieces, -1), dtype=jnp.bfloat16)
    env._kernel_taps = [(dr, dc) for dr in range(t.max_h) for dc in range(t.max_w)
                        if t.pieces[:, dr, dc].any()]
    return np.asarray(env._action_mask_shift(jnp.asarray(board), jnp.asarray(queue)))


def long_cells(cfg, n, rng, fill):
    """``xwide_cells`` (full first and last rows, full columns either side
    of the first word border and at the right edge, the first column of
    every word but the first on env 5, 3x3 regions across word borders, a
    full board and an empty one), plus one set column either side of the
    lane-31 border: 1024, the first cell of lane 0's second slot (env 7),
    and 1023, the last of lane 31's first (env 8); a set cell at the last
    column of the row's last word but one and at column W - 1 (env 9)."""
    h, w = cfg.height, cfg.width
    cells = xwide_cells(cfg, n, rng, fill).reshape(n, h, w)
    cells[7:10] = 0
    cells[7][:, 1024] = 1
    cells[8][:, 1023] = 1
    cells[9][:, [32 * (-(-w // 32) - 1) - 1, w - 1]] = 1
    return cells.reshape(n, -1)


def long_hands(cfg, n, rng):
    """``xwide_hands`` (the empty sentinel on env 0, ids below 0 and past it
    on envs 1 and 2, the widest bar on env 5's board of word borders), and
    the bar in the first slot of envs 7 to 9 (their columns at the
    lane-31 border and the top words)."""
    queue = xwide_hands(cfg, n, rng)
    queue[7:10, 0] = bar_piece(rules.tables_for(cfg))
    return queue


def dealt(cfg, queue):
    """The envs whose hand ids all lie in [0, P] (JAX's shift mask reads an
    id outside as an empty slot only there)."""
    p = rules.tables_for(cfg).num_pieces
    return ((queue >= 0) & (queue <= p)).all(axis=1)


def emulate_mask_xwide_long_kernel(cfg, board, queue, mk, addr=0, own_slot=False):
    """csrc/mask.cu mask_xwide_kernel at NJ > 1 on ``mk``'s piece table and
    launch shape (one env-slot a warp): the block loads the boards its
    env-slots read as row words (``stage_words``); lane l holds words
    l + 32 j in slot j (a slot past NW none: it reads 0 and stores
    nothing) and walks the anchor rows, reading rows r .. r + max_h - 1 of
    each slot from shared memory on every trip (no ring); it ORs each
    rectangle's rows, takes word w + 1 of each slot's word w by a shuffle
    from lane l + 1 mod 32 (lane 31 its slot j + 1's, 0 past the last; 0
    for the top word NW - 1) and smears and shifts the pair
    (``smear_words<2>``, ``shr_words<2>``); the legal words are staged,
    over the board words in place where S = 1 (a word is never read once
    it is written), and stored from the block's byte offset
    (``store_words_n``, as ``store_tall``).  ``own_slot``: the mutation in
    which lane 31 takes its own slot's next word (lane 0's slot j).
    Returns (N, S*HW) bool."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    hw, n, nw = cfg.num_cells, len(board), -(-w // 32)
    nj = -(-nw // 32)
    assert nj > 1 and mk.shape[0] == 1 and mk.max_h <= 8 and mk.max_w <= 8
    pieces = mk.piece_table.numpy().astype(np.int64) & U32
    warps = per_block = mk.shape[1]
    l = np.arange(32)
    lane = np.broadcast_to(l, (warps, 32))
    seg = np.broadcast_to(np.arange(warps)[:, None], (warps, 32))
    wd = lane[..., None] + 32 * np.arange(nj)                 # (warps, 32, NJ): the words
    has = wd < nw
    assert has[..., : nj - 1].all()                           # only the last slot ragged
    last = wd + 1 == nw
    zero = np.zeros((warps, 32, 1), np.int64)
    total = n * s
    out = np.full(total * hw, 2, np.uint8)                    # 2: never written

    def next_words(v):
        """Word w + 1 of each slot's word w: lane l + 1's slot j, lane 31
        lane 0's slot j + 1 (its own slot j's with ``own_slot``)."""
        rot = np.stack([_shfl(v[..., j], (l + 1) % 32) for j in range(nj)], axis=-1)
        lane31 = rot if own_slot else np.concatenate([rot[..., 1:], zero], axis=2)
        return np.where((lane < 31)[..., None], rot, lane31)

    for first in range(0, total, per_block):
        count = min(per_block, total - first)
        env0 = first // s
        envs = (first + count - 1) // s + 1 - env0
        words = emulate_stage_words(board.reshape(-1), env0 * hw, (env0 + envs) * hw, addr,
                                    w, nw).reshape(-1)
        active = seg < count
        pid = np.where(active, queue.reshape(-1)[first + np.where(active, seg, 0)], -1)
        held = (pid >= 0) & (pid < mk.num_pieces)
        pc = np.where(held[..., None], pieces[np.where(held, pid, 0)],
                      np.array([h + 1, w + 1, 0, 0]))        # (warps, 32, 4)
        env = np.where(active, _small_div(first - env0 * s + np.where(active, seg, 0), s), 0)
        written = np.zeros(words.shape, bool)                 # legal words over board words
        mine = active[..., None] & has

        def row(i):
            """Row i of each slot's word, from the shared words as they stand."""
            at = (env[..., None] * h + i) * nw + wd
            assert not written[at[mine]].any()                # read before it is written
            return np.where(has, words[np.where(has, at, 0)], 0)

        r1, r2 = pc[..., 2:3], pc[..., 3:4]                   # (warps, 32, 1)
        a = w - pc[..., 1:2] + 1 - 32 * wd
        span = np.where(a >= 32, U32, np.where(a > 0, (1 << np.clip(a, 0, 31)) - 1, 0))
        in_place = s == 1
        staged = words if in_place else np.full(per_block * h * nw, -1, np.int64)
        for r in range(h):
            v1, v2 = np.zeros_like(wd), np.zeros_like(wd)
            for i in range(mk.max_h):
                y = row(r + i) if r + i < h else np.zeros_like(wd)
                v1 |= np.where((i >= r1 & 0xFF) & (i - (r1 & 0xFF) < (r1 >> 16) & 0xFF), y, 0)
                v2 |= np.where((i >= r2 & 0xFF) & (i - (r2 & 0xFF) < (r2 >> 16) & 0xFF), y, 0)
            b1 = _shr_words(emulate_smear_words(
                [v1, np.where(last, 0, next_words(v1))], r1 >> 24), (r1 >> 8) & 0xFF)
            b2 = _shr_words(emulate_smear_words(
                [v2, np.where(last, 0, next_words(v2))], r2 >> 24), (r2 >> 8) & 0xFF)
            legal = np.where(r + pc[..., 0:1] <= h, ~(b1[0] | b2[0]) & span, 0)
            at = (seg[..., None] * h + r) * nw + wd
            if in_place:                                    # env-slot e's own rows
                assert (at[mine] == ((env[..., None] * h + r) * nw + wd)[mine]).all()
                assert not written[at[mine]].any()          # each word staged once
                written[at[mine]] = True
            else:
                assert (staged[at[mine]] == -1).all()       # each word staged once
            staged[at[mine]] = legal[mine]
        if in_place:
            assert written[: count * h * nw].all()
        emulate_store_tall(staged, out, first * hw, count * hw, w, nw)
    assert (out < 2).all()
    return out.reshape(n, s * hw).astype(bool)


def emulate_legality_xwide_long_kernel(cfg, board, lk, addr=0, own_slot=False):
    """csrc/mask.cu's every-piece instance (``kEvery``) of the long-row
    xwide mask: ``emulate_mask_xwide_long_kernel`` on ``cfg`` with S = P and
    a hand holding every piece in order (env-slot q = e P + p reads piece
    p, ``slot_piece``), with ``lk``'s rectangle table and launch shape.
    Returns (N, P, HW) bool."""
    p, n = lk.num_pieces, len(board)
    every = dataclasses.replace(cfg, queue_size=p)
    hand = np.tile(np.arange(p, dtype=np.int32), (n, 1))
    return emulate_mask_xwide_long_kernel(every, board, hand, lk, addr, own_slot).reshape(
        n, p, cfg.num_cells)


def mask_inputs(ct, seed, fill=0.3):
    rng = np.random.default_rng(seed)
    return long_cells(ct, N, rng, fill), long_hands(ct, N, rng)


def jax_mask(cj, ct, board, queue):
    """JAX's shift mask: the whole u8 engine's where its tables fit, else
    ``jax_shift_mask``."""
    if ct.num_cells > SMALL:
        return jax_shift_mask(cj, board, queue)
    return np.asarray(jax_make_env(cj, state_impl="u8", mask_impl="shift").action_mask(
        jnp.asarray(board), jnp.asarray(queue)))


@pytest.mark.parametrize("case", LONG)
def test_long_rows_mask_and_legality_pick_their_xwide_long_instances(case, tables):
    """Rows of 1025 to 4096 cells: the mask and the legality take the xwide
    kernel's long-row instances (``kind`` "xwide", ``mask_xwide_long``,
    ``legality_xwide_long``): one env-slot a warp, ``XWIDE_WARPS`` warps a
    block, the mask's launch shape at S and at S = P, the rectangle piece
    table; their entries are bound."""
    _, ct = tables(case)
    mk, lk = MaskKernel(ct, "cpu"), LegalityKernel(ct, "cpu")
    every = dataclasses.replace(ct, queue_size=lk.num_pieces)
    assert (mk.kind, mk.instance, mk.name, mk.shape) == (
        "xwide", "xwide_long", "mask_xwide_long", (1, XWIDE_WARPS))
    assert (lk.kind, lk.instance, lk.name, lk.shape) == (
        "xwide", "xwide_long", "legality_xwide_long", (1, XWIDE_WARPS))
    assert mk.shape == u8_launch_shape(ct) and lk.shape == every_piece_shape(ct) == (
        u8_launch_shape(every))
    assert mk.xwide_long_launches == lk.xwide_long_launches == 0
    np.testing.assert_array_equal(mk.piece_table.numpy(), piece_rows_table(ct))
    np.testing.assert_array_equal(lk.piece_table.numpy(), piece_rows_table(ct))
    assert {"bp_mask_xwide", "bp_legality_xwide"} <= set(_build.SIGNATURES)
    # a block of four env-slots: its legal rows, and the rows of the envs
    # it reads where S > 1, well inside 48 KB
    assert xwide_smem_bytes(every, XWIDE_WARPS) <= 48 * 1024
    assert "cover_t" not in vars(mk) and "cover_t" not in vars(lk)  # built at first use


@pytest.mark.parametrize("case", LONG)
def test_long_rows_mask_matches_jax_mask(case, tables):
    """K1 on rows of more than 1024 cells: the NJ form's emulation against
    JAX's u8 shift mask on the envs whose hand ids lie in [0, P] and, where
    HW <= 4096, against the wrapper's plain version and the Pallas K1 in
    interpret mode on every env (ids outside [0, P) read as empty slots):
    pieces across word borders and the lane-31 border, the bar on a board
    of word borders, up to the right edge, a full board and an empty
    one."""
    cj, ct = tables(case)
    board, queue = mask_inputs(ct, 21)
    mk = MaskKernel(ct, "cpu")
    emu = emulate_mask_xwide_long_kernel(ct, board, queue, mk)
    ok = dealt(ct, queue)
    np.testing.assert_array_equal(emu[ok], jax_mask(cj, ct, board, queue)[ok])
    if ct.num_cells <= SMALL:
        np.testing.assert_array_equal(
            emu, mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy())
        np.testing.assert_array_equal(emu, np.asarray(jk.MaskKernel(cj, tile_n=N)(
            jnp.asarray(board), jnp.asarray(queue), interpret=True)))
    t = rules.tables_for(ct)
    h, w, hw = ct.height, ct.width, ct.num_cells
    assert 0 < emu.mean() < 1 and not emu[[0, N - 1]].any() and not emu[[1, 2], :hw].any()
    # the bar on word borders (env 5) and either side of the lane-31 border
    # (envs 7, 8): legal only where it spans no set column
    bw = t.piece_w[bar_piece(t)]
    cells = np.arange(w - bw + 1)[:, None] + np.arange(bw)
    for e, hit in ((5, (cells % 32 == 0) & (cells > 0)), (7, cells == 1024),
                   (8, cells == 1023)):
        free = ~hit.any(axis=1)
        bar = emu[e, :hw].reshape(h, w)
        np.testing.assert_array_equal(bar[:, : w - bw + 1], np.broadcast_to(free, (h, len(free))))
        assert not bar[:, w - bw + 1 :].any() and free.any() and not free.all()
    # the empty board: a piece's anchors up to the right and bottom edges
    pid = int(queue[N - 2, 0])
    if pid < t.num_pieces:
        anchors = emu[N - 2, :hw].reshape(h, w)
        ph, pw = t.piece_h[pid], t.piece_w[pid]
        assert anchors[: h - ph + 1, : w - pw + 1].all()
        assert anchors.sum() == max(h - ph + 1, 0) * (w - pw + 1)
    assert mk.xwide_long_launches == mk.general_launches == 0


@pytest.mark.parametrize("case", LONG)
@pytest.mark.parametrize("addr", [3, 13])
def test_long_rows_mask_emulation_takes_any_board_address(case, addr, tables):
    """Boards that start off a 16-byte boundary: the NJ form's emulation
    stages an unaligned head and tail byte by byte (an output row of 3090
    or 6210 bytes starts its block's span off a boundary too) and still
    equals JAX's shift mask on the dealt envs and, where HW <= 4096, the
    plain version on every env."""
    cj, ct = tables(case)
    board, queue = mask_inputs(ct, addr, fill=0.4)
    mk = MaskKernel(ct, "cpu")
    emu = emulate_mask_xwide_long_kernel(ct, board, queue, mk, addr)
    ok = dealt(ct, queue)
    np.testing.assert_array_equal(emu[ok], jax_shift_mask(cj, board, queue)[ok])
    if ct.num_cells <= SMALL:
        np.testing.assert_array_equal(
            emu, mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy())


@pytest.mark.parametrize("case", LONG)
def test_long_rows_legality_matches_jax_legality(case, tables):
    """K4 on rows of more than 1024 cells: the every-piece instance's
    emulation (the NJ mask's on a hand of every piece, S = P) against JAX's
    shift mask of that hand and, where HW <= 4096, the Pallas legality
    kernel in interpret mode, the JAX u8 engine's ``legal_all_pieces`` and
    the wrapper's plain version: the full board has no legal anchor, the
    empty board's are every piece's in-bounds anchors (``valid``)."""
    cj, ct = tables(case)
    board = long_cells(ct, N, np.random.default_rng(31), fill=0.25)
    lk = LegalityKernel(ct, "cpu")
    p = lk.num_pieces
    emu = emulate_legality_xwide_long_kernel(ct, board, lk)
    hand = np.tile(np.arange(p, dtype=np.int32), (N, 1))
    np.testing.assert_array_equal(
        emu.reshape(N, -1), jax_shift_mask(dataclasses.replace(cj, queue_size=p), board, hand))
    if ct.num_cells <= SMALL:
        want = np.asarray(jk.LegalityKernel(cj, tile_n=N, tile_a=2048)(
            jnp.asarray(board), interpret=True))
        np.testing.assert_array_equal(emu, want)
        engine = jax_make_env(cj, state_impl="u8").legal_all_pieces(jnp.asarray(board))
        np.testing.assert_array_equal(np.asarray(engine), want)
        np.testing.assert_array_equal(lk(torch.as_tensor(board)).numpy(), want)
    assert not emu[N - 1].any() and 0 < emu.mean() < 1
    np.testing.assert_array_equal(emu[N - 2].reshape(-1), rules.tables_for(ct).valid)
    # the column at the lane-31 border (env 7): no piece covers it
    t = rules.tables_for(ct)
    cells = np.arange(ct.width)
    for q in range(p):
        spans = (cells[:, None] + np.arange(t.piece_w[q]) == 1024).any(axis=1)
        assert not emu[7, q].reshape(ct.height, -1)[:, spans].any()
    assert lk.xwide_long_launches == lk.general_launches == 0


@pytest.mark.parametrize("case", ["2x1056", "3x1030", "9x1035r3"])
@pytest.mark.parametrize("addr", [3, 13])
def test_long_rows_legality_emulation_takes_any_board_address(case, addr, tables):
    """Boards off a 16-byte boundary: the every-piece instance's emulation
    (the block's span of envs starts at env first / P, its output span at
    env-slot first) equals JAX's shift mask of a hand of every piece."""
    cj, ct = tables(case)
    board = long_cells(ct, N, np.random.default_rng(addr), fill=0.3)
    lk = LegalityKernel(ct, "cpu")
    p = lk.num_pieces
    hand = np.tile(np.arange(p, dtype=np.int32), (N, 1))
    np.testing.assert_array_equal(
        emulate_legality_xwide_long_kernel(ct, board, lk, addr).reshape(N, -1),
        jax_shift_mask(dataclasses.replace(cj, queue_size=p), board, hand))


@pytest.mark.parametrize("case", ["2x1056", "3x1030"])
def test_jax_shift_mask_stand_in_is_the_engines_mask(case, tables):
    """``jax_shift_mask`` (the shift mask on an engine holding only the
    tables it reads) equals the whole JAX u8 engine's ``action_mask`` with
    ``mask_impl="shift"`` on every env, and at S = P its
    ``legal_all_pieces``."""
    cj, ct = tables(case)
    board, queue = mask_inputs(ct, 23)
    engine = jax_make_env(cj, state_impl="u8", mask_impl="shift")
    np.testing.assert_array_equal(
        jax_shift_mask(cj, board, queue),
        np.asarray(engine.action_mask(jnp.asarray(board), jnp.asarray(queue))))
    p = rules.tables_for(ct).num_pieces
    hand = np.tile(np.arange(p, dtype=np.int32), (N, 1))
    np.testing.assert_array_equal(
        jax_shift_mask(dataclasses.replace(cj, queue_size=p), board, hand),
        np.asarray(engine.legal_all_pieces(jnp.asarray(board))).reshape(N, -1))


@pytest.mark.parametrize("kernel", ["mask", "legality"])
def test_lane31_mutation_fails(kernel, tables):
    """The emulation in which lane 31 takes its own slot's next word (lane
    0's slot j, word 32 j, in place of slot j + 1's word 32 (j + 1)) differs
    from JAX's shift mask on the bar across the lane-31 border, on every
    board of two or more slots; the emulation as the kernel has it does not."""
    for case in ("2x1056", "2x2048"):
        cj, ct = tables(case)
        if kernel == "mask":
            board, queue = mask_inputs(ct, 25)
            mk = MaskKernel(ct, "cpu")
            want = jax_shift_mask(cj, board, queue)
            ok = dealt(ct, queue)
            got = [emulate_mask_xwide_long_kernel(ct, board, queue, mk, own_slot=m)[ok]
                   for m in (False, True)]
            want = want[ok]
        else:
            board = long_cells(ct, N, np.random.default_rng(25), fill=0.25)
            lk = LegalityKernel(ct, "cpu")
            hand = np.tile(np.arange(lk.num_pieces, dtype=np.int32), (N, 1))
            want = jax_shift_mask(dataclasses.replace(cj, queue_size=lk.num_pieces), board, hand)
            got = [emulate_legality_xwide_long_kernel(ct, board, lk, own_slot=m).reshape(N, -1)
                   for m in (False, True)]
        np.testing.assert_array_equal(got[0], want)
        assert (got[1] != want).any(), case


def test_long_rows_mask_launch_shapes_fit():
    """The mask's long-row launch shape on boards of 1 to 1000 rows of 1025
    to 4096 cells, with hands of one, three and five (the legality's S =
    P): one env-slot a warp and ``XWIDE_WARPS`` warps a block wherever they
    fit what a block may opt in to and stage and store fewer than 2^21
    bytes; fewer warps where the next would not fit; None only where one
    warp does not, and past 4096 cells a row.  At S = 1 it is the clear's."""
    for h in (1, 2, 3, 9, 32, 33, 40, 100, 129, 400, 1000):
        for w in (1025, 1030, 1056, 2048, 2049, 3000, 4096):
            for s in (1, 3, 5):
                cfg = tcfg.EnvConfig(height=h, width=w, queue_size=s)
                shape = u8_launch_shape(cfg)
                assert shape == xwide_long_launch_shape(cfg, xwide_smem_bytes, XWIDE_WARPS,
                                                        xwide_staged_envs)
                if s == 1:
                    assert shape == clear_launch_shape(cfg)
                if shape is None:
                    assert (xwide_smem_bytes(cfg, 1) > SMEM_OPT_IN
                            or xwide_staged_envs(cfg, 1) * cfg.num_cells >= 1 << 21)
                    continue
                per_warp, warps = shape
                assert per_warp == 1 and 1 <= warps <= XWIDE_WARPS
                assert xwide_smem_bytes(cfg, warps) <= SMEM_OPT_IN
                assert max(warps, xwide_staged_envs(cfg, warps)) * cfg.num_cells < 1 << 21
                if warps < XWIDE_WARPS:
                    assert (xwide_smem_bytes(cfg, warps + 1) > SMEM_OPT_IN
                            or xwide_staged_envs(cfg, warps + 1) * cfg.num_cells >= 1 << 21)
    # shared memory: the legal rows over the board rows at S = 1; at S = 3
    # the legal rows of 4 env-slots and the rows of the 3 envs they read
    cfg = tcfg.EnvConfig(height=2, width=1056)
    assert xwide_smem_bytes(cfg, 4) == 4 * 4 * 2 * 33
    assert xwide_smem_bytes(dataclasses.replace(cfg, queue_size=3), 4) == 4 * (4 + 3) * 2 * 33
    assert u8_launch_shape(tcfg.EnvConfig(height=1000, width=4096)) is None
    assert u8_launch_shape(tcfg.EnvConfig(height=400, width=4096)) == (1, 1)
    for w in (MAX_XWIDE + 1, 4128, 5000):
        assert u8_launch_shape(tcfg.EnvConfig(height=2, width=w)) is None
    assert MAX_XWIDE == 4 * 32 * 32 and XWIDE_SEGMENT == 32 * 32   # NJ = 4 at most


def test_rows_past_4096_cells_keep_the_general_mask_and_legality(tables):
    """2x4128 and 1x4128 (129 words a row, past the NJ = 4 instance): the
    mask and the legality keep their general kernels, with the per-cell
    piece table."""
    for shape in (dict(height=2, width=4128, piece_set="mini5"),
                  dict(height=1, width=4128, piece_set="mini5")):
        ct = tcfg.EnvConfig(**shape)
        mk, lk = MaskKernel(ct, "cpu"), LegalityKernel(ct, "cpu")
        assert (mk.kind, mk.instance, mk.name, mk.shape) == (
            "general", "general", "mask_general", None)
        assert (lk.kind, lk.instance, lk.name, lk.shape) == (
            "general", "general", "legality_general", None)
        assert u8_launch_shape(ct) is None and every_piece_shape(ct) is None
        np.testing.assert_array_equal(mk.piece_table.numpy(), piece_table(ct))
        np.testing.assert_array_equal(lk.piece_table.numpy(), piece_table(ct))


@pytest.mark.parametrize("name, ms", [("mask_xwide_long", 0.062034),
                                      ("legality_xwide_long", 0.185927)])
def test_long_row_mask_and_legality_are_bytes_bound_on_2x1056(name, ms):
    """The long-row mask and legality at N = 49152 on 2x1056 move the
    general kernels' bytes (the mask 4228 B an env: the board and the hand
    id in, the mask out, 0.062034 ms at 3.35 TB/s; the legality 12672 B:
    the board in, 5 HW bools out, 0.185927 ms) and count the xwide
    kernels' operations, below the bytes at the integer rate."""
    cfg, n = tcfg.EnvConfig(height=2, width=1056, piece_set="mini5"), 49152
    hw = cfg.num_cells
    board = torch.zeros(n, hw, dtype=torch.uint8)
    if name == "mask_xwide_long":
        inputs = (board, torch.zeros(n, 1, dtype=torch.int32))
        outputs, per_env = (torch.zeros(n, hw, dtype=torch.bool),), 4228
    else:
        inputs, outputs, per_env = (board,), (torch.zeros(n, 5, hw, dtype=torch.bool),), 12672
    nbytes, ops = COSTS[name](cfg, inputs, outputs)
    general, _ = COSTS[name.replace("_xwide_long", "_general")](cfg, inputs, outputs)
    assert nbytes == general == per_env * n
    assert ops == COSTS[name.removesuffix("_long")](cfg, inputs, outputs)[1]
    b = bound(list(inputs) + list(outputs), ops)
    assert b["bound_by"] == "bytes" and round(b["bound_ms"], 6) == ms
