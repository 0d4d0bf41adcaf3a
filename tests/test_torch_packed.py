"""The packed-board kernels (``kernels/packed.py``) on the CPU against the JAX
packed engine's helpers.

The JAX package runs its packed step in jnp, so the references are its
helpers on ``make_env(cfg, state_impl="packed")``: ``_cover_words``,
``_clear_scan_packed`` and the packed block of ``step`` for the apply,
``_bitboard_mask_from_words`` for the mask.  Inputs are numpy arrays from
a seed: boards with full rows, columns and woodoku regions, near-full
rows that a 1x1 completes, and actions that are legal, illegal, out of
bounds or overhang the right edge.  The port holds words as int64, JAX as
uint32; they are compared as integers.  Besides the four presets, a
6x32 board puts bit 31 in use and lets shifts by up to 31 wrap.

The plain versions are also held against the u8 kernels' plain versions
on the unpacked boards, and a numpy emulation of each CUDA kernel's
per-thread logic, fed the tables the wrappers hand to the kernels, closes
the loop on the CPU (the kernels themselves run only on the card:
``chip_smoke.py`` and the ``gpu``-marked tests in test_torch_rollout.py).
Everything is integer or bool and must be bit-equal.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockpuzzle_tpu import config as jcfg
from blockpuzzle_tpu.env import make_env as jax_make_env
from blockpuzzle_tpu_torch import config as tcfg
from blockpuzzle_tpu_torch import rules
from blockpuzzle_tpu_torch.env import make_env
from blockpuzzle_tpu_torch.kernels import (
    ApplyKernel,
    MaskKernel,
    PackedApplyKernel,
    PackedMaskKernel,
)
from blockpuzzle_tpu_torch.kernels.packed import (
    U32,
    bitboard_tables,
    clear_packed_plain,
    cover_words_plain,
    pack_words,
    unpack_words,
)

CASES = ["default", "tenten", "woodoku", "big", "wide32"]
N = 24


def _pair(case):
    if case == "wide32":
        kw = dict(height=6, width=32, queue_size=2)
        return jcfg.EnvConfig(**kw), tcfg.EnvConfig(**kw)
    return jcfg.PRESETS[case](), tcfg.PRESETS[case]()


@functools.cache
def jax_packed(case):
    cj, _ = _pair(case)
    return jax_make_env(cj, state_impl="packed")


def crafted_cells(cfg, n, rng, fill=0.45):
    """(n, H, W) boards: random cells, full rows and columns, a row full
    but for its first cell, full 3x3 regions (one crossed by a full row),
    and all-full and empty boards."""
    cells = (rng.random((n, cfg.height, cfg.width)) < fill).astype(np.uint8)
    cells[0::6, 1, :] = 1
    cells[1::6, :, cfg.width - 1] = 1
    cells[2::6, 4 % cfg.height, :] = 1
    cells[2::6, 4 % cfg.height, 0] = 0
    cells[3::6, 0:3, 3:6] = 1
    cells[4::6, 3:6, 0:3] = 1
    cells[4::6, 4 % cfg.height, :] = 1
    cells[n - 1] = 1
    cells[n - 2] = 0
    return cells


def np_words(cells):
    w = cells.shape[-1]
    return (cells.astype(np.uint64) << np.arange(w, dtype=np.uint64)).sum(
        axis=-1).astype(np.uint32)


def chosen_actions(cfg, n, rng):
    """attrs (n, 11), r, c (n,) int32 and valid (n,) bool, as the engine's
    step derives them: random piece ids (the empty sentinel included) at
    random anchors; every sixth env takes a 1x1 at (4, 0), completing the
    near-full row of ``crafted_cells``."""
    t = rules.tables_for(cfg)
    table = np.concatenate(
        [t.piece_h[:, None], t.piece_w[:, None], t.piece_cells[:, None],
         t.piece_rects], axis=1)
    table = np.concatenate([table, np.zeros((1, 11), table.dtype)]).astype(np.int32)
    pid = rng.integers(0, t.num_pieces + 1, n)
    r = rng.integers(0, cfg.height, n).astype(np.int32)
    c = rng.integers(0, cfg.width, n).astype(np.int32)
    pid[2::6], r[2::6], c[2::6] = 0, 4 % cfg.height, 0
    c[5::6] = cfg.width - 1                       # overhang the right edge
    attrs = table[pid]
    valid = (pid < t.num_pieces) & (r + attrs[:, 0] <= cfg.height) & (
        c + attrs[:, 1] <= cfg.width)
    return attrs, r, c, valid


def jax_apply(env_j, words, attrs, r, c, valid):
    """The packed block of the JAX ``step`` (core.py), verbatim."""
    words = jnp.asarray(words)
    cover = env_j._cover_words(jnp.asarray(attrs), jnp.asarray(r), jnp.asarray(c))
    overlap = jnp.any((words & cover) != 0, axis=1)
    legal = jnp.logical_and(jnp.asarray(valid), jnp.logical_not(overlap))
    placed = jnp.where(legal[:, None], words | cover, words)
    cleared, k = env_j._clear_scan_packed(placed)
    k = jnp.where(legal, k, 0)
    return jnp.where(legal[:, None], cleared, words), k, legal, cover


# --------------------------------------------------------------------------
# numpy emulations of csrc/packed_apply.cu and csrc/packed_mask.cu
# --------------------------------------------------------------------------


def _shl32(x, s):
    return (x << s) & U32 if s < 32 else 0


def emulate_packed_apply(cfg, words, attrs, r, c, valid):
    """csrc/packed_apply.cu, one env at a time, in uint32 arithmetic."""
    h, w = cfg.height, cfg.width
    rs = cfg.region_size if cfg.region_clear else 0
    out = np.zeros_like(words, dtype=np.int64)
    ks = np.zeros(len(words), np.int32)
    legals = np.zeros(len(words), bool)
    for e in range(len(words)):
        a = [int(x) for x in attrs[e]]
        row0 = [int(r[e]) + a[3 + 4 * j] for j in range(2)]
        row1 = [row0[j] + a[5 + 4 * j] for j in range(2)]
        mask = [_shl32((_shl32(1, a[6 + 4 * j]) - 1) & U32, int(c[e]) + a[4 + 4 * j])
                for j in range(2)]
        b = [int(x) for x in words[e]]
        placed, overlap = [], False
        for i in range(h):
            cover = (mask[0] if row0[0] <= i < row1[0] else 0) | (
                mask[1] if row0[1] <= i < row1[1] else 0)
            overlap |= (b[i] & cover) != 0
            placed.append(b[i] | cover)
        legal = bool(valid[e]) and not overlap
        legals[e] = legal
        if not legal:
            out[e] = b
            continue
        full = (_shl32(1, w) - 1) & U32
        cols, k = U32, 0
        for x in placed:
            cols &= x
            k += x == full
        k += bin(cols).count("1")
        band_end = {}
        if rs:
            band = U32
            for i in range(h):
                band &= placed[i]
                if (i + 1) % rs == 0:
                    reg = 0
                    for s in range(0, w - rs + 1, rs):
                        tile = (((1 << rs) - 1) << s) & U32
                        if band & tile == tile:
                            reg |= tile
                            k += 1
                    band_end[i], band = reg, U32
        reg = 0
        for i in reversed(range(h)):
            if rs and (i + 1) % rs == 0:
                reg = band_end[i]
            clear = (full if placed[i] == full else 0) | cols | reg
            out[e, i] = placed[i] & ~clear & U32
        ks[e] = k
    return out, ks, legals


def emulate_packed_mask(cfg, words, queue, mk):
    """csrc/packed_mask.cu, one (env, slot, row) thread at a time, on the
    32-bit tables ``PackedMaskKernel`` hands to the kernel."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    prow = mk.prow32.numpy().view(np.uint32)
    piece_w = mk.piece_w32.numpy()
    cmask = mk.cmask32.numpy().view(np.uint32)
    nwords, fpw = mk.tables.nwords, mk.tables.fpw
    full = (_shl32(1, w) - 1) & U32
    out = np.zeros((len(words), s, h, w), bool)
    for e in range(len(words)):
        for slot in range(s):
            pid = int(queue[e, slot])
            if not 0 <= pid < mk.num_pieces:
                continue
            for row in range(h):
                wk = []
                for k in range(nwords):
                    acc = 0
                    for j in range(fpw):
                        rr = row + k * fpw + j
                        acc |= _shl32(int(words[e, rr]) if rr < h else full, j * w)
                    wk.append(acc)
                for col in range(w):
                    legal = col + int(piece_w[pid]) <= w
                    for k in range(nwords):
                        pk = _shl32(int(prow[pid, k]), col) & int(cmask[col])
                        legal &= (wk[k] & pk) == 0
                    out[e, slot, row, col] = legal
    return out.reshape(len(words), -1)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_bitboard_tables_match_jax(case):
    env_j = jax_packed(case)
    bb = bitboard_tables(_pair(case)[1])
    assert (bb.fpw, bb.nwords) == (env_j._bb_fpw, env_j._bb_nwords)
    for name, want in (("prow", env_j._bb_prow), ("cmask", env_j._bb_cmask),
                       ("piece_w", env_j._bb_piece_w)):
        got = getattr(bb, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, name)


@pytest.mark.parametrize("case", CASES)
def test_pack_and_unpack_match_jax(case):
    env_j = jax_packed(case)
    cj, ct = _pair(case)
    cells = crafted_cells(ct, N, np.random.default_rng(0))
    words = np.asarray(env_j._pack_board(jnp.asarray(cells.reshape(N, -1))))
    got = pack_words(torch.as_tensor(cells))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), words.astype(np.int64))
    np.testing.assert_array_equal(
        unpack_words(got, ct.width).numpy(),
        np.asarray(env_j._unpack_board(jnp.asarray(words))))


@pytest.mark.parametrize("case", CASES)
def test_packed_apply_matches_jax_packed_step(case):
    """cover words, clear and the whole apply block against JAX, then the
    kernel wrapper (plain version on the CPU) and the kernel's emulation."""
    env_j = jax_packed(case)
    _, ct = _pair(case)
    rng = np.random.default_rng(1)
    cells = crafted_cells(ct, N, rng)
    words = np_words(cells)
    attrs, r, c, valid = chosen_actions(ct, N, rng)
    want_next, want_k, want_legal, want_cover = (
        np.asarray(x) for x in jax_apply(env_j, words, attrs, r, c, valid))
    tw = torch.as_tensor(words.astype(np.int64))
    ta, tr, tc, tv = (torch.as_tensor(x) for x in (attrs, r, c, valid))
    np.testing.assert_array_equal(
        cover_words_plain(ta, tr, tc, ct.height).numpy(),
        want_cover.astype(np.int64))
    cl_j, k_j = env_j._clear_scan_packed(jnp.asarray(words))
    cl_t, k_t = clear_packed_plain(tw, ct)
    np.testing.assert_array_equal(cl_t.numpy(), np.asarray(cl_j).astype(np.int64))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    ak = PackedApplyKernel(ct, "cpu")
    got = ak(tw, ta, tr, tc, tv)
    emu = emulate_packed_apply(ct, words, attrs, r, c, valid)
    for g, e, wnt, name in zip(got, emu, (want_next.astype(np.int64), want_k,
                                          want_legal), ("words", "k", "legal")):
        np.testing.assert_array_equal(g.numpy(), wnt, name)
        np.testing.assert_array_equal(e, wnt, name)
    assert want_legal.any() and (~want_legal).any() and want_k.sum() > 0
    assert np.asarray(k_j).sum() > 0 and ak.launches == 0
    if ct.region_clear:  # a full region crossed by a full row: both count
        assert np.asarray(k_j)[4] >= 2


@pytest.mark.parametrize("case", CASES)
def test_packed_mask_matches_jax_bitboard_mask(case):
    env_j = jax_packed(case)
    _, ct = _pair(case)
    rng = np.random.default_rng(2)
    cells = crafted_cells(ct, N, rng, fill=0.3)
    words = np_words(cells)
    num_pieces = rules.tables_for(ct).num_pieces
    queue = rng.integers(0, num_pieces + 1, (N, ct.queue_size)).astype(np.int32)
    queue[0] = num_pieces                                 # all slots empty
    want = np.asarray(env_j._bitboard_mask_from_words(
        jnp.asarray(words), jnp.asarray(queue)))
    mk = PackedMaskKernel(ct, "cpu")
    got = mk(torch.as_tensor(words.astype(np.int64)), torch.as_tensor(queue))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(emulate_packed_mask(ct, words, queue, mk), want)
    assert 0 < want.mean() < 1 and mk.launches == 0


@pytest.mark.parametrize("case", CASES)
def test_packed_plain_versions_match_u8_ones(case):
    """On the unpacked boards: the packed mask against the u8 mask's plain
    version, and the packed apply against the u8 apply's, with the u8
    engine's footprint cells for the same actions."""
    _, ct = _pair(case)
    rng = np.random.default_rng(3)
    cells = crafted_cells(ct, N, rng)
    flat = torch.as_tensor(cells.reshape(N, -1))
    tw = pack_words(torch.as_tensor(cells))
    num_pieces = rules.tables_for(ct).num_pieces
    queue = torch.as_tensor(
        rng.integers(0, num_pieces + 1, (N, ct.queue_size)).astype(np.int32))
    assert torch.equal(PackedMaskKernel(ct).plain(tw, queue),
                       MaskKernel(ct).plain(flat, queue))
    attrs, r, c, valid = (torch.as_tensor(x) for x in chosen_actions(ct, N, rng))
    cover = make_env(ct, device="cpu", state_impl="u8")._cover_cells(attrs, r, c)
    words_next, k, legal = PackedApplyKernel(ct).plain(tw, attrs, r, c, valid)
    board_next, k8, legal8 = ApplyKernel(ct).plain(flat, cover, valid)
    assert torch.equal(unpack_words(words_next, ct.width).reshape(N, -1), board_next)
    assert torch.equal(k, k8) and torch.equal(legal, legal8)


def test_illegal_action_on_a_full_line_is_a_strict_noop():
    """Every board holds a full row 0 and a full column; the action (1x1
    at (0, 0)) overlaps them, so nothing changes and k = 0."""
    for case in CASES:
        _, ct = _pair(case)
        cells = np.zeros((8, ct.height, ct.width), np.uint8)
        cells[:, 0, :] = 1
        cells[:, :, 1] = 1
        attrs, r, c, valid = chosen_actions(ct, 8, np.random.default_rng(4))
        attrs[:], r[:], c[:] = attrs[2], 0, 0
        valid[:] = True
        words = np_words(cells)
        tw = torch.as_tensor(words.astype(np.int64))
        out = PackedApplyKernel(ct)(tw, *(torch.as_tensor(x) for x in (attrs, r, c, valid)))
        emu = emulate_packed_apply(ct, words, attrs, r, c, valid)
        for got in (out, emu):
            assert not np.asarray(got[2]).any() and not np.asarray(got[1]).any()
            np.testing.assert_array_equal(np.asarray(got[0]), tw.numpy())


def test_packed_wrappers_validate_inputs():
    cfg = tcfg.tenten_config()
    ak, mk = PackedApplyKernel(cfg), PackedMaskKernel(cfg)
    words = torch.zeros(4, cfg.height, dtype=torch.int64)
    queue = torch.zeros(4, cfg.queue_size, dtype=torch.int32)
    attrs = torch.zeros(4, 11, dtype=torch.int32)
    rc = torch.zeros(4, dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        mk(words.to(torch.int32), queue)
    with pytest.raises(ValueError):
        mk(words, queue[:, :1])
    with pytest.raises(ValueError):
        ak(words[:, :3], attrs, rc, rc, valid)
    with pytest.raises(ValueError):
        ak(words, attrs[:, :8], rc, rc, valid)
    with pytest.raises(ValueError):
        ak(words, attrs, rc.long(), rc, valid)
    with pytest.raises(ValueError):
        ak(words, attrs, rc, rc, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="width <= 32"):
        PackedMaskKernel(dataclasses.replace(cfg, width=33))
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no packed mask kernel"):
        PackedMaskKernel(cfg, meta)(words.to(meta), queue.to(meta))
    with pytest.raises(ValueError, match="no packed apply kernel"):
        PackedApplyKernel(cfg, meta)(*(x.to(meta) for x in (words, attrs, rc, rc, valid)))
    with pytest.raises(ValueError, match="kernel tables on cpu"):
        mk(words.to(meta), queue.to(meta))
