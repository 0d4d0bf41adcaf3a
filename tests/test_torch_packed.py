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
    mask_block_warps,
    pack_words,
    segments_per_warp,
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
#
# Every lane of every warp at once: values are (warps, 32) int64 arrays
# holding uint32 bits, a thread's global id is block * threads + threadIdx
# (blocks are whole warps).  A warp holds P = 32 // H segments of H lanes
# and 32 - P*H left-over lanes; __shfl_sync reads its (explicit) source
# lane modulo 32, __ballot_sync gathers the whole warp's predicate bits,
# __reduce_*_sync gives each lane the result over its segment (the
# left-over lanes form one).
# --------------------------------------------------------------------------


def _shl32(x, s):
    s = np.asarray(s)
    return np.where(s < 32, (np.asarray(x, np.int64) << np.minimum(s, 31)) & U32, 0)


def _popc(x):
    x = np.asarray(x, np.int64)
    return np.array([int(v).bit_count() for v in x.ravel()]).reshape(x.shape)


def _shfl(v, src):
    return np.take_along_axis(v, np.broadcast_to(src, v.shape) % 32, axis=1)


def _reduce(v, seg, op):
    """__reduce_{and,add}_sync(seg, v): seg is each lane's segment id."""
    out = np.empty_like(v)
    for sid in np.unique(seg):
        at = seg == sid
        out[:, at] = op.reduce(v[:, at], axis=1, keepdims=True)
    return out


def _ballot(pred):
    return (pred.astype(np.int64) << np.arange(32)).sum(axis=1, keepdims=True)


def _small_div(q, d):
    """The kernels' q / d for small q: (q + 1/2) times the float32
    reciprocal of d, truncated; equal to the integer quotient."""
    inv = np.float32(1) / np.float32(d)
    got = ((np.asarray(q).astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
    assert (got == np.asarray(q) // d).all()
    return got


def _warp_layout(height):
    """Per warp lane l: segment s = l // H (P for the left-over lanes), its
    row, its first lane, and its lanes in ballot bits."""
    per_warp = segments_per_warp(height)
    l = np.arange(32)
    s = _small_div(l, height)
    base = s * height
    seg = np.where(s < per_warp, ((1 << height) - 1) << base, (U32 << base) & U32)
    return per_warp, l, s, l - base, base, seg & U32


def emulate_packed_apply(cfg, words, attrs, r, c, valid, threads=256):
    """csrc/packed_apply.cu: one segment of H lanes per env, lane = row."""
    h, w = cfg.height, cfg.width
    rs = cfg.region_size if cfg.region_clear else 0
    n = len(words)
    per_warp, l, s, lane, base, seg = _warp_layout(h)
    per_block = threads // 32 * per_warp
    tid = np.arange(-(-n // per_block) * threads).reshape(-1, 32)
    env = tid // 32 * per_warp + s
    lane = np.broadcast_to(lane, tid.shape)
    active = (s < per_warp) & (env < n)
    e = np.where(active, env, 0)                  # a safe index; masked below
    x64 = np.where(active, words.astype(np.int64)[e, np.minimum(lane, h - 1)], 0)
    x = np.where(active, x64 & U32, U32)
    ok = active & valid[e]
    cover = np.zeros_like(tid)
    for j in range(2):
        row0 = r[e] + attrs[e, 3 + 4 * j]
        on = active & (lane >= row0) & (lane < row0 + attrs[e, 5 + 4 * j])
        mask = _shl32((_shl32(1, attrs[e, 6 + 4 * j]) - 1) & U32, c[e] + attrs[e, 4 + 4 * j])
        cover |= np.where(on, mask, 0)
    overlap = (_ballot((x & cover) != 0) & seg) != 0
    legal = ok & ~overlap
    wv = x | cover
    full = int(_shl32(1, w)) - 1 & U32
    cols = _reduce(wv, s, np.bitwise_and)
    k = _popc(_ballot(active & (wv == full)) & seg) + _popc(cols)
    reg = np.zeros_like(tid)
    if rs:
        b0 = lane - lane % rs
        whole = b0 + rs <= h
        band = np.full_like(tid, U32)
        for t in range(rs):
            band &= _shfl(wv, np.where(whole, base + b0 + t, l))
        tiles = np.zeros_like(tid)
        for s0 in range(0, w - rs + 1, rs):
            tile = (((1 << rs) - 1) << s0) & U32
            hit = whole & ((band & tile) == tile)
            reg |= np.where(hit, tile, 0)
            tiles += hit & (lane == b0)
        k = k + _reduce(tiles, s, np.add)
    clear = np.where(wv == full, full, 0) | cols | reg
    stored = np.where(legal, wv & ~clear & U32, x64)
    out = np.full((n, h), -1, np.int64)
    out[env[active], lane[active]] = stored[active]
    ks, legals = np.full(n, -1, np.int32), np.zeros(n, bool)
    head = active & (lane == 0)
    ks[env[head]] = np.where(legal, k, 0)[head]
    legals[env[head]] = legal[head]
    assert (out >= 0).all() and (ks >= 0).all()   # every output written
    return out, ks, legals


def _spread4(x):
    return ((x & 0xF) * 0x00204081) & 0x01010101


def emulate_packed_mask(cfg, words, queue, mk):
    """csrc/packed_mask.cu on the 32-bit tables ``PackedMaskKernel`` hands
    the kernel: one segment of H lanes per (env, slot), lane = anchor row,
    ``mask_block_warps`` warps a block; each row's legal bits staged in a
    block buffer, then assembled 16 bits at a time, spread into 16 bytes
    and stored as one 16-byte vector, plus a ragged tail."""
    h, w, s = cfg.height, cfg.width, cfg.queue_size
    prow = mk.prow32.numpy().view(np.uint32).astype(np.int64)
    piece_w = mk.piece_w32.numpy()
    nwords, fpw = mk.tables.nwords, mk.tables.fpw
    n = len(words)
    total = n * s
    per_warp, l, sw, lane, base, _ = _warp_layout(h)
    warps = mask_block_warps(h, w)
    threads, per_block = 32 * warps, warps * per_warp
    blocks = -(-total // per_block)
    tid = np.arange(blocks * threads).reshape(-1, 32)
    blk, tx = tid // threads, tid % threads
    seg = tx // 32 * per_warp + sw
    es = blk * per_block + seg
    lane = np.broadcast_to(lane, tid.shape)
    active = (sw < per_warp) & (es < total)
    full = int(_shl32(1, w)) - 1 & U32
    esc = np.where(active, es, 0)
    pid = np.where(active, queue.reshape(-1)[esc], -1)
    x = np.where(active, words.astype(np.int64)[esc // s, np.minimum(lane, h - 1)], full)
    has = (pid >= 0) & (pid < mk.num_pieces)
    p = np.where(has, pid, 0)
    pw = np.where(has, piece_w[p], w + 1)
    blocked = np.zeros_like(tid)
    for k in range(nwords):
        wk = np.zeros_like(tid)
        for j in range(fpw):
            t = lane + k * fpw + j
            y = _shfl(x, np.where(t < h, l + k * fpw + j, l))
            wk |= _shl32(np.where(t < h, y, full), j * w)
        m = np.where(pw <= w, prow[p, k], 0)
        for bit in range(32):                     # each set bit p of m
            blocked |= np.where((m >> bit) & 1, wk >> bit, 0)
    span = np.where(pw <= w, _shl32(1, w - pw + 1) - 1 & U32, 0)
    rows = np.full((blocks, warps * 32), -1, np.int64)   # -1: never written
    at = seg * h + lane
    assert at[active].max() < rows.shape[1]
    rows[blk[active], at[active]] = (~blocked & span)[active]
    out = np.full(total * h * w, 2, np.uint8)    # 2: never written
    for b in range(blocks):
        start = b * per_block * h * w
        nbytes = min(per_block, total - b * per_block) * h * w
        assert start % 16 == 0                    # the uint4 stores' alignment
        for i in range(nbytes // 16):
            q = 16 * i
            row = int(_small_div(q, w))
            col, got, bits = q - row * w, 0, 0
            while got < 16:
                assert rows[b, row] >= 0
                bits |= (int(rows[b, row]) >> col) << got
                got, row, col = got + w - col, row + 1, 0
            vec = [_spread4(bits >> (4 * v)) for v in range(4)]
            out[start + q : start + q + 16] = np.array(vec, "<u4").view(np.uint8)
        for q in range(nbytes // 16 * 16, nbytes):
            row = int(_small_div(q, w))
            assert rows[b, row] >= 0
            out[start + q] = (int(rows[b, row]) >> (q - row * w)) & 1
    assert (out < 2).all()
    return out.reshape(n, s * h * w).astype(bool)


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
    assert torch.equal(PackedMaskKernel(ct, "cpu").plain(tw, queue),
                       MaskKernel(ct, "cpu").plain(flat, queue))
    attrs, r, c, valid = (torch.as_tensor(x) for x in chosen_actions(ct, N, rng))
    cover = make_env(ct, device="cpu", state_impl="u8")._cover_cells(attrs, r, c)
    words_next, k, legal = PackedApplyKernel(ct, "cpu").plain(tw, attrs, r, c, valid)
    board_next, k8, legal8 = ApplyKernel(ct, "cpu").plain(flat, cover, valid)
    assert torch.equal(unpack_words(words_next, ct.width).reshape(N, -1), board_next)
    assert torch.equal(k, k8) and torch.equal(legal, legal8)


@pytest.mark.parametrize("case", CASES)
def test_kernel_emulations_on_a_ragged_edge(case):
    """N = 37 leaves the apply kernel's last warp part-full (37 = 12*3 + 1
    envs at three a warp) and the mask kernel's last block short of its
    env-slots (on the 10x10 and 9x9 boards with a store span that is no
    multiple of 16)."""
    _, ct = _pair(case)
    n = 37
    rng = np.random.default_rng(5)
    cells = crafted_cells(ct, n, rng)
    words = np_words(cells)
    attrs, r, c, valid = chosen_actions(ct, n, rng)
    num_pieces = rules.tables_for(ct).num_pieces
    queue = rng.integers(0, num_pieces + 1, (n, ct.queue_size)).astype(np.int32)
    tw = torch.as_tensor(words.astype(np.int64))
    want = PackedApplyKernel(ct, "cpu").plain(
        tw, *(torch.as_tensor(x) for x in (attrs, r, c, valid)))
    for e, p in zip(emulate_packed_apply(ct, words, attrs, r, c, valid), want):
        np.testing.assert_array_equal(e, p.numpy())
    mk = PackedMaskKernel(ct, "cpu")
    np.testing.assert_array_equal(emulate_packed_mask(ct, words, queue, mk),
                                  mk.plain(tw, torch.as_tensor(queue)).numpy())
    per_block = segments_per_warp(ct.height) * mask_block_warps(ct.height, ct.width)
    assert (n * ct.queue_size) % per_block


def test_segment_and_block_sizes():
    """Segments a warp and the mask kernel's warps a block, over every
    H, W <= 32; the float quotients the kernels use are exact there."""
    assert [segments_per_warp(h) for h in (1, 6, 9, 10, 16, 17, 32)] == [
        32, 5, 3, 3, 2, 1, 1]
    assert [mask_block_warps(h, w) for h, w in ((10, 10), (9, 9), (16, 16))] == [
        4, 16, 4]
    for h in range(1, 33):
        for w in range(1, 33):
            warps = mask_block_warps(h, w)
            assert 4 <= warps <= 16
            assert warps * segments_per_warp(h) * h * w % 16 == 0
        _small_div(np.arange(32), h)
        _small_div(np.arange(16 * 32 * 32), h)
    for h in (0, 33):
        with pytest.raises(ValueError, match="H <= 32"):
            segments_per_warp(h)


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
        out = PackedApplyKernel(ct, "cpu")(
            tw, *(torch.as_tensor(x) for x in (attrs, r, c, valid)))
        emu = emulate_packed_apply(ct, words, attrs, r, c, valid)
        for got in (out, emu):
            assert not np.asarray(got[2]).any() and not np.asarray(got[1]).any()
            np.testing.assert_array_equal(np.asarray(got[0]), tw.numpy())


def test_packed_wrappers_validate_inputs():
    cfg = tcfg.tenten_config()
    ak, mk = PackedApplyKernel(cfg, "cpu"), PackedMaskKernel(cfg, "cpu")
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
        PackedMaskKernel(dataclasses.replace(cfg, width=33), "cpu")
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no packed mask kernel"):
        PackedMaskKernel(cfg, meta)(words.to(meta), queue.to(meta))
    with pytest.raises(ValueError, match="no packed apply kernel"):
        PackedApplyKernel(cfg, meta)(*(x.to(meta) for x in (words, attrs, rc, rc, valid)))
    with pytest.raises(ValueError, match="kernel tables on cpu"):
        mk(words.to(meta), queue.to(meta))
