"""The port's kernels on the CPU against the JAX package's Pallas kernels.

Each case makes its inputs with numpy from a seed and runs them through
``MaskKernel``/``ApplyKernel``/``ClearScanKernel``/``LegalityKernel`` of
the JAX package in interpret mode and through the port's wrappers, which
run the plain torch versions for CPU tensors.  A numpy emulation of each CUDA kernel's per-thread/per-warp
logic, fed the very tables the wrappers hand to the kernels, closes the
loop on the CPU (the kernels themselves run only on the card:
``chip_smoke.py`` and the ``gpu``-marked test in test_torch_rollout.py).
All outputs are integers or bools and must be bit-equal.
"""

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
)
from blockpuzzle_tpu_torch.kernels.clear import line_cell_table, line_masks
from blockpuzzle_tpu_torch.kernels.collision import piece_table

PRESETS = ["default", "tenten", "woodoku"]


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


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("n", [16, 11])
def test_mask_matches_pallas_mask_kernel(preset, n, rng):
    """Includes empty-slot sentinels, invalid anchors and a ragged N (the
    JAX kernel runs it as one tile of n; the port takes any N)."""
    cj, ct = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    board = random_boards(ct, n, rng, fill=0.4)
    num_pieces = rules.tables_for(ct).num_pieces
    queue = rng.integers(0, num_pieces + 1, (n, ct.queue_size)).astype(np.int32)
    queue[0] = num_pieces                                   # all slots empty
    want = np.asarray(jk.MaskKernel(cj, tile_n=min(8, n) if n % 8 == 0 else n)(
        jnp.asarray(board), jnp.asarray(queue), interpret=True))
    mk = MaskKernel(ct, "cpu")
    got = mk(torch.as_tensor(board), torch.as_tensor(queue)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulate_mask_kernel(ct, board, queue), want)
    assert mk.launches == 0  # the plain version is no launch


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


@pytest.mark.parametrize("preset", ["default", "woodoku"])
@pytest.mark.parametrize("n", [16, 11])
def test_clear_matches_pallas_clear_kernel(preset, n, rng):
    """Against the Pallas kernel (interpret mode; the ragged N runs as one
    tile of n) and the JAX engine's ``clear_scan``.  Boards hold full rows
    and columns and, on woodoku, a full 3x3 region crossing a full row."""
    cj, ct = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    board = random_boards(ct, n, rng, fill=0.6)
    grid = board.reshape(n, ct.height, ct.width)
    grid[5, 3:6, 3:6] = 1                   # a full 3x3 region ...
    grid[5, 4, :] = 1                       # ... crossed by a full row
    want = jk.ClearScanKernel(cj, tile_n=8 if n % 8 == 0 else n)(
        jnp.asarray(board), interpret=True)
    engine = jax_make_env(cj).clear_scan(jnp.asarray(board))
    ck = ClearScanKernel(ct, "cpu")
    got = ck(torch.as_tensor(board))
    emu = emulate_clear_kernel(ct, board)
    for w, e, g, m, name in zip(want, engine, got, emu, ("board", "k")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        np.testing.assert_array_equal(np.asarray(e), np.asarray(w), name)
        np.testing.assert_array_equal(m, np.asarray(w), name)
    k, cleared = np.asarray(want[1]), np.asarray(want[0]).reshape(grid.shape)
    assert k.min() == 0 and not cleared[5, 4].any()
    if ct.region_clear:  # the shared cell counts for both, cleared once
        assert k[5] >= 2 and not cleared[5, 3:6, 3:6].any()
    assert ck.launches == 0


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
