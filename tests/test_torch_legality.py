"""The all-pieces legality (K4) beyond 32x32, on the CPU, against the JAX
package.

Boards of more than 32 rows or of more than 32 cells a row take the
every-piece instances of the hand mask's wide, tall, deep and xwide kernels
(``csrc/mask.cu``, ``kEvery``: ``legality_wide``, ``legality_tall``,
``legality_deep``, ``legality_xwide``): the hand mask of a hand that holds
every piece, env-slot q taking piece q mod P, with the mask's launch shape
at S = P and its rectangle piece table. Their emulations are the mask
kernels' emulations fed such a hand (``emulate_legality_instance``), with
the tables and launch shapes the wrapper hands the kernels and boards
staged at byte offsets 0, 3 and 13; they are held bit-equal to the
wrapper's plain version, to the JAX Pallas legality kernel in interpret
mode and to the JAX u8 engine's ``legal_all_pieces``. The general kernel
stays for rows of more than 4096 cells (2x4128); boards of more than 32
rows of 129 to 1024 cells take the xwide instance
(``test_torch_xwide_tall.py``), rows of 1025 to 4096 cells its long-row
instance (``test_torch_mask_rows.py``). The kernels themselves
run only on the card (``chip_smoke.py``). Everything is bool and must be
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
from blockpuzzle_tpu_torch.kernels import LegalityKernel, MaskKernel, _build
from blockpuzzle_tpu_torch.kernels.collision import (
    every_piece_shape, piece_rows_table, piece_table,
)
from blockpuzzle_tpu_torch.kernels.packed import (
    SMEM_OPT_IN, mask_block_warps, tall_smem_bytes, u8_launch_shape, xwide_smem_bytes,
)
from blockpuzzle_tpu_torch.utils.bounds import COSTS, bound
from test_torch_kernels import emulate_mask_wide_kernel, random_boards
from test_torch_tall import emulate_mask_deep_kernel, emulate_mask_tall_kernel
from test_torch_xwide import emulate_mask_xwide_kernel

# board -> (config, the kernel the wrapper picks): two to four words a row
# (8x33: one cell in the second word; 4x128 with pieces of at most 2x2,
# which fit its 4 rows), 3x3 regions and a hand of three (the legality reads
# no hand), a warp a board (33 rows), windows of 32 rows (130) and a segment
# of lanes a board (136 cells a row)
CASES = {"wide40": (dict(height=8, width=40), "wide"),
         "wide33": (dict(height=8, width=33), "wide"),
         "wide36r3": (dict(height=9, width=36, region_clear=True, region_size=3,
                           queue_size=3), "wide"),
         "wide128": (dict(height=4, width=128, piece_set="mini5"), "wide"),
         "33x9": (dict(height=33, width=9), "tall"),
         "130x8": (dict(height=130, width=8), "deep"),
         "8x136": (dict(height=8, width=136), "xwide")}
EMULATE = {"wide": emulate_mask_wide_kernel, "tall": emulate_mask_tall_kernel,
           "deep": emulate_mask_deep_kernel, "xwide": emulate_mask_xwide_kernel}
# more than one block on every board, the last one ragged
N = 12


def _pair(case):
    shape = CASES[case][0]
    return jcfg.EnvConfig(**shape), tcfg.EnvConfig(**shape)


def legality_boards(cfg, n, rng):
    """``random_boards`` at a low fill (full rows and columns, a row full
    but for its first cell), a full board (the last) and an empty one."""
    board = random_boards(cfg, n, rng, fill=0.25)
    board[n - 1], board[n - 2] = 1, 0
    return board


def emulate_legality_instance(cfg, board, lk, addr=0):
    """csrc/mask.cu's every-piece instance (``kEvery``) of the mask kernel
    ``lk`` picked: that kernel's emulation on ``cfg`` with S = P and a hand
    holding every piece in order, so that env-slot q = e P + p reads piece
    p = q mod P (``slot_piece``), with ``lk``'s rectangle piece table and
    launch shape.  Returns (N, P, HW) bool."""
    p, n = lk.num_pieces, len(board)
    every = dataclasses.replace(cfg, queue_size=p)
    hand = np.tile(np.arange(p, dtype=np.int32), (n, 1))
    return EMULATE[lk.kind](every, board, hand, lk, addr).reshape(n, p, cfg.num_cells)


@functools.cache
def jax_engine(case):
    return jax_make_env(_pair(case)[0], state_impl="u8")


@pytest.mark.parametrize("case", CASES)
def test_legality_instance_matches_jax_legality(case):
    """K4 beyond 32x32: the Pallas legality kernel in interpret mode, the
    JAX u8 engine's ``legal_all_pieces``, the wrapper (plain version on the
    CPU) and the every-piece instance's emulation, bit-equal; the full
    board has no legal anchor, the empty board's are every piece's
    in-bounds anchors (``valid``)."""
    cj, ct = _pair(case)
    board = legality_boards(ct, N, np.random.default_rng(31))
    want = np.asarray(jk.LegalityKernel(cj, tile_n=N, tile_a=2048)(
        jnp.asarray(board), interpret=True))
    engine = np.asarray(jax_engine(case).legal_all_pieces(jnp.asarray(board)))
    np.testing.assert_array_equal(engine, want)
    lk = LegalityKernel(ct, "cpu")
    kind = CASES[case][1]
    assert (lk.kind, lk.name) == (kind, f"legality_{kind}")
    np.testing.assert_array_equal(lk(torch.as_tensor(board)).numpy(), want)
    np.testing.assert_array_equal(emulate_legality_instance(ct, board, lk), want)
    assert not want[N - 1].any() and 0 < want.mean() < 1
    np.testing.assert_array_equal(want[N - 2].reshape(-1), rules.tables_for(ct).valid)
    assert lk.launches == getattr(lk, f"{kind}_launches") == lk.general_launches == 0


@pytest.mark.parametrize("case", ["wide40", "wide36r3", "33x9", "130x8", "8x136"])
@pytest.mark.parametrize("addr", [3, 13])
def test_legality_emulations_take_any_board_address(case, addr):
    """Boards that start off a 16-byte boundary: each instance's emulation
    stages the unaligned head and tail byte by byte (the block's span of
    envs starts at env first / P, its output span at env-slot first) and
    still equals the plain version."""
    _, ct = _pair(case)
    board = legality_boards(ct, N, np.random.default_rng(addr))
    lk = LegalityKernel(ct, "cpu")
    np.testing.assert_array_equal(emulate_legality_instance(ct, board, lk, addr),
                                  lk(torch.as_tensor(board)).numpy())


@pytest.mark.parametrize("case", CASES)
def test_every_piece_instance_equals_the_hand_mask_of_every_piece(case):
    """The wrapper's legality map is the hand mask (``MaskKernel`` on
    ``cfg`` with S = P, the plain versions) of a hand holding every piece in
    order: the identity the every-piece instances rest on."""
    _, ct = _pair(case)
    p = rules.tables_for(ct).num_pieces
    board = legality_boards(ct, N, np.random.default_rng(37))
    every = dataclasses.replace(ct, queue_size=p)
    hand = torch.as_tensor(np.tile(np.arange(p, dtype=np.int32), (N, 1)))
    mask = MaskKernel(every, "cpu")(torch.as_tensor(board), hand)
    legal = LegalityKernel(ct, "cpu")(torch.as_tensor(board))
    np.testing.assert_array_equal(mask.numpy(), legal.reshape(N, -1).numpy())


@pytest.mark.parametrize("case", CASES)
def test_legality_launch_shapes_are_the_masks_at_every_piece(case):
    """The instance's launch shape is the hand mask's at S = P
    (``every_piece_shape``): on the wide boards the fewest warps (at least
    4) whose output span is a multiple of 16 bytes, on the tall and deep
    ones a block whose shared memory fits what a block may opt in to, on
    8x136 the xwide shape; N * P stays under 2^31 at N = 49152; the table
    is the mask's rectangle table and the entry is bound."""
    _, ct = _pair(case)
    lk = LegalityKernel(ct, "cpu")
    p = lk.num_pieces
    every = dataclasses.replace(ct, queue_size=p)
    assert lk.shape == every_piece_shape(ct) == u8_launch_shape(every) is not None
    per_warp, warps = lk.shape
    if lk.kind == "wide":
        assert warps == mask_block_warps(ct.height, ct.width)
        assert warps * per_warp * ct.num_cells % 16 == 0
    elif lk.kind == "xwide":
        assert xwide_smem_bytes(every, per_warp * warps) <= 48 * 1024
    else:
        assert tall_smem_bytes(every, per_warp * warps) <= SMEM_OPT_IN
    assert 49152 * p < 2**31
    np.testing.assert_array_equal(lk.piece_table.numpy(), piece_rows_table(ct))
    assert "bp_" + lk.name in _build.SIGNATURES


def test_legality_keeps_the_general_kernel_beyond_the_instances():
    """Rows of more than 4096 cells (2x4128, 1x4128) keep the general
    legality, with the per-cell piece table; so would a deep board whose
    one-warp block passes what a block may opt in to (1000x128) and an
    xwide one whose one-warp block does (2000x1024), which no mask kernel
    takes at S = P (their tables, built by the wrapper, are not built here:
    they would take hundreds of GB); rows of 1025 to 4096 cells (2x1056,
    3x1030) take the xwide kernel's long-row instance, and boards of more
    than 32 rows of 129 to 1024 cells (33x129) the xwide instance, each the
    hand mask's kernel at S = P; the presets keep the bit-row kernel."""
    for cfg in (tcfg.EnvConfig(height=2, width=4128, piece_set="mini5"),
                tcfg.EnvConfig(height=1, width=4128, piece_set="mini5")):
        lk = LegalityKernel(cfg, "cpu")
        assert (lk.kind, lk.name, lk.shape) == ("general", "legality_general", None)
        assert every_piece_shape(cfg) is None
        np.testing.assert_array_equal(lk.piece_table.numpy(), piece_table(cfg))
    for cfg in (tcfg.EnvConfig(height=2, width=1056, piece_set="mini5"),
                tcfg.EnvConfig(height=3, width=1030, piece_set="mini5")):
        lk = LegalityKernel(cfg, "cpu")
        every = dataclasses.replace(cfg, queue_size=5)
        assert (lk.kind, lk.name) == ("xwide", "legality_xwide_long")
        assert lk.shape == every_piece_shape(cfg) == u8_launch_shape(every) == (1, 4)
        np.testing.assert_array_equal(lk.piece_table.numpy(), piece_rows_table(cfg))
    cfg = tcfg.EnvConfig(height=33, width=129, piece_set="mini5")
    every = dataclasses.replace(cfg, queue_size=5)
    lk = LegalityKernel(cfg, "cpu")
    assert (lk.kind, lk.name) == ("xwide", "legality_xwide")
    assert lk.shape == every_piece_shape(cfg) == u8_launch_shape(every) is not None
    assert u8_launch_shape(tcfg.EnvConfig(height=1000, width=128, queue_size=19)) is None
    assert u8_launch_shape(tcfg.EnvConfig(height=2000, width=1024, queue_size=19)) is None
    for preset in tcfg.PRESETS.values():
        assert LegalityKernel(preset(), "cpu").name == "legality"


@pytest.mark.parametrize("name, shape, mb, ms", [
    ("legality_wide", dict(height=8, width=40), 314.57, 0.093902),
    ("legality_tall", dict(height=33, width=9), 291.96, 0.087153),
    ("legality_deep", dict(height=130, width=8), 1022.36, 0.305183),
    ("legality_xwide", dict(height=8, width=136), 1069.55, 0.319268),
])
def test_legality_instance_bounds(name, shape, mb, ms):
    """The every-piece instances at N = 49152 move the general kernel's
    bytes (the board in, P * HW bools out) and are held to the function's
    least work, the count every K4 kernel shares (rows packed once an env,
    12512 operations an env on 8x40), not to the mask's count at S = P,
    which repacks the rows for each piece: each is bound by its bytes."""
    cfg, n = tcfg.EnvConfig(**shape), 49152
    p = rules.tables_for(cfg).num_pieces
    inputs = (torch.zeros(n, cfg.num_cells, dtype=torch.uint8),)
    outputs = (torch.zeros(n, p, cfg.num_cells, dtype=torch.bool),)
    nbytes, ops = COSTS[name](cfg, inputs, outputs)
    assert (nbytes, ops) == COSTS["legality_general"](cfg, inputs, outputs)
    assert round(nbytes / 1e6, 2) == mb
    every = dataclasses.replace(cfg, queue_size=p)
    mask = COSTS[name.replace("legality", "mask")](every, inputs + (None,), outputs)[1]
    assert ops < mask
    if name == "legality_wide":
        assert ops == 12512 * n
    b = bound(list(inputs) + list(outputs), ops)
    assert b["bound_by"] == "bytes" and round(b["bound_ms"], 6) == ms
