"""Canonical game rules data: piece library and precomputed placement tables.

A copy of ``blockpuzzle_tpu/rules.py`` (piece library, ``decompose_rects``,
``build_tables``, ``piece_plane_table``, ``tables_for``): the JAX package
imports gymnasium when it is imported, so the port keeps its own copy, and
``tests/test_torch_rules.py`` holds every table equal to the JAX package's.
Piece ordering is fixed and load-bearing — action ids and the oracle's deal
stream both depend on it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from blockpuzzle_tpu_torch.config import EnvConfig

# ---------------------------------------------------------------------------
# Piece libraries.  Each piece is a small binary grid (list of rows); the
# anchor used by the action encoding is the TOP-LEFT cell of this bounding
# box.  Order is canonical: do not reorder (action ids + parity depend on it).
# ---------------------------------------------------------------------------

_CLASSIC19: List[List[List[int]]] = [
    # 0: 1x1
    [[1]],
    # 1-4: horizontal bars 1x2 .. 1x5
    [[1, 1]],
    [[1, 1, 1]],
    [[1, 1, 1, 1]],
    [[1, 1, 1, 1, 1]],
    # 5-8: vertical bars 2x1 .. 5x1
    [[1], [1]],
    [[1], [1], [1]],
    [[1], [1], [1], [1]],
    [[1], [1], [1], [1], [1]],
    # 9: 2x2 square
    [[1, 1], [1, 1]],
    # 10: 3x3 square
    [[1, 1, 1], [1, 1, 1], [1, 1, 1]],
    # 11-14: small L (2x2 minus one corner), 4 orientations
    [[1, 1], [1, 0]],
    [[1, 1], [0, 1]],
    [[1, 0], [1, 1]],
    [[0, 1], [1, 1]],
    # 15-18: big L (3x3 corner, 5 cells), 4 orientations
    [[1, 1, 1], [1, 0, 0], [1, 0, 0]],
    [[1, 1, 1], [0, 0, 1], [0, 0, 1]],
    [[1, 0, 0], [1, 0, 0], [1, 1, 1]],
    [[0, 0, 1], [0, 0, 1], [1, 1, 1]],
]

# A tiny 5-piece set for fast unit tests and docs examples.
_MINI5: List[List[List[int]]] = [
    [[1]],
    [[1, 1]],
    [[1], [1]],
    [[1, 1], [1, 1]],
    [[1, 1], [1, 0]],
]

PIECE_SETS: Dict[str, List[List[List[int]]]] = {
    "classic19": _CLASSIC19,
    "mini5": _MINI5,
}


def decompose_rects(grid: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """Decompose a piece grid into ≤2 rectangles whose union is the piece.

    A footprint that is a union of two rectangles is materialized from
    broadcast row/col index compares (the engine's ``cover_row``).  Every
    piece in the classic 1010! set is 1 rect (bars, squares) or 2 rects
    (small/big L).  Returns [(dr, dc, h, w), ...].
    Raises ValueError if no ≤2-rect decomposition exists.
    """
    h, w = grid.shape
    cells = grid.astype(bool)
    rects = [
        (r, c, rh, rw)
        for r in range(h)
        for c in range(w)
        for rh in range(1, h - r + 1)
        for rw in range(1, w - c + 1)
    ]

    def cover_of(rect):
        r, c, rh, rw = rect
        m = np.zeros_like(cells)
        m[r : r + rh, c : c + rw] = True
        return m

    for r1 in rects:
        m1 = cover_of(r1)
        if (m1 == cells).all():
            return [r1]
    for i, r1 in enumerate(rects):
        m1 = cover_of(r1)
        if (m1 & ~cells).any():
            continue
        for r2 in rects[i + 1 :]:
            m2 = cover_of(r2)
            if (m2 & ~cells).any():
                continue
            if ((m1 | m2) == cells).all():
                return [r1, r2]
    raise ValueError("piece is not a union of ≤2 rectangles")


@dataclasses.dataclass(frozen=True)
class RuleTables:
    """Precomputed NumPy tables for one ``EnvConfig``.

    Attributes:
      num_pieces: P, number of pieces in the library.
      max_h, max_w: maximum piece bounding-box dims.
      pieces: (P, max_h, max_w) uint8 padded piece masks.
      piece_h, piece_w: (P,) int32 bounding-box dims.
      piece_cells: (P,) int32 cell counts.
      cover: (P * H * W, H * W) uint8 — row g = flattened footprint of
        placing piece ``g // (H*W)`` with top-left anchor at flat cell
        ``g % (H*W)``; all-zero for out-of-bounds anchors.
      valid: (P * H * W,) bool — in-bounds anchor mask.
      piece_rects: (P, 8) int32 — ≤2-rectangle decomposition per piece:
        (dr1, dc1, h1, w1, dr2, dc2, h2, w2); absent rect2 has h2 = w2 = 0.
      row_masks / col_masks / region_masks: (L, H*W) uint8 membership masks
        of each clearable line/region, used by the clear scan.
    """

    num_pieces: int
    max_h: int
    max_w: int
    pieces: np.ndarray
    piece_h: np.ndarray
    piece_w: np.ndarray
    piece_cells: np.ndarray
    cover: np.ndarray
    valid: np.ndarray
    piece_rects: np.ndarray
    row_masks: np.ndarray
    col_masks: np.ndarray
    region_masks: np.ndarray


def piece_grids(piece_set: str) -> List[np.ndarray]:
    """The raw (h, w) uint8 grids for a named piece library."""
    try:
        raw = PIECE_SETS[piece_set]
    except KeyError as e:
        raise ValueError(f"unknown piece set {piece_set!r}") from e
    return [np.asarray(g, dtype=np.uint8) for g in raw]


def build_tables(cfg: EnvConfig) -> RuleTables:
    """Build all placement/clear tables for ``cfg`` (pure NumPy, cached OK)."""
    grids = piece_grids(cfg.piece_set)
    num_pieces = len(grids)
    h, w = cfg.height, cfg.width
    ncells = h * w
    max_h = max(g.shape[0] for g in grids)
    max_w = max(g.shape[1] for g in grids)

    pieces = np.zeros((num_pieces, max_h, max_w), dtype=np.uint8)
    piece_h = np.zeros(num_pieces, dtype=np.int32)
    piece_w = np.zeros(num_pieces, dtype=np.int32)
    for p, g in enumerate(grids):
        # Every grid must be a MINIMAL bounding box (occupied cells in the
        # first/last row and column).  The shift mask impl derives legality
        # purely from occupied taps + ones-padding, so a piece declared
        # larger than its occupied bbox would make shift more permissive
        # than the valid-anchor table (silent shift/matmul/oracle desync).
        if not (g[0].any() and g[-1].any() and g[:, 0].any() and g[:, -1].any()):
            raise ValueError(
                f"piece {p} of set {cfg.piece_set!r} has a non-minimal "
                f"bounding box {g.shape}; trim empty border rows/cols"
            )
        pieces[p, : g.shape[0], : g.shape[1]] = g
        piece_h[p], piece_w[p] = g.shape
    piece_cells = pieces.reshape(num_pieces, -1).sum(axis=1).astype(np.int32)

    piece_rects = np.zeros((num_pieces, 8), dtype=np.int32)
    for p, g in enumerate(grids):
        rects = decompose_rects(g)
        for j, (dr, dc, rh, rw) in enumerate(rects):
            piece_rects[p, 4 * j : 4 * j + 4] = (dr, dc, rh, rw)

    cover = np.zeros((num_pieces * ncells, ncells), dtype=np.uint8)
    valid = np.zeros(num_pieces * ncells, dtype=bool)
    for p, g in enumerate(grids):
        ph, pw = g.shape
        for r in range(h - ph + 1):
            for c in range(w - pw + 1):
                board = np.zeros((h, w), dtype=np.uint8)
                board[r : r + ph, c : c + pw] = g
                idx = p * ncells + r * w + c
                cover[idx] = board.reshape(-1)
                valid[idx] = True

    row_masks = np.zeros((h, ncells), dtype=np.uint8)
    for r in range(h):
        m = np.zeros((h, w), dtype=np.uint8)
        m[r, :] = 1
        row_masks[r] = m.reshape(-1)
    col_masks = np.zeros((w, ncells), dtype=np.uint8)
    for c in range(w):
        m = np.zeros((h, w), dtype=np.uint8)
        m[:, c] = 1
        col_masks[c] = m.reshape(-1)

    if cfg.region_clear:
        rs = cfg.region_size
        nregions = (h // rs) * (w // rs)
        region_masks = np.zeros((nregions, ncells), dtype=np.uint8)
        k = 0
        for br in range(h // rs):
            for bc in range(w // rs):
                m = np.zeros((h, w), dtype=np.uint8)
                m[br * rs : (br + 1) * rs, bc * rs : (bc + 1) * rs] = 1
                region_masks[k] = m.reshape(-1)
                k += 1
    else:
        region_masks = np.zeros((0, ncells), dtype=np.uint8)

    return RuleTables(
        num_pieces=num_pieces,
        max_h=max_h,
        max_w=max_w,
        pieces=pieces,
        piece_h=piece_h,
        piece_w=piece_w,
        piece_cells=piece_cells,
        cover=cover,
        valid=valid,
        piece_rects=piece_rects,
        row_masks=row_masks,
        col_masks=col_masks,
        region_masks=region_masks,
    )


def piece_plane_table(cfg: EnvConfig) -> np.ndarray:
    """(P, H*W) uint8: each piece rendered at the board's top-left corner,
    the plane of a hand slot in the piece-plane observation
    (``EnvConfig.obs_planes``) and the network's ``queue_mode="planes"``."""
    grids = piece_grids(cfg.piece_set)
    table = np.zeros((len(grids), cfg.num_cells), dtype=np.uint8)
    for p, g in enumerate(grids):
        plane = np.zeros((cfg.height, cfg.width), dtype=np.uint8)
        plane[: g.shape[0], : g.shape[1]] = g
        table[p] = plane.reshape(-1)
    return table


_TABLE_CACHE: Dict[EnvConfig, RuleTables] = {}


def tables_for(cfg: EnvConfig) -> RuleTables:
    """Cached ``build_tables``; configs are frozen/hashable."""
    t = _TABLE_CACHE.get(cfg)
    if t is None:
        t = build_tables(cfg)
        _TABLE_CACHE[cfg] = t
    return t


def line_bonus(cfg: EnvConfig, k: int) -> float:
    """Simultaneous-clear bonus for k full rows+cols(+regions): 10, 30, 60…"""
    return cfg.line_base * k * (k + 1) / 2.0


def decode_action(cfg: EnvConfig, action: int) -> Tuple[int, int, int]:
    """Flat action id -> (slot, row, col); slot-major then row-major anchor."""
    slot, cell = divmod(int(action), cfg.num_cells)
    r, c = divmod(cell, cfg.width)
    return slot, r, c
