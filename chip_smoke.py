#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (blockpuzzle_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card (compute capability 9.0) and nvcc; builds the kernels
from ``blockpuzzle_tpu_torch/kernels/csrc`` on first use.  Phases, each of
which raises on failure (non-zero exit, no result line):

  0. card name and power limit, torch/CUDA versions, compute capability,
     kernel build time;
  1. each of the ten kernels against its plain torch version on the
     card, bit-equal, at N = 49152 and a ragged N = 49151: the bit-row u8
     kernels (mask, clear, apply, legality) and the packed kernels
     (packed_apply, packed_mask) on the default, tenten, woodoku and big
     presets, on boards holding full rows, columns and 3x3 regions; the
     packed kernels also against the u8 mask and apply kernels on the
     unpacked boards; the general u8 kernels (mask_general,
     clear_general, apply_general, legality_general) on a board of 8 rows
     of 40 cells, too wide for a row word; an illegal action on a board
     holding a full line through the u8 apply kernel of each board and the
     packed one; then each kernel's device time (CUDA events over 50
     launches queued behind a spin kernel, so the host's launch time does
     not enter) beside its bound and the plain version's time (50 calls
     made as the host goes), at N = 49152 on the default preset (the
     general kernels on the wide board);
  2. the whole rollout on CUDA and on CPU from one seed (N = 1024, 64
     steps, live deals, auto-reset) on the packed engine (every preset)
     and on the u8 apply-kernel (``backend="pallas"``) and clear-kernel
     (``backend="jnp"``) steps (every preset and the wide board, where
     the general mask, apply and clear run: the paths ``wide_u8_pallas``
     and ``wide_u8_jnp``, counters set to 0 before each and read after
     it): final states and summed rewards bit-equal across devices and
     across the engines, each kernel of an engine launched exactly once
     per step and its other kernel never; then ``legal_all_pieces`` on the
     final boards against its plain version and the hand mask (on the wide
     board the general legality: the path ``wide_legal_all_pieces``);
  3. the rollout paths: the rollout entry point at N = 49152 on the
     default preset, one warm-up chunk then 5 timed windows of 400 steps,
     on the default (packed) engine and on the apply-kernel step; then the
     inspection entry point ``legal_all_pieces`` on the packed engine's
     final boards.  The launch counters are set to 0 before each and read
     after each;
  4. the training paths: ``cli/train.py`` with the JAX CLI's default flags
     (PPO, conv torso, packed engine) on the default preset, N = 4096,
     T = 64, 3 updates, and with ``--torso mlp --state-impl u8`` (the u8
     clear-kernel step), 2 updates, each with the launch counters set to
     0 before it and read after it; then one rollout of each alone,
     timed; then a fresh network of each at the same widths on CUDA and
     its copy on the CPU over one minibatch of a CUDA rollout;
  5. the oracle parity harness (``cli/parity.py``) on the card: 8 seeded
     oracle episodes (up to 512 steps) replayed one by one and as one
     lockstep batch through the packed engine and the u8 engine on CUDA,
     on every preset, each bit-exact.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` is the count
on the path named in its ``path``; ``launches_by_path`` gives the count on
every path read.  The packed kernels have no Pallas source: their
``replaces`` names the JAX package's jnp code.  ``bound_ms`` is the larger
of the bytes the kernel must move (each input read once, each output
written once) over 3.35 TB/s and its integer operations on this run's
inputs over 67 T/s (the H100's CUDA-core rate); ``library_ms`` is null:
no single PyTorch call computes a legal mask, a place-and-clear or a
clear-scan.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_MAIN = 49152
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
CORE_OPS_PER_S = 67e12        # H100 SXM CUDA-core rate (float32 entry)
PARITY_SEEDS = 8
PACKED_PRESETS = ("default", "tenten", "woodoku", "big")
# a u8 board too wide for a row word: the general u8 kernels
WIDE = dict(height=8, width=40)
# kernel -> (source, the TPU kernel or jnp code it replaces, the path its
# launches are read from)
KERNEL_INFO = {
    "mask": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
             "blockpuzzle_tpu/kernels/mask.py:85", "rollout_pallas"),
    "mask_general": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
                     "blockpuzzle_tpu/kernels/mask.py:85", "wide_u8_pallas"),
    "apply": ("blockpuzzle_tpu_torch/kernels/csrc/collision.cu",
              "blockpuzzle_tpu/kernels/collision.py:164", "rollout_pallas"),
    "apply_general": ("blockpuzzle_tpu_torch/kernels/csrc/collision.cu",
                      "blockpuzzle_tpu/kernels/collision.py:164", "wide_u8_pallas"),
    "clear": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
              "blockpuzzle_tpu/kernels/clear.py:93", "train_u8"),
    "clear_general": ("blockpuzzle_tpu_torch/kernels/csrc/clear.cu",
                      "blockpuzzle_tpu/kernels/clear.py:93", "wide_u8_jnp"),
    "legality": ("blockpuzzle_tpu_torch/kernels/csrc/legality.cu",
                 "blockpuzzle_tpu/kernels/collision.py:50", "legal_all_pieces"),
    "legality_general": ("blockpuzzle_tpu_torch/kernels/csrc/legality.cu",
                         "blockpuzzle_tpu/kernels/collision.py:50",
                         "wide_legal_all_pieces"),
    "packed_apply": ("blockpuzzle_tpu_torch/kernels/csrc/packed_apply.cu",
                     "blockpuzzle_tpu/env/core.py:962", "rollout"),
    "packed_mask": ("blockpuzzle_tpu_torch/kernels/csrc/packed_mask.cu",
                    "blockpuzzle_tpu/env/core.py:489", "rollout"),
}
NO_PALLAS_SOURCE = ("packed_apply", "packed_mask")
# the JAX CLI's defaults: conv torso, --state-impl auto (packed)
TRAIN_ARGV = ["--preset", "default", "--num-envs", "4096", "--rollout-len",
              "64", "--epochs", "2", "--minibatches", "4", "--updates", "3",
              "--log-every", "1", "--seed", "0", "--device", "cuda"]
# the u8 clear-kernel step, with the mlp torso (later flags win)
TRAIN_U8_ARGV = TRAIN_ARGV + ["--updates", "2", "--torso", "mlp",
                              "--state-impl", "u8", "--mlp-width", "512"]


def kernel_counters(env) -> dict:
    """kernel -> (its wrapper on ``env``, the wrapper's counter of its
    launches); the packed wrappers are None on a board too wide for them."""
    return {"mask": (env.mask_kernel, "launches"),
            "mask_general": (env.mask_kernel, "general_launches"),
            "apply": (env.apply_kernel, "launches"),
            "apply_general": (env.apply_kernel, "general_launches"),
            "clear": (env.clear_kernel, "launches"),
            "clear_general": (env.clear_kernel, "general_launches"),
            "legality": (env.legal_kernel, "launches"),
            "legality_general": (env.legal_kernel, "general_launches"),
            "packed_apply": (env.packed_apply_kernel, "launches"),
            "packed_mask": (env.packed_mask_kernel, "launches")}


def zero_counts(env) -> None:
    for k, attr in kernel_counters(env).values():
        if k is not None:
            setattr(k, attr, 0)


def read_counts(env) -> dict:
    return {name: getattr(k, attr) if k is not None else 0
            for name, (k, attr) in kernel_counters(env).items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str):
    """``name: Used ... registers ...`` and spill lines of nvcc's ``-Xptxas
    -v`` output, each under its kernel's (mangled) entry name."""
    entry = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line or "spill" in line:
            yield f"{entry}: {line.strip()}"


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` (one kernel launch) over ``iters``
    back-to-back calls.

    A spin kernel (``torch.cuda._sleep``, ~20 ms) holds the card while the
    host queues the calls, so the launches run back to back and the host's
    issue time (Python checks, allocation, ctypes) does not enter.  The
    start event must still be pending once every call is queued, or this
    raises."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1 << 25)
    start.record()
    for _ in range(iters):
        fn()
    queued = not start.query()
    end.record()
    torch.cuda.synchronize()
    if not queued:
        raise RuntimeError("the host could not queue the timed calls ahead of the card")
    return start.elapsed_time(end) / iters


def host_paced_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` over ``iters`` calls issued as the host goes:
    events around the calls, no spin kernel ahead of them.  For the plain
    versions, whose tens of launches a call overflow the launch queue
    before 50 calls are queued."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(tensors, ops: float) -> dict:
    """The least time for a kernel that reads and writes ``tensors`` once
    each and does ``ops`` integer operations: the larger of the two."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / CORE_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "ops": ops}


def kernel_bounds(cfg, board, queue, cover, valid, words, attrs, r, c, outs) -> dict:
    """The bound of each kernel named in ``outs`` (its outputs) on these
    inputs.  Operations counted on this run's data: the bit-row mask (K1)
    packs each of an env-slot's H rows from (W + 6) // 4 32-bit words (7
    operations a word), ORs in the max_h rows below by shuffles (5
    operations a row), smears and shifts its two rectangles (10 each),
    masks the legal row (3) and spends one operation per output byte on
    the spread store; the bit-row clear (K3) packs its rows likewise, tests
    and clears each row word (about 8 operations; a band row 2 per region
    row and 3 per tile with regions) and spends one per output byte; the
    bit-row apply (K2) packs two words a row, tests, places and clears
    (about 12) and stores likewise; the bit-row legality (K4) packs each
    row once, builds its smears (3 operations for each of max_h * max_w
    shapes), spends about 15 a piece and one per output byte; the general
    mask and legality test a piece at one anchor with an AND and an OR per
    cell, the general clear and apply do about 3 and 5 operations a cell; a
    packed anchor row tests W - piece_w + 1 anchors with 3 operations per
    footprint word and builds its words with 2 per field (B7); B1 does
    about 10 a row word."""
    import numpy as np
    import torch

    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.kernels.packed import bitboard_tables

    t = rules.tables_for(cfg)
    n, hw, h, w = board.shape[0], cfg.num_cells, cfg.height, cfg.width
    slots = cfg.queue_size

    def per_piece(values, empty):
        return torch.as_tensor(np.append(values, empty), device=queue.device)

    pid = queue.clamp(0, t.num_pieces).long()
    in_hand = float(per_piece(t.piece_cells, 0)[pid].sum())
    pack = 7 * ((w + 6) // 4)
    anchors = float((w - per_piece(t.piece_w, w + 1)[pid] + 1).clamp_min(0).sum())
    rs = cfg.region_size
    regions = h * (2 * rs + 3 * (w // rs)) if cfg.region_clear else 0
    bb = bitboard_tables(cfg) if w <= 32 else None
    ops = {
        "mask": lambda: n * slots * (h * (pack + 5 * t.max_h + 23) + hw),
        "mask_general": lambda: 2 * in_hand * hw,
        "apply": lambda: n * (h * (2 * pack + 12) + regions + hw),
        "apply_general": lambda: 5 * n * hw,
        "clear": lambda: n * (h * (pack + 8) + regions + hw),
        "clear_general": lambda: 3 * n * hw,
        "legality": lambda: n * (h * (pack + 3 * t.max_h * t.max_w + 15 * t.num_pieces)
                                 + t.num_pieces * hw),
        "legality_general": lambda: 2 * n * float(t.piece_cells.sum()) * hw,
        "packed_apply": lambda: 10 * n * h,
        "packed_mask": lambda: h * bb.nwords * (3 * anchors + 2 * bb.fpw * n * slots),
    }
    inputs = {"mask": [board, queue], "mask_general": [board, queue],
              "apply": [board, cover, valid],
              "apply_general": [board, cover, valid], "clear": [board],
              "clear_general": [board], "legality": [board],
              "legality_general": [board],
              "packed_apply": [words, attrs, r, c, valid],
              "packed_mask": [words, queue]}
    return {k: bound(inputs[k] + list(out if isinstance(out, tuple) else (out,)),
                     float(ops[k]()))
            for k, out in outs.items()}


def chosen_action(cfg, g):
    """The packed apply kernel's view of (piece, anchor) table rows ``g``:
    attrs (n, 11) ``[h, w, cells, dr1, dc1, h1, w1, dr2, dc2, h2, w2]``,
    anchor row r and column c, as the engine's step derives them."""
    import numpy as np

    from blockpuzzle_tpu_torch import rules

    t = rules.tables_for(cfg)
    table = np.concatenate(
        [t.piece_h[:, None], t.piece_w[:, None], t.piece_cells[:, None],
         t.piece_rects], axis=1).astype(np.int32)
    pid, anchor = np.divmod(g, cfg.num_cells)
    r, c = np.divmod(anchor, cfg.width)
    return table[pid], r.astype(np.int32), c.astype(np.int32)


def kernel_inputs(cfg, n: int, seed: int):
    """Boards with some full lines, full 3x3 regions (cleared on woodoku)
    and near-full rows, hands with empty slots, and chosen actions that
    are legal, illegal, out of bounds, or complete a row, as numpy arrays:
    (board, queue, cover, valid) for the u8 kernels and (attrs, r, c) of
    the same actions for the packed apply kernel."""
    import numpy as np

    from blockpuzzle_tpu_torch import rules

    t = rules.tables_for(cfg)
    rs = np.random.default_rng(seed)
    hw = cfg.num_cells
    board = (rs.random((n, hw)) < 0.35).astype(np.uint8)
    grid = board.reshape(n, cfg.height, cfg.width)
    grid[0::7, 3, :] = 1                              # full rows
    grid[1::7, :, 5] = 1                              # full columns
    grid[2::7, 4, :] = 1                              # row 4 full but
    grid[2::7, 4, 0] = 0                              # its first cell
    grid[3::7, 0:3, 0:3] = 1                          # full 3x3 regions
    grid[4::7, 3:6, 3:6] = 1                          # a full region crossed
    grid[4::7, 4, :] = 1                              # by a full row
    queue = rs.integers(0, t.num_pieces + 1, (n, cfg.queue_size)).astype(np.int32)
    g = rs.integers(0, t.cover.shape[0], n)           # random (piece, anchor)
    g[2::7] = 4 * cfg.width                           # 1x1 at (4, 0): clears
    return (board, queue, t.cover[g], t.valid[g]) + chosen_action(cfg, g)


def illegal_on_full_line(cfg, n: int):
    """Every board holds a full row 0; the action (1x1 at (0, 0)) overlaps
    it, so it must leave the board untouched.  (board, cover, valid, attrs,
    r, c) as numpy arrays."""
    import numpy as np

    from blockpuzzle_tpu_torch import rules

    t = rules.tables_for(cfg)
    board = np.zeros((n, cfg.num_cells), np.uint8)
    board[:, : cfg.width] = 1
    g = np.zeros(n, int)
    return (board, t.cover[g], t.valid[g]) + chosen_action(cfg, g)


def max_abs_err(got, want) -> int:
    import torch

    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_equal(outs, refs, what: str, errs: dict, name: str) -> None:
    import torch

    for o, r in zip(outs, refs):
        errs[name] = max(errs[name], max_abs_err(o, r))
        if not torch.equal(o, r):
            raise AssertionError(f"{name} kernel != plain ({what})")


def phase1(card: str) -> dict:
    import torch

    from blockpuzzle_tpu_torch.config import PRESETS, EnvConfig
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel,
        PackedApplyKernel, PackedMaskKernel,
    )
    from blockpuzzle_tpu_torch.kernels.packed import pack_words, unpack_words

    dev = torch.device("cuda")
    errs = {name: 0 for name in KERNEL_INFO}
    times, bounds = {}, {}
    configs = {name: PRESETS[name]() for name in PACKED_PRESETS}
    configs["wide"] = EnvConfig(**WIDE)
    for name, cfg in configs.items():
        packed = name != "wide"
        mk, ak = MaskKernel(cfg, dev), ApplyKernel(cfg, dev)
        ck, lk = ClearScanKernel(cfg, dev), LegalityKernel(cfg, dev)
        # the wide board takes the general kernels
        mask_name, clear_name, apply_name, legal_name = (
            k if packed else f"{k}_general"
            for k in ("mask", "clear", "apply", "legality"))
        if [k.shape is None for k in (mk, ck, ak, lk)] != [not packed] * 4:
            raise AssertionError(f"{name}: the wrappers picked the wrong kernels")
        if packed:
            pak, pmk = PackedApplyKernel(cfg, dev), PackedMaskKernel(cfg, dev)
        for n in (N_MAIN, N_MAIN - 1):
            board, queue, cover, valid, attrs, r, c = (
                torch.as_tensor(x, device=dev)
                for x in kernel_inputs(cfg, n, seed=n)
            )
            what = f"{name}, N={n}"
            mask = mk(board, queue)
            check_equal([mask], [mk.plain(board, queue)], what, errs, mask_name)
            outs = ak(board, cover, valid)
            check_equal(outs, ak.plain(board, cover, valid), what, errs, apply_name)
            cleared = ck(board)
            check_equal(cleared, ck.plain(board), what, errs, clear_name)
            legal_all = lk(board)
            check_equal([legal_all], [lk.plain(board)], what, errs, legal_name)
            line = (f"[phase1] {what}: {mask_name} legal share "
                    f"{float(mask.float().mean()):.4f}, {clear_name} k "
                    f"{int(cleared[1].sum())}, {apply_name} legal {int(outs[2].sum())}, "
                    f"{legal_name} share {float(legal_all.float().mean()):.4f}: "
                    "u8 kernels == plain (bit-equal)")
            if packed:
                words = pack_words(board.view(n, cfg.height, cfg.width))
                pmask = pmk(words, queue)
                check_equal([pmask], [pmk.plain(words, queue)], what, errs,
                            "packed_mask")
                pouts = pak(words, attrs, r, c, valid)
                check_equal(pouts, pak.plain(words, attrs, r, c, valid), what, errs,
                            "packed_apply")
                # the packed kernels against the u8 ones on the unpacked boards
                if not torch.equal(pmask, mask):
                    raise AssertionError(f"packed_mask != mask kernel ({what})")
                unpacked = unpack_words(pouts[0], cfg.width).view(n, -1)
                if not all(torch.equal(a, b) for a, b in
                           zip((unpacked,) + pouts[1:], outs)):
                    raise AssertionError(f"packed_apply != apply kernel ({what})")
                line += (f"; packed mask legal share {float(pmask.float().mean()):.4f},"
                         f" packed apply legal {int(pouts[2].sum())}, lines cleared "
                         f"{int(pouts[1].sum())}: packed kernels == plain == u8 "
                         "kernels on the unpacked boards (bit-equal)")
            print(line)
            b2, c2, v2, a2, r2, col2 = (
                torch.as_tensor(x, device=dev) for x in illegal_on_full_line(cfg, n)
            )
            noops = [ak(b2, c2, v2) + (b2,)]
            if packed:
                w2 = pack_words(b2.view(n, cfg.height, cfg.width))
                noops.append(pak(w2, a2, r2, col2, v2) + (w2,))
            for nb, k2, l2, before in noops:
                if bool(l2.any()) or int(k2.sum()) or not torch.equal(nb, before):
                    raise AssertionError(f"illegal action changed a board ({name})")
        if name not in ("default", "wide"):
            continue
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev)
            for x in kernel_inputs(cfg, N_MAIN, seed=0)
        )
        calls = {mask_name: (lambda: mk(board, queue), lambda: mk.plain(board, queue)),
                 clear_name: (lambda: ck(board), lambda: ck.plain(board)),
                 apply_name: (lambda: ak(board, cover, valid),
                              lambda: ak.plain(board, cover, valid)),
                 legal_name: (lambda: lk(board), lambda: lk.plain(board))}
        words = None
        if name == "default":
            words = pack_words(board.view(N_MAIN, cfg.height, cfg.width))
            args = (words, attrs, r, c, valid)
            calls.update({
                "packed_apply": (lambda: pak(*args), lambda: pak.plain(*args)),
                "packed_mask": (lambda: pmk(words, queue),
                                lambda: pmk.plain(words, queue)),
            })
        bounds.update(kernel_bounds(cfg, board, queue, cover, valid, words, attrs,
                                    r, c, {k: f() for k, (f, _) in calls.items()}))
        times.update({k: (cuda_ms(f), host_paced_ms(g)) for k, (f, g) in calls.items()})
    for k, (ms, plain_ms) in times.items():
        b = bounds[k]
        where = "wide 8x40" if k.endswith("_general") else "default"
        print(f"[phase1] {k} N={N_MAIN} {where}: kernel {ms:.6f} ms, plain "
              f"{plain_ms:.6f} ms, bound {b['bound_ms']:.6f} ms by {b['bound_by']} "
              f"({b['bytes']} B, {b['ops']:.0f} ops), {100 * b['bound_ms'] / ms:.1f}% "
              f"of it ({card})")
    print("[phase1] illegal action on a full-line board: strict no-op (apply, "
          "apply_general, packed_apply)")
    return {k: {"max_abs_err": errs[k], "ms": times[k][0], "plain_ms": times[k][1],
                "bound_ms": bounds[k]["bound_ms"], "bound_by": bounds[k]["bound_by"],
                "library_ms": None} for k in errs}


def hand_rows(legal_all, queue):
    """The (N, S*HW) hand mask read off the (N, P, HW) legality map (an
    all-False row for the empty sentinel)."""
    import torch

    n, num_pieces, hw = legal_all.shape
    padded = torch.cat([legal_all, legal_all.new_zeros(n, 1, hw)], dim=1)
    pid = queue.clamp(0, num_pieces).to(torch.int64)
    return padded.gather(1, pid[:, :, None].expand(-1, -1, hw)).reshape(n, -1)


def phase2():
    """Returns the maximum absolute error of ``legal_all_pieces`` against
    its plain version on the presets and on the wide board, and the launch
    counts of the wide board's two u8 rollouts and of ``legal_all_pieces``
    there (the paths ``wide_u8_pallas``, ``wide_u8_jnp`` and
    ``wide_legal_all_pieces``)."""
    import torch

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

    n, steps = 1024, 64
    fields = ("queue", "base_key", "rng_counter", "steps", "score", "streak")
    zero = dict.fromkeys(KERNEL_INFO, 0)
    # engine -> (make_env arguments, kernels launched once per step: on the
    # presets, on the wide board)
    engines = {"packed": (dict(backend="jnp", state_impl="packed"),
                          ("packed_mask", "packed_apply"), None),
               "pallas": (dict(backend="pallas", state_impl="u8"),
                          ("mask", "apply"), ("mask_general", "apply_general")),
               "jnp": (dict(backend="jnp", state_impl="u8"), ("mask", "clear"),
                       ("mask_general", "clear_general"))}
    configs = {name: PRESETS[name]() for name in PACKED_PRESETS}
    configs["wide"] = EnvConfig(**WIDE)
    errs, paths = {"legality": 0, "legality_general": 0}, {}
    for name, cfg in configs.items():
        wide = name == "wide"
        finals, boards, rewards, envs = {}, {}, {}, {}
        run = ("pallas", "jnp") if wide else ("packed", "pallas", "jnp")
        for engine in run:
            kwargs, per_step = engines[engine][0], engines[engine][1 + wide]
            for dev in ("cuda", "cpu"):
                env = make_env(cfg, device=dev, **kwargs)
                zero_counts(env)
                state, ts = env.init(7, n)
                sampler = UniformLegalSampler(8, n, env.device)
                total = torch.zeros((), dtype=torch.float64, device=env.device)
                for _ in range(steps):
                    state, ts = env.step(state, sampler(ts.action_mask))
                    total = total + ts.reward.sum(dtype=torch.float64)
                if dev == "cuda":
                    counts, expect = read_counts(env), {**zero, **dict.fromkeys(per_step, steps)}
                    if counts != expect:
                        raise AssertionError(
                            f"{name} {engine} launch counts {counts} != {expect}")
                    if wide:
                        paths[f"wide_u8_{engine}"] = counts
                    envs[engine] = (env, state)
                finals[engine, dev] = state.to("cpu")
                boards[engine, dev] = env.board_obs(state.board).cpu()
                rewards[engine, dev] = float(total)
        pairs = [((e, "cuda"), (e, "cpu")) for e in run]
        pairs += [((run[0], "cuda"), (e, "cuda")) for e in run[1:]]
        for a, b in pairs:
            same = torch.equal(boards[a], boards[b]) and all(
                torch.equal(getattr(finals[a], f), getattr(finals[b], f))
                for f in fields)
            if not same:
                raise AssertionError(f"{name}: final states differ {a} vs {b}")
            if rewards[a] != rewards[b]:
                raise AssertionError(f"{name}: summed rewards differ {a} vs {b}")
        print(f"[phase2] {name} {cfg.height}x{cfg.width} N={n} {steps} steps: "
              f"{', '.join(run)} engines, each CUDA == CPU, and {run[0]} CUDA == "
              f"every other engine on CUDA (final states bit-equal), summed reward "
              f"{rewards[run[0], 'cuda']}, launches per step "
              + "; ".join(f"{e}: " + " ".join(f"{k}=1" for k in engines[e][1 + wide])
                          for e in run))
        legal_name = "legality_general" if wide else "legality"
        for engine in run:
            env, state = envs[engine]
            zero_counts(env)
            legal_all = env.legal_all_pieces(state.board)
            counts = read_counts(env)
            if counts != {**zero, legal_name: 1}:
                raise AssertionError(f"{name} legal_all_pieces launches {counts}")
            if wide:
                paths["wide_legal_all_pieces"] = counts
            plain = env.legal_kernel.plain(
                env.board_obs(state.board).reshape(n, -1).contiguous())
            errs[legal_name] = max(errs[legal_name], max_abs_err(legal_all, plain))
            if not torch.equal(legal_all, plain):
                raise AssertionError(f"{name}: legal_all_pieces != plain ({engine})")
            if not torch.equal(hand_rows(legal_all, state.queue),
                               env.action_mask(state.board, state.queue)):
                raise AssertionError(
                    f"{name}: legal_all_pieces hand rows != action_mask ({engine})")
        print(f"[phase2] {name}: legal_all_pieces on the final boards == plain, "
              f"hand rows == action_mask ({legal_name} launched once a call)")
    return errs, paths


def phase3(card: str) -> dict:
    """Returns the launch counts of the two rollout paths (``rollout``: the
    default, packed engine; ``rollout_pallas``: the u8 apply-kernel step)
    and of the ``legal_all_pieces`` entry point."""
    import torch

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.cli.rollout import rollout

    chunk, windows = 400, 5
    steps = (windows + 1) * chunk
    zero = dict.fromkeys(KERNEL_INFO, 0)
    paths = {}
    for path, kwargs, per_step in (
            ("rollout", {}, ("packed_mask", "packed_apply")),
            ("rollout_pallas", {"backend": "pallas"}, ("mask", "apply"))):
        env = make_env(PRESETS["default"](), device="cuda", **kwargs)
        zero_counts(env)
        r = rollout(env, N_MAIN, chunk, windows, seed=0)
        paths[path] = read_counts(env)
        expect = {**zero, **dict.fromkeys(per_step, steps)}
        if paths[path] != expect:
            raise AssertionError(f"{path} path launches {paths[path]} != {expect}")
        s = r["state"]
        cells = env.board_obs(s.board)
        if cells.shape != (N_MAIN, env.cfg.height, env.cfg.width) or int(cells.max()) > 1:
            raise AssertionError("final boards malformed")
        if int(s.queue.min()) < 0 or int(s.queue.max()) > env.num_pieces:
            raise AssertionError("final queues out of range")
        if not bool(torch.isfinite(s.score).all()):
            raise AssertionError("non-finite scores")
        mean_return = r["episode_return"] / max(r["episodes"], 1)
        # uniform-legal play on the default preset returns ~78 per episode
        if r["episodes"] == 0 or not 60.0 < mean_return < 100.0:
            raise AssertionError(f"implausible episodes: {r['episodes']}, "
                                 f"mean return {mean_return}")
        rates = r["rates"]
        print(f"[phase3] {path} ({env.state_impl}, backend {env.backend}) "
              f"default N={N_MAIN}: windows of {chunk} steps (env-steps/s) "
              f"{[round(x) for x in rates]}")
        print(f"[phase3] {path} median {statistics.median(rates):.1f} "
              f"env-steps/s ({card}); episodes {r['episodes']}, mean return "
              f"{mean_return:.3f}; launches {paths[path]}")
        if path == "rollout":
            packed_env, final = env, s
    zero_counts(packed_env)
    legal_all = packed_env.legal_all_pieces(final.board)
    paths["legal_all_pieces"] = read_counts(packed_env)
    expect = {**zero, "legality": 1}
    if paths["legal_all_pieces"] != expect:
        raise AssertionError(
            f"legal_all_pieces launches {paths['legal_all_pieces']} != {expect}")
    if not torch.equal(hand_rows(legal_all, final.queue),
                       packed_env.packed_mask_kernel.plain(final.board, final.queue)):
        raise AssertionError("legal_all_pieces hand rows != the hand mask")
    print(f"[phase3] legal_all_pieces on the packed rollout's final boards: "
          f"launches {paths['legal_all_pieces']}, hand rows == the hand mask")
    return paths


def learner_cuda_vs_cpu(learner, state) -> None:
    """A fresh network at the path's widths on CUDA and its copy on the
    CPU, over one minibatch of a CUDA rollout, with the tolerances of
    ``tests/test_torch_ppo.py``: logits and values within abs 2e-2
    (masked logits exactly ``NEG_INF``), the loss and its metrics within
    1e-2 relative, each gradient within 2e-2 relative L2."""
    import copy
    import dataclasses

    import torch

    from blockpuzzle_tpu_torch.learn.networks import NEG_INF

    cfg = learner.cfg
    net = learner.make_net(torch.Generator().manual_seed(1))
    cpu_net = copy.deepcopy(net).cpu()
    _, batch, last_value, _ = learner._rollout(state.replace(net=net))
    adv, ret = (x.flatten() for x in learner._gae(batch, last_value))
    rows = cfg.num_envs * cfg.rollout_len // cfg.num_minibatches
    mb = batch.map(lambda x: x.flatten(0, 1)[:rows])
    # old log-probs moved off the network's, so that the ratios are not 1
    dev = learner.env.device
    gen = torch.Generator(device=dev).manual_seed(2)
    noise = torch.randn(rows, generator=gen, device=dev)
    mb = dataclasses.replace(mb, log_prob=mb.log_prob + 0.1 * noise)
    outs = []
    for m, dev in ((net, dev), (cpu_net, "cpu")):
        b = mb.map(lambda x: x.to(dev))
        with torch.no_grad():
            logits, value = m(b.board, b.queue, b.action_mask)
        m.zero_grad(set_to_none=True)
        loss, metrics = learner._loss(m, b, adv[:rows].to(dev), ret[:rows].to(dev))
        loss.backward()
        outs.append((logits.cpu(), value.cpu(),
                     {k: float(v) for k, v in metrics.items()},
                     {n: p.grad.cpu() for n, p in m.named_parameters()}))
    (lg, vg, mg, gg), (lc, vc, mc, gc) = outs
    legal = mb.action_mask.cpu()
    if not bool((lg[~legal] == NEG_INF).all() and (lc[~legal] == NEG_INF).all()):
        raise AssertionError("masked logits are not NEG_INF")
    logit_err = float((lg[legal] - lc[legal]).abs().max())
    value_err = float((vg - vc).abs().max())
    metric_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
    grad_err, worst = max(
        (float((gg[n] - gc[n]).norm() / gc[n].norm().clamp_min(1e-12)), n)
        for n in gc)
    print(f"[phase4] fresh {cfg.torso}/{cfg.queue_mode} network, CUDA vs CPU, "
          f"one minibatch of {rows} rows: "
          f"logits max abs err {logit_err:.3e}, values {value_err:.3e}, loss "
          f"metrics max rel err {metric_err:.3e}, gradients max rel L2 err "
          f"{grad_err:.3e} ({worst}) (limits 2e-2, 2e-2, 1e-2, 2e-2)")
    if logit_err > 2e-2 or value_err > 2e-2:
        raise AssertionError("learner logits or values: CUDA != CPU")
    for k in mc:
        if abs(mg[k] - mc[k]) > 1e-6 + 1e-2 * abs(mc[k]):
            raise AssertionError(f"learner {k}: CUDA {mg[k]} != CPU {mc[k]}")
    if grad_err > 2e-2:
        raise AssertionError("learner gradients: CUDA != CPU")


def phase4(card: str) -> dict:
    """Returns the launch counts of the two training paths (``train``: the
    JAX CLI's defaults, conv torso on the packed engine; ``train_u8``: the
    mlp torso on the u8 clear-kernel step)."""
    return {"train": train_path(card, TRAIN_ARGV, ("packed_mask", "packed_apply")),
            "train_u8": train_path(card, TRAIN_U8_ARGV, ("mask", "clear"))}


def train_path(card: str, argv, kernels) -> dict:
    """``cli/train.py`` with ``argv``; ``kernels`` are the engine's mask
    and apply kernels, launched T + 1 and T times per update."""
    import math

    import torch

    from blockpuzzle_tpu_torch.cli import train

    args = train.build_parser().parse_args(argv)
    learner = train.build(args)
    env = learner.env
    zero_counts(env)
    r = train.train(args, learner)
    launches = read_counts(env)
    t = args.rollout_len
    mask_kernel, apply_kernel = kernels
    expect = {**dict.fromkeys(KERNEL_INFO, 0), mask_kernel: args.updates * (t + 1),
              apply_kernel: args.updates * t}
    if launches != expect:
        raise AssertionError(f"training path launches {launches} != {expect}")
    m = r["metrics"]
    for k in ("loss", "policy_loss", "value_loss", "entropy", "episode_return"):
        if not math.isfinite(m[k]):
            raise AssertionError(f"training metric {k} = {m[k]}")
    if m["illegal_action_rate"] != 0.0 or m["episodes_finished"] == 0:
        raise AssertionError(f"implausible training rollout: {m}")
    if r["state"].update_count != args.updates:
        raise AssertionError("update count")
    sps = r["env_steps_per_s"]
    update_ms = 1e3 * args.num_envs * t / sps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner._rollout(r["state"])
    torch.cuda.synchronize()
    rollout_ms = 1e3 * (time.perf_counter() - t0)
    width = (f"channels {learner.cfg.channels}" if args.torso == "conv"
             else f"mlp_width {args.mlp_width}")
    print(f"[phase4] PPO default, {args.torso} torso ({width}, hidden "
          f"{learner.cfg.hidden}), {env.state_impl} engine, N={args.num_envs} "
          f"T={t}: {args.updates} updates, last loss {m['loss']:.6f}, "
          f"return {m['episode_return']:.3f}, entropy {m['entropy']:.4f}; "
          f"launches {launches}")
    print(f"[phase4] {sps:.1f} env-steps/s of training over updates 2-"
          f"{args.updates}, {update_ms:.3f} ms per update, of which a rollout "
          f"alone takes {rollout_ms:.3f} ms ({card})")
    learner_cuda_vs_cpu(learner, r["state"])
    return launches


def phase5() -> None:
    """The oracle parity harness on the card: ``check_seed`` for each seed
    and ``check_batched_lockstep`` over all of them, through the packed
    and the u8 engine on CUDA, on every preset; any mismatch raises."""
    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.cli import parity

    seeds = list(range(PARITY_SEEDS))
    for name in PACKED_PRESETS:
        cfg = PRESETS[name]()
        for state_impl in ("packed", "u8"):
            env = make_env(cfg, device="cuda", state_impl=state_impl)
            steps = 0
            for seed in seeds:
                r = parity.check_seed(cfg, seed, 512, env=env)
                if r["mismatches"] or r["oracle_return"] != r["device_return"]:
                    raise AssertionError(f"parity {name} {state_impl} seed {seed}: {r}")
                steps += r["steps"]
            b = parity.check_batched_lockstep(cfg, env, seeds, 512)
            if b["mismatches"] or not b["returns_equal"]:
                raise AssertionError(f"lockstep parity {name} {state_impl}: {b}")
            print(f"[phase5] {name}, {state_impl} engine on {env.device}: "
                  f"{len(seeds)} oracle episodes ({steps} steps) bit-exact one by "
                  "one and as one lockstep batch")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from blockpuzzle_tpu_torch.kernels import _build

    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    print(card)
    print(f"[phase0] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, compute capability {cap[0]}.{cap[1]}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0, got {cap}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[phase0] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")
    for line in ptxas_lines(_build.library_path().with_suffix(".log").read_text()):
        print(f"[phase0] ptxas: {line}")

    measured = phase1(card)
    legal_errs, wide_paths = phase2()
    for k, err in legal_errs.items():
        measured[k]["max_abs_err"] = max(measured[k]["max_abs_err"], err)
    paths = {**phase3(card), **phase4(card), **wide_paths}
    phase5()

    kernels = []
    for name, (source, replaces, path) in KERNEL_INFO.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "pallas_source": name not in NO_PALLAS_SOURCE,
                        "path": path, "launches": paths[path][name],
                        "launches_by_path": {p: c[name] for p, c in paths.items()},
                        **measured[name]})
    print(f"[done] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
