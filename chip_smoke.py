#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (blockpuzzle_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card (compute capability 9.0) and nvcc; builds the kernels
from ``blockpuzzle_tpu_torch/kernels/csrc`` on first use.  Phases, each of
which raises on failure (non-zero exit, no result line):

  0. card name and power limit, torch/CUDA versions, compute capability,
     kernel build time;
  1. each kernel against its plain torch version on the card, bit-equal,
     at N = 49152 and a ragged N = 49151 on the default, tenten and woodoku
     presets, plus an illegal action on a board holding a full line; then
     each kernel's time beside the plain version's (CUDA events);
  2. the whole rollout on CUDA and on CPU from one seed (N = 1024, 64
     steps, live deals, auto-reset): final states and summed rewards
     bit-equal, each kernel launched exactly once per step;
  3. the main path: the rollout entry point at N = 49152 on the default
     preset, one warm-up chunk then 5 timed windows of 400 steps, with the
     launch counters set to 0 before it and read after it.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_MAIN = 49152
PRESETS_CHECKED = ("default", "tenten", "woodoku")
KERNEL_INFO = {
    "mask": ("blockpuzzle_tpu_torch/kernels/csrc/mask.cu",
             "blockpuzzle_tpu/kernels/mask.py:84"),
    "apply": ("blockpuzzle_tpu_torch/kernels/csrc/collision.cu",
              "blockpuzzle_tpu/kernels/collision.py:163"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def kernel_inputs(cfg, n: int, seed: int):
    """Boards with some full lines and near-full rows, hands with empty
    slots, and chosen footprints that are legal, illegal, out of bounds,
    or complete a row, as numpy arrays."""
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
    queue = rs.integers(0, t.num_pieces + 1, (n, cfg.queue_size)).astype(np.int32)
    g = rs.integers(0, t.cover.shape[0], n)           # random (piece, anchor)
    g[2::7] = 4 * cfg.width                           # 1x1 at (4, 0): clears
    cover = t.cover[g]
    valid = t.valid[g]
    return board, queue, cover, valid


def illegal_on_full_line(cfg, n: int):
    """Every board holds a full row 0; the action (1x1 at (0, 0)) overlaps
    it, so it must leave the board untouched."""
    import numpy as np

    from blockpuzzle_tpu_torch import rules

    t = rules.tables_for(cfg)
    board = np.zeros((n, cfg.num_cells), np.uint8)
    board[:, : cfg.width] = 1
    return board, t.cover[np.zeros(n, int)], t.valid[np.zeros(n, int)]


def max_abs_err(got, want) -> int:
    import torch

    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def phase1(card: str) -> dict:
    import torch

    from blockpuzzle_tpu_torch.config import PRESETS
    from blockpuzzle_tpu_torch.kernels import ApplyKernel, MaskKernel

    dev = torch.device("cuda")
    errs = {"mask": 0, "apply": 0}
    times = {}
    for name in PRESETS_CHECKED:
        cfg = PRESETS[name]()
        mk, ak = MaskKernel(cfg, dev), ApplyKernel(cfg, dev)
        for n in (N_MAIN, N_MAIN - 1):
            board, queue, cover, valid = (
                torch.as_tensor(x, device=dev)
                for x in kernel_inputs(cfg, n, seed=n)
            )
            got, want = mk(board, queue), mk.plain(board, queue)
            errs["mask"] = max(errs["mask"], max_abs_err(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"mask kernel != plain ({name}, N={n})")
            outs, refs = ak(board, cover, valid), ak.plain(board, cover, valid)
            for o, r, what in zip(outs, refs, ("board", "k", "legal")):
                errs["apply"] = max(errs["apply"], max_abs_err(o, r))
                if not torch.equal(o, r):
                    raise AssertionError(
                        f"apply kernel {what} != plain ({name}, N={n})"
                    )
            legal = outs[2]
            print(f"[phase1] {name} N={n}: mask legal share "
                  f"{float(got.float().mean()):.4f}, apply legal "
                  f"{int(legal.sum())}, lines cleared {int(outs[1].sum())}: "
                  "kernel == plain (bit-equal)")
            b2, c2, v2 = (
                torch.as_tensor(x, device=dev) for x in illegal_on_full_line(cfg, n)
            )
            nb, k2, l2 = ak(b2, c2, v2)
            if bool(l2.any()) or int(k2.sum()) or not torch.equal(nb, b2):
                raise AssertionError(f"illegal action changed a board ({name})")
        if name == "default":
            board, queue, cover, valid = (
                torch.as_tensor(x, device=dev)
                for x in kernel_inputs(cfg, N_MAIN, seed=0)
            )
            times["mask"] = (cuda_ms(lambda: mk(board, queue)),
                             cuda_ms(lambda: mk.plain(board, queue)))
            times["apply"] = (cuda_ms(lambda: ak(board, cover, valid)),
                              cuda_ms(lambda: ak.plain(board, cover, valid)))
    for k, (ms, plain_ms) in times.items():
        print(f"[phase1] {k} N={N_MAIN} default: kernel {ms:.6f} ms, plain "
              f"{plain_ms:.6f} ms ({card})")
    print("[phase1] illegal action on a full-line board: strict no-op")
    return {k: {"max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in errs}


def phase2() -> None:
    import torch

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

    n, steps = 1024, 64
    for name in PRESETS_CHECKED:
        finals, rewards = {}, {}
        for dev in ("cuda", "cpu"):
            env = make_env(PRESETS[name](), device=dev)
            state, ts = env.init(7, n)
            sampler = UniformLegalSampler(8, n, env.device)
            total = torch.zeros((), dtype=torch.float64, device=env.device)
            for _ in range(steps):
                state, ts = env.step(state, sampler(ts.action_mask))
                total = total + ts.reward.sum(dtype=torch.float64)
            if dev == "cuda":
                counts = (env.mask_kernel.launches, env.apply_kernel.launches)
                if counts != (steps, steps):
                    raise AssertionError(f"launch counts {counts} != {steps}")
            finals[dev] = state.to("cpu")
            rewards[dev] = float(total)
        for field in ("board", "queue", "base_key", "rng_counter", "steps",
                      "score", "streak"):
            a, b = getattr(finals["cuda"], field), getattr(finals["cpu"], field)
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: final {field} differs CUDA vs CPU")
        if rewards["cuda"] != rewards["cpu"]:
            raise AssertionError(f"{name}: summed rewards differ {rewards}")
        print(f"[phase2] {name} N={n} {steps} steps: CUDA == CPU final state "
              f"(bit-equal), summed reward {rewards['cuda']}, launches "
              f"mask={steps} apply={steps}")


def phase3(card: str) -> dict:
    import torch

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.cli.rollout import rollout

    env = make_env(PRESETS["default"](), device="cuda")
    kernels = {"mask": env.mask_kernel, "apply": env.apply_kernel}
    for k in kernels.values():
        k.launches = 0
    chunk, windows = 400, 5
    r = rollout(env, N_MAIN, chunk, windows, seed=0)
    launches = {name: k.launches for name, k in kernels.items()}
    expect = (windows + 1) * chunk
    for name, count in launches.items():
        if count != expect:
            raise AssertionError(f"{name} launched {count} times, expected {expect}")
    s = r["state"]
    num_pieces = env.num_pieces
    if s.board.shape != (N_MAIN, env.cfg.num_cells) or int(s.board.max()) > 1:
        raise AssertionError("final boards malformed")
    if int(s.queue.min()) < 0 or int(s.queue.max()) > num_pieces:
        raise AssertionError("final queues out of range")
    if not bool(torch.isfinite(s.score).all()):
        raise AssertionError("non-finite scores")
    mean_return = r["episode_return"] / max(r["episodes"], 1)
    # uniform-legal play on the default preset returns ~78 per episode
    if r["episodes"] == 0 or not 60.0 < mean_return < 100.0:
        raise AssertionError(f"implausible episodes: {r['episodes']}, "
                             f"mean return {mean_return}")
    rates = r["rates"]
    print(f"[phase3] default N={N_MAIN}: windows of {chunk} steps (env-steps/s) "
          f"{[round(x) for x in rates]}")
    print(f"[phase3] median {statistics.median(rates):.1f} env-steps/s "
          f"({card}); episodes {r['episodes']}, mean return {mean_return:.3f}; "
          f"launches {launches}")
    return launches


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
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(f"[phase0] ptxas: {line.strip()}")

    measured = phase1(card)
    phase2()
    launches = phase3(card)

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **measured[name]})
    print(f"[done] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
