#!/usr/bin/env python3
"""Measurements of the PyTorch + CUDA port on one card, beyond the smoke run.

    python3 chip_measure.py [--parts build,train,rollout,kernels]
                            [--parent-csrc DIR]

Needs one CUDA card and nvcc.  Prints the card's name and power limit,
then, each line tagged with its part (all four by default):

  build     cold builds of ``kernels/csrc/*.cu`` in turns: one nvcc over
            all sources, then one nvcc per source started together and a
            link (``_build.build``), then the same two in reverse order;
  train     for each training path of ``chip_smoke.py`` (the JAX CLI's
            defaults: conv torso, packed engine; then mlp torso, u8
            clear-kernel step; default preset, N = 4096, T = 64), one PPO
            update on the host's clock, twice: the update, a rollout alone
            and GAE alone; then one update under ``torch.profiler``:
            device kernels, device time, the device's busy share of an
            unprofiled update, and the largest device items;
  rollout   for each engine (packed, u8 apply-kernel step, u8
            clear-kernel step) at N = 49152 on the default preset: host
            ms per step, then 20 steps under ``torch.profiler`` (kernels,
            device time and busy share per step, the largest items and
            each hand kernel's time inside the step); then
            the rollout entry point on each engine, in turns packed,
            u8-pallas, u8-jnp, u8-jnp, u8-pallas, packed (median of 3
            windows of 200 steps each);
  kernels   at N = 49152 on every packed preset: the u8 mask, clear, apply
            and legality (the bit-row kernels) and the packed apply and
            mask, device times (``chip_smoke.cuda_ms``) and host-paced
            times (events around calls made as the host goes).  With
            ``--parent-csrc DIR`` (a directory holding earlier ``*.cu`` and
            ``*.cuh`` sources, e.g. an earlier commit's
            ``blockpuzzle_tpu_torch/kernels/csrc`` from ``git archive``,
            whose entry points ``bp_mask``, ``bp_clear``, ``bp_apply``,
            ``bp_legality``, ``bp_packed_apply`` and ``bp_packed_mask``
            take the arguments ``_build.SIGNATURES`` gives them; where it
            also has ``bp_mask_rows`` and ``bp_clear_rows``, the u8 mask
            and clear go through those), those are built into a library of
            their own by one nvcc, their ptxas lines printed, their outputs
            held bit-equal to the current kernels', and both timed in
            turns: earlier, current, current, earlier.

Cold builds go to a temporary directory under the git-ignored
``kernels/_build/``, removed at the end.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import chip_smoke


def build_times() -> None:
    from blockpuzzle_tpu_torch.kernels import _build

    root = _build.BUILD_DIR / "cold"
    srcs = [str(s) for s in sorted(_build.CSRC.glob("*.cu"))]
    default_dir = _build.BUILD_DIR
    try:
        for i, how in enumerate(("one nvcc", "per source", "per source", "one nvcc")):
            out = root / str(i)
            out.mkdir(parents=True)
            t0 = time.perf_counter()
            if how == "one nvcc":
                subprocess.run(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     str(out / "lib.so"), *srcs],
                    check=True, capture_output=True,
                )
            else:
                _build.BUILD_DIR = out
                _build.build()
                _build.BUILD_DIR = default_dir
            print(f"[build] {how}, {len(srcs)} sources, cold: "
                  f"{time.perf_counter() - t0:.3f} s")
    finally:
        _build.BUILD_DIR = default_dir
        shutil.rmtree(root, ignore_errors=True)


def device_busy_us(events) -> float:
    """Length of the union of the events' time ranges, in µs."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if s > end:
            busy += e - s
        elif e > end:
            busy += e - end
        end = max(end, e)
    return busy


def train_breakdown(card: str, argv) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from blockpuzzle_tpu_torch.cli import train

    args = train.build_parser().parse_args(argv)
    learner = train.build(args)
    print(f"[train] {args.torso} torso, {learner.env.state_impl} engine, "
          f"N={args.num_envs}, T={args.rollout_len}")
    hypers = train.ppo_hypers(args, 0)
    state = learner.init(args.seed)
    state, _ = learner.update(state, hypers)             # warm-up
    torch.cuda.synchronize()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    update_ms = []
    for _ in range(2):
        (state, _), u_ms = timed(lambda: learner.update(state, hypers))
        (_, batch, last, _), r_ms = timed(lambda: learner._rollout(state))
        _, g_ms = timed(lambda: learner._gae(batch, last))
        update_ms.append(u_ms)
        print(f"[train] update {u_ms:.3f} ms, a rollout alone {r_ms:.3f} ms, "
              f"GAE alone {g_ms:.3f} ms ({card})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        learner.update(state, hypers)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        print("[train] the profiler saw no device events: device time not measured")
        return
    total = sum(e.time_range.elapsed_us() for e in device)
    busy = device_busy_us(device)
    print(f"[train] profiled update: {len(device)} device kernels, "
          f"{total / 1e3:.3f} ms device time, busy {busy / 1e3:.3f} ms = "
          f"{100 * busy / 1e3 / statistics.mean(update_ms):.1f}% of an "
          "unprofiled update")
    top_items(device, 1, "train", 12)


# the `__global__` functions of kernels/csrc, as the profiler names them
HAND_KERNELS = ("mask_rows_kernel", "mask_kernel", "apply_rows_kernel", "apply_kernel",
                "clear_rows_kernel", "clear_kernel", "legality_rows_kernel",
                "legality_kernel", "packed_apply_kernel", "packed_mask_kernel")
ENGINES = {"packed": {}, "u8-pallas": {"backend": "pallas"},
           "u8-jnp": {"backend": "jnp", "state_impl": "u8"}}


def rollout_breakdown(card: str) -> None:
    """Each engine's uniform-legal step at N = 49152, default preset: host
    time per step over 100 steps, then 20 steps under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

    n = chip_smoke.N_MAIN
    for name, kwargs in ENGINES.items():
        env = make_env(PRESETS["default"](), device="cuda", **kwargs)
        state, ts = env.init(0, n)
        sampler = UniformLegalSampler(1, n, env.device)

        def steps(k):
            nonlocal state, ts
            for _ in range(k):
                state, ts = env.step(state, sampler(ts.action_mask))
            torch.cuda.synchronize()

        steps(20)                                          # warm-up
        t0 = time.perf_counter()
        steps(100)
        step_ms = 10 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps(20)
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        print(f"[rollout] {name} step, N={n}: {step_ms:.4f} ms per step ({card})")
        if not device:
            print("[rollout] the profiler saw no device events: not measured")
            continue
        busy = device_busy_us(device) / 20 / 1e3
        print(f"[rollout] {name} profiled: {len(device) / 20:.1f} device kernels "
              f"per step, {sum(e.time_range.elapsed_us() for e in device) / 20e3:.4f}"
              f" ms device time, busy {busy:.4f} ms = {100 * busy / step_ms:.1f}% "
              "of an unprofiled step")
        top_items(device, 20, "rollout", 8)
        hand = [e for e in device if any(f"{k}(" in e.name for k in HAND_KERNELS)]
        top_items(hand, 20, "rollout hand kernel", len(HAND_KERNELS))


def top_items(device, per: int, tag: str, k: int) -> None:
    """The ``k`` largest device items, in ms per step (or per update)."""
    by_name = {}
    for e in device:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:k]:
        print(f"[{tag}]   {us / per / 1e3:8.4f} ms  {n / per:6.1f}x  {name[:90]}")


def rollout_turns(card: str) -> None:
    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.cli.rollout import rollout

    order = list(ENGINES) + list(ENGINES)[::-1]
    for name in order:
        env = make_env(PRESETS["default"](), device="cuda", **ENGINES[name])
        r = rollout(env, chip_smoke.N_MAIN, 200, 3, seed=0)
        print(f"[rollout] {name} step, N={chip_smoke.N_MAIN}: median "
              f"{statistics.median(r['rates']):.1f} env-steps/s ({card})")


# the earlier kernels' entry points, timed against the current ones; the
# bit-row mask and clear where the earlier sources have them
PARENT_ENTRIES = ("bp_mask", "bp_clear", "bp_apply", "bp_legality",
                  "bp_packed_apply", "bp_packed_mask")
PARENT_ROW_ENTRIES = ("bp_mask_rows", "bp_clear_rows")


def parent_library(csrc: pathlib.Path):
    """The earlier kernels, built by one nvcc into their own library under
    the git-ignored build directory; prints their ptxas lines."""
    from blockpuzzle_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libbp_parent.so"
    srcs = [str(src) for src in sorted(csrc.glob("*.cu"))]
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                          str(so), *srcs], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the earlier sources:\n{res.stderr}")
    for line in chip_smoke.ptxas_lines(res.stderr):
        print(f"[kernels] earlier ptxas: {line}")
    lib = ctypes.CDLL(str(so))
    rows = all(hasattr(lib, name) for name in PARENT_ROW_ENTRIES)
    for name in PARENT_ENTRIES + (PARENT_ROW_ENTRIES if rows else ()):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build.SIGNATURES[name], ctypes.c_int
    return lib


def parent_calls(lib, cfg, mk, ck, pak, pmk):
    """Callables with the current wrappers' arguments that launch the
    earlier kernels: the u8 apply and legality as the general kernels are
    called (with the line tables and the per-cell piece table), the u8 mask
    and clear through the earlier bit-row entries where the earlier sources
    have them (else as the general kernels), the packed apply and mask as
    the current ones."""
    import torch

    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.kernels import _build
    from blockpuzzle_tpu_torch.kernels.collision import piece_table

    dev = pmk.device
    table = torch.as_tensor(piece_table(cfg), device=dev)
    num_pieces = rules.tables_for(cfg).num_pieces
    lines = ck.lines
    region = cfg.region_size if cfg.region_clear else 0
    rows = hasattr(lib, "bp_mask_rows")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def mask(board, queue):
        n = board.shape[0]
        out = torch.empty((n, cfg.queue_size * cfg.num_cells), dtype=torch.bool,
                          device=dev)
        if rows:
            err = lib.bp_mask_rows(
                board.data_ptr(), queue.data_ptr(), mk.piece_table.data_ptr(),
                out.data_ptr(), n, cfg.height, cfg.width, cfg.queue_size, num_pieces,
                mk.max_h, mk.max_w, *mk.shape, stream())
        else:
            err = lib.bp_mask(
                board.data_ptr(), queue.data_ptr(), table.data_ptr(), out.data_ptr(),
                n, cfg.height, cfg.width, cfg.queue_size, num_pieces,
                table.shape[1] - 3, stream())
        _build.check(err, "earlier mask")
        return out

    def clear(board):
        n = board.shape[0]
        out = torch.empty_like(board)
        k = torch.empty(n, dtype=torch.int32, device=dev)
        if rows:
            err = lib.bp_clear_rows(
                board.data_ptr(), out.data_ptr(), k.data_ptr(), n, cfg.height,
                cfg.width, region, *ck.shape, stream())
        else:
            err = lib.bp_clear(
                board.data_ptr(), lines.line_cells.data_ptr(),
                lines.line_len.data_ptr(), out.data_ptr(), k.data_ptr(), n,
                cfg.num_cells, lines.line_cells.shape[0], lines.line_cells.shape[1],
                stream())
        _build.check(err, "earlier clear")
        return out, k

    def u8_apply(board, cover, valid):
        n = board.shape[0]
        out = torch.empty_like(board)
        k = torch.empty(n, dtype=torch.int32, device=dev)
        legal = torch.empty(n, dtype=torch.bool, device=dev)
        _build.check(lib.bp_apply(
            board.data_ptr(), cover.data_ptr(), valid.data_ptr(),
            lines.line_cells.data_ptr(), lines.line_len.data_ptr(), out.data_ptr(),
            k.data_ptr(), legal.data_ptr(), n, cfg.num_cells,
            lines.line_cells.shape[0], lines.line_cells.shape[1], stream()),
            "earlier bp_apply")
        return out, k, legal

    def legality(board):
        n = board.shape[0]
        out = torch.empty((n, num_pieces, cfg.num_cells), dtype=torch.bool, device=dev)
        _build.check(lib.bp_legality(
            board.data_ptr(), table.data_ptr(), out.data_ptr(), n, cfg.height,
            cfg.width, num_pieces, table.shape[1] - 3, stream()),
            "earlier bp_legality")
        return out

    def apply(words, attrs, r, c, valid):
        n = words.shape[0]
        out = torch.empty_like(words)
        k = torch.empty(n, dtype=torch.int32, device=dev)
        legal = torch.empty(n, dtype=torch.bool, device=dev)
        _build.check(lib.bp_packed_apply(
            words.data_ptr(), attrs.data_ptr(), r.data_ptr(), c.data_ptr(),
            valid.data_ptr(), out.data_ptr(), k.data_ptr(), legal.data_ptr(), n,
            cfg.height, cfg.width, region, pak.shape[0], stream()),
            "earlier bp_packed_apply")
        return out, k, legal

    def packed_mask(words, queue):
        n = words.shape[0]
        out = torch.empty((n, cfg.queue_size * cfg.num_cells), dtype=torch.bool,
                          device=dev)
        _build.check(lib.bp_packed_mask(
            words.data_ptr(), queue.data_ptr(), pmk.prow32.data_ptr(),
            pmk.piece_w32.data_ptr(), out.data_ptr(), n, cfg.height, cfg.width,
            cfg.queue_size, pmk.num_pieces, pmk.tables.nwords, pmk.tables.fpw,
            *pmk.shape, stream()), "earlier bp_packed_mask")
        return out

    return {"mask": mask, "clear": clear, "apply": u8_apply, "legality": legality,
            "packed_apply": apply, "packed_mask": packed_mask}


def kernel_turns(card: str, parent_csrc) -> None:
    import torch

    from blockpuzzle_tpu_torch.config import PRESETS
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel, PackedApplyKernel,
        PackedMaskKernel, _build,
    )
    from blockpuzzle_tpu_torch.kernels.packed import pack_words

    _build.library()
    for line in chip_smoke.ptxas_lines(_build.library_path().with_suffix(".log").read_text()):
        print(f"[kernels] current ptxas: {line}")
    lib = parent_library(pathlib.Path(parent_csrc)) if parent_csrc else None
    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    for name in chip_smoke.PACKED_PRESETS:
        cfg = PRESETS[name]()
        mk, ck = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev)
        ak, lk = ApplyKernel(cfg, dev), LegalityKernel(cfg, dev)
        pak, pmk = PackedApplyKernel(cfg, dev), PackedMaskKernel(cfg, dev)
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in chip_smoke.kernel_inputs(cfg, n, seed=0))
        words = pack_words(board.view(n, cfg.height, cfg.width))
        args = (words, attrs, r, c, valid)
        current = {"mask": lambda: mk(board, queue), "clear": lambda: ck(board),
                   "apply": lambda: ak(board, cover, valid),
                   "legality": lambda: lk(board),
                   "packed_apply": lambda: pak(*args),
                   "packed_mask": lambda: pmk(words, queue)}
        earlier = {}
        if lib is not None:
            calls = parent_calls(lib, cfg, mk, ck, pak, pmk)
            earlier = {"mask": lambda: calls["mask"](board, queue),
                       "clear": lambda: calls["clear"](board),
                       "apply": lambda: calls["apply"](board, cover, valid),
                       "legality": lambda: calls["legality"](board),
                       "packed_apply": lambda: calls["packed_apply"](*args),
                       "packed_mask": lambda: calls["packed_mask"](words, queue)}
            for k in current:
                got, want = current[k](), earlier[k]()
                got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{k} ({name}): current != earlier kernel")
        for k, fn in current.items():
            if k in earlier:
                old1, new1, new2, old2 = (chip_smoke.cuda_ms(f) for f in (
                    earlier[k], fn, fn, earlier[k]))
                print(f"[kernels] {k} {name} N={n} device ms in turns: earlier "
                      f"{old1:.6f}, current {new1:.6f}, current {new2:.6f}, earlier "
                      f"{old2:.6f} ({card})")
                print(f"[kernels] {k} {name} host-paced ms: earlier "
                      f"{chip_smoke.host_paced_ms(earlier[k]):.6f}, current "
                      f"{chip_smoke.host_paced_ms(fn):.6f}")
            else:
                print(f"[kernels] {k} {name} N={n}: device {chip_smoke.cuda_ms(fn):.6f}"
                      f" ms, host-paced {chip_smoke.host_paced_ms(fn):.6f} ms ({card})")
        if lib is not None:
            print(f"[kernels] {name}: current kernels == earlier ones (bit-equal)")


PARTS = ("build", "train", "rollout", "kernels")


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parts", default=",".join(PARTS),
                   help="comma-separated subset of " + ", ".join(PARTS))
    p.add_argument("--parent-csrc", default=None,
                   help="directory of earlier kernel sources (*.cu, *.cuh)")
    args = p.parse_args(argv)
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        p.error(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_measure: no CUDA device; nothing was run")
    card = chip_smoke.card_line()
    print(card)
    print(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    if "build" in parts:
        build_times()
    if "kernels" in parts:
        kernel_turns(card, args.parent_csrc)
    if "train" in parts:
        for argv_ in (chip_smoke.TRAIN_ARGV, chip_smoke.TRAIN_U8_ARGV):
            train_breakdown(card, argv_)
    if "rollout" in parts:
        rollout_breakdown(card)
        rollout_turns(card)
    print(f"[done] {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
