#!/usr/bin/env python3
"""Measurements of the PyTorch + CUDA port on one card, beyond the smoke run.

    python3 chip_measure.py [--parts build,train,rollout,kernels,words,general,draws,tall,
                                     packed_tall,tail,deep,apply,xwide,long,legality]
                            [--parent-csrc DIR] [--alt-csrc DIR ...]

Needs one CUDA card and nvcc.  Prints the card's name and power limit,
then, each line tagged with its part (all fifteen by default):

  build     cold builds of ``kernels/csrc/*.cu`` in turns: one nvcc over
            all sources, then one nvcc per source started together and a
            link (``_build.build``), then the same two in reverse order;
  train     for each training path of ``chip_smoke.py`` (the JAX CLI's
            defaults: conv torso, packed engine; then mlp torso, u8
            clear-kernel step; default preset, N = 4096, T = 64), one PPO
            update on the host's clock, twice: the update, a rollout alone
            and GAE alone; then one update under ``torch.profiler``:
            device kernels, device time, the device's busy share of an
            unprofiled update, and the largest device items; then, for
            each DQN configuration of ``chip_smoke.py`` phase 6, once the
            buffer is warm, ms per iteration on the host's clock (3
            iterations) and one iteration under the profiler (device
            kernels, device time, busy share, largest items);
  rollout   for each engine (packed with the argmax sampler and with the
            words sampler, u8 apply-kernel step, u8 clear-kernel step) at
            N = 49152 on the default preset: host ms per step, then 20
            steps under ``torch.profiler`` (kernels, device time and busy
            share per step, the largest items and each hand kernel's time
            inside the step); then the rollout entry point on each, in
            turns packed, packed-words, u8-pallas, u8-jnp, then back
            (median of 3 windows of 200 steps each);
  kernels   at N = 49152 on every packed preset: the u8 mask, clear, apply
            and legality (the bit-row kernels) and the packed apply, mask
            and legal words (the mask's words entry), device times (``chip_smoke.cuda_ms``) and host-paced
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
            turns: earlier, current, current, earlier; then B7w and B7 on
            the presets and 24x9 (``words_turns``): the earlier build's
            ``bp_packed_words`` and ``bp_packed_mask``, the wrappers'
            kernels and the words kernel the wrapper does not pick there
            (bit-row or tall), held bit-equal and timed in turns for 5
            rounds, medians and shares of the bound;
  words     the words sampler's pieces at N = 49152 on mid-game boards of
            the default and tenten presets (``words_breakdown``): the
            prefix counts of ``sample_uniform_legal`` as the port's static
            loop and as ``torch.cumsum``, ``sample_uniform_legal``, a
            ``WordsSampler`` and an ``UniformLegalSampler`` call, each with
            its device kernels and device time under the profiler and its
            time on the host's clock; then the words rollout's step on 10x10
            and 33x9 with the earlier build's B7, B7w and B2w swapped in and
            with the current ones, in turns (``words_step_turns``): host ms,
            kernels, device ms and busy share a step, the legal words' and
            the select's device ms a step;
  general   the u8 kernels of an 8x40 board (rows of 40 cells: the wide
            mask, clear, apply and legality) at N = 49152, with the general
            ones launched directly on the same inputs and held bit-equal to
            the wide ones, all eight timed in turns for 5 rounds and each
            wide kernel's median printed beside
            the general one's (``chip_smoke.wide_turns``, the rounds
            ``chip_smoke.py`` phase 1 also takes), here in a process whose
            library is freshly loaded; then the u8 clear-kernel step on that
            board with the wide kernels and with the general ones swapped
            in, in turns (``wide_step_turns``);
  tall      the tall u8 mask and clear at N = 49152 on 33x9 and 40x40, each
            in turns with the general kernel launched on the same inputs and
            held bit-equal to it (``chip_smoke.tall_turns``); the u8
            clear-kernel step on 33x9 with the tall and the general pair in
            turns (``tall_step_turns``); the tall mask and clear at other
            launch shapes than the wrapper's (one board a warp against its
            turns; ``tall_turn_shapes``), in turns; the tall packed apply, mask and
            words kernels on 33x9 and 36x9 with regions and the general
            ones on 130x8, device and host-paced times; the tall packed
            mask and words (B7 tall, B7w tall) on 33x9, 36x9 with regions,
            64x8 and 128x10 at N = 49152, with ``--parent-csrc DIR`` in
            turns with the earlier sources' ``bp_packed_mask_tall`` and
            ``bp_packed_words_tall`` (``EarlierMask``), beside the same
            kernel at other block sizes (``anchor_envs``) and the
            windowed general kernel on the same inputs, every output
            bit-equal, 5 rounds, medians and shares of the bound
            (``packed_tall_turns``); the default (packed) step on 33x9 with
            the argmax and with the words sampler, the earlier tall mask and
            words swapped in and the current ones in turns: host ms,
            kernels, device ms and busy share a step
            (``packed_tall_step_turns``); each ``--alt-csrc DIR`` (other
            versions of some of ``kernels/csrc``'s sources beside the
            headers they include, with the current entries' arguments) is
            built by its own nvcc and its tall mask and words are timed in
            the same turns, its B7w entries in ``words_turns`` and its B2w
            entry in ``select_turns`` (``alt_libraries``); the default
            (packed) step on 33x9 with each sampler as the ``rollout`` part
            profiles the default preset's; with
            ``--parent-csrc DIR``, the default preset's bit-row mask, clear,
            packed apply and packed mask in turns with the earlier build's,
            as the ``kernels`` part times them; then ``cli.rollout --env
            height=33 --env width=9 --num-envs 49152 --steps 2000`` in this
            process (the default engine: the tall packed kernels);
  packed_tall  of ``tall``, the tall packed mask and words in turns
            (``packed_tall_turns``) and the 33x9 step
            (``packed_tall_step_turns``) alone;
  draws     the three draw kernels (deal, as the step's 2S-wide draw and
            the S-wide reset deal, uniform_legal, words_select) at N =
            49152 on every packed preset, device times; with
            ``--parent-csrc DIR``, the earlier sources' draws
            (``bp_deal``, ``bp_uniform_legal``, ``bp_words_select``, with
            the arguments ``_build.SIGNATURES`` gives them) held bit-equal
            and timed in turns, earlier, current, current, earlier; then
            the launch floor, ``torch.cuda._sleep(0)`` back to back; then
            B2w on the presets and on 33x9, 36x9 with regions, 130x8 and
            512x8 (``select_turns``): the earlier build's, the wrapper's
            and every other segment width, held bit-equal and timed in
            turns for 5 rounds, medians and shares of the bound;
  tail      the step's tail (B10) and its unpack at N = 49152 on the
            default, tenten, 33x9 and 130x8 boards (dense boards, the step's
            call with auto-reset): device times beside their bounds; with
            ``--parent-csrc DIR``, the earlier sources' ``bp_packed_tail``
            and ``bp_packed_unpack`` at their own tiles held bit-equal to
            the current kernels (floats as their int32 bits) and timed in
            turns, earlier, current, current, earlier, five rounds, medians
            and shares of the bound; then the tail at other tiles, rings and
            grids (``TAIL_SHAPES``), in turns, and on the default preset
            built with only some of its parts (``TAIL_PARTS``); then the
            default (packed) step on 33x9 profiled as ``rollout`` does;
  deep      the u8 clear and the packed mask and words on boards of more
            than 128 rows, each a warp walking the board in windows of 32
            rows, at N = 49152 on 130x8 and 512x8 (``DEEP_BOARDS``): the
            deep clear against the general clear launched directly on the
            same inputs (``chip_smoke.general_calls``), and the windowed
            general packed mask and words against their thread-an-anchor-row
            kernels (``chip_smoke.general_mask_pick``); with
            ``--parent-csrc DIR`` first the earlier sources' ``bp_clear``,
            ``bp_packed_mask_general`` and ``bp_packed_words_general``; every
            output held bit-equal, each kernel timed in turns (earlier,
            current, current, earlier) for 5 rounds, medians and shares of
            the bound (``deep_turns``); then
            the default (packed) step and the u8 clear-kernel step on 130x8,
            with the replaced clear and packed mask swapped in (the earlier
            sources', else the current library's) and with the current
            ones, in turns earlier, current, current, earlier: host ms a
            step, device kernels, device ms and busy share a step, the
            largest items (``deep_step_turns``);
  apply     the u8 apply (K2) beyond 32x32 at N = 49152 on 8x40, 33x9,
            130x8, 512x8, 8x136 and 40x136 (``APPLY_BOARDS``): the wide, tall, deep or
            xwide apply
            against the general apply launched directly on the same inputs
            (``chip_smoke.general_apply``), with ``--parent-csrc DIR`` first
            the earlier sources' ``bp_apply``; held bit-equal and timed in
            turns, medians and shares of the bound (``apply_turns``); then
            the u8 apply-kernel step on 8x40, 33x9, 130x8 and 8x136 with the
            general apply (the earlier sources', else the current
            library's) and with the wrapper's in turns, earlier, current,
            current, earlier: host ms a step, device kernels, device ms and
            busy share a step, the apply's device ms a step
            (``pallas_step_turns``);
  xwide     the u8 mask, clear, apply and legality on rows of more than 128
            cells at N = 49152 on 8x136, 8x160, 9x135 with regions, 3x320
            and 2x1024 (at most 32 rows) and on 40x136, 33x129, 36x135 with
            regions and 66x130 (more than 32 rows): each xwide kernel held
            bit-equal to the general kernel it replaces launched directly
            on the same inputs (``chip_smoke.general_calls``,
            ``chip_smoke.general_apply``, ``chip_smoke.general_legality``)
            and, with ``--parent-csrc DIR``, the earlier sources' xwide
            kernels (sources whose xwide apply and legality take any
            height), with each ``--alt-csrc``
            build's xwide kernels and, above 32 rows, at other warps a
            block, timed in turns with them, 5 rounds, medians and shares
            of the bound (``xwide_times``); then the u8 apply-kernel step on
            8x136 and 40x136 with the general apply (the earlier sources',
            else the current library's) and with the xwide one, in turns
            general, xwide, xwide, general: host ms a step, device kernels,
            device ms and busy share a step, the apply's device ms a step
            (``xwide_step_turns``); then the parts of ``long``;
  long      the long-row instances of the mask, clear, apply and legality
            on rows of more than 1024 cells, on 2x1056, 3x1030, 2x2048,
            9x1035 with regions and a hand of three (N =
            49152) and 33x1025 (N = 8192): each held bit-equal to the
            general kernel launched directly and, with ``--parent-csrc
            DIR``, the earlier sources' general mask and legality (which
            took those boards) and long-row clear and apply, with each
            ``--alt-csrc`` build's long-row instances, and at 1, 2 and 8
            warps a block, timed in turns with them, medians and shares of
            the bound (``long_times``); then the u8 clear-kernel and
            apply-kernel steps on 2x1056 with the earlier (or the current)
            general mask and with the long-row one in turns, earlier,
            current, current, earlier: host ms a step, device kernels,
            device ms and busy share a step, the mask's device ms a step
            (``long_step_turns``); then the four general kernels on 2x4128,
            where they now run, each beside its bound
            (``general_long_times``);
  legality  the all-pieces legality (K4) beyond 32x32 at N = 49152 on 8x40,
            33x9, 130x8 and 8x136 (``chip_smoke.LEGALITY_BOARDS``): the
            every-piece instance of the wide, tall, deep or xwide mask
            against the general legality launched directly on the same
            inputs (``chip_smoke.general_legality``, ``bp_legality``), with
            ``--parent-csrc DIR`` first the earlier sources' ``bp_legality``;
            held bit-equal and timed in turns, 5 rounds, medians and shares
            of the bound (``legality_turns``).

Cold builds go to a temporary directory under the git-ignored
``kernels/_build/``, removed at the end.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import chip_smoke
from blockpuzzle_tpu_torch.utils.profiling import busy_us, by_name, device_events


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


def train_breakdown(card: str, argv) -> None:
    import torch
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
    device = device_events(prof)
    if not device:
        print("[train] the profiler saw no device events: device time not measured")
        return
    total = sum(e.time_range.elapsed_us() for e in device)
    busy = busy_us(device)
    print(f"[train] profiled update: {len(device)} device kernels, "
          f"{total / 1e3:.3f} ms device time, busy {busy / 1e3:.3f} ms = "
          f"{100 * busy / 1e3 / statistics.mean(update_ms):.1f}% of an "
          "unprofiled update")
    top_items(device, 1, "train", 12)


def dqn_breakdown(card: str, argv) -> None:
    """One DQN iteration of a ``chip_smoke.py`` phase-6 configuration once
    the buffer is warm (every iteration takes its TD step): host time over
    3 iterations, then one under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blockpuzzle_tpu_torch.cli import train
    from blockpuzzle_tpu_torch.learn import default_dqn_hypers

    args = train.build_parser().parse_args(argv)
    learner = train.build(args)
    cfg = learner.cfg
    state, it = learner.init(args.seed), 0

    def step():
        nonlocal state, it
        state, _ = learner.iteration(state, default_dqn_hypers(cfg, it))
        it += 1

    while state.replay.filled < cfg.min_buffer:              # warm-up
        step()
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    it_ms = 1e3 * (time.perf_counter() - t0) / 3
    tag = f"dqn {cfg.torso}/{learner.env.state_impl}"
    print(f"[train] {tag} (dueling {cfg.dueling}, n_step {cfg.n_step}, per {cfg.per}), "
          f"N={cfg.num_envs}, batch {cfg.batch_size}: {it_ms:.3f} ms per warm "
          f"iteration ({1e3 * cfg.num_envs * cfg.collect_steps / it_ms:.1f} env-steps/s; "
          f"{card})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device = device_events(prof)
    if not device:
        print("[train] the profiler saw no device events: device time not measured")
        return
    total = sum(e.time_range.elapsed_us() for e in device)
    busy = busy_us(device)
    print(f"[train] {tag} profiled iteration: {len(device)} device kernels, "
          f"{total / 1e3:.3f} ms device time, busy {busy / 1e3:.3f} ms = "
          f"{100 * busy / 1e3 / it_ms:.1f}% of an unprofiled iteration")
    top_items(device, 1, "train", 12)


# the `__global__` functions of kernels/csrc, as the profiler names them
HAND_KERNELS = ("mask_rows_kernel", "mask_kernel", "apply_rows_kernel", "apply_kernel",
                "clear_rows_kernel", "clear_kernel", "legality_rows_kernel",
                "legality_kernel", "packed_apply_kernel", "packed_mask_kernel",
                "packed_words_kernel", "packed_apply_tall_kernel", "packed_anchor_kernel",
                "packed_tail_kernel", "packed_unpack_kernel")
# rollout -> (make_env arguments, the rollout's sampler)
ENGINES = {"packed": ({}, "argmax"), "packed-words": ({}, "words"),
           "u8-pallas": ({"backend": "pallas"}, "argmax"),
           "u8-jnp": ({"backend": "jnp", "state_impl": "u8"}, "argmax")}


def rollout_breakdown(card: str, cfg=None, engines=ENGINES, tag: str = "rollout") -> None:
    """Each engine's uniform-legal step at N = 49152, default preset or
    ``cfg`` (the packed engine also with the words sampler): host time per
    step over 100 steps, then 20 steps under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler, WordsSampler

    n = chip_smoke.N_MAIN
    cfg = cfg or PRESETS["default"]()
    board = f"{cfg.height}x{cfg.width}"
    for name, (kwargs, sampler_name) in engines.items():
        env = make_env(cfg, device="cuda", **kwargs)
        state, ts = env.init(0, n)
        if sampler_name == "words":
            draw = WordsSampler(1, n, env.device)
            policy = lambda: draw(env, state.board, state.queue)
        else:
            draw = UniformLegalSampler(1, n, env.device)
            policy = lambda: draw(ts.action_mask)

        def steps(k):
            nonlocal state, ts
            for _ in range(k):
                state, ts = env.step(state, policy())
            torch.cuda.synchronize()

        steps(20)                                          # warm-up
        t0 = time.perf_counter()
        steps(100)
        step_ms = 10 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps(20)
        device = device_events(prof)
        print(f"[{tag}] {name} step, {board}, N={n}: {step_ms:.4f} ms per step ({card})")
        if not device:
            print(f"[{tag}] the profiler saw no device events: not measured")
            continue
        busy = busy_us(device) / 20 / 1e3
        print(f"[{tag}] {name} profiled: {len(device) / 20:.1f} device kernels "
              f"per step, {sum(e.time_range.elapsed_us() for e in device) / 20e3:.4f}"
              f" ms device time, busy {busy:.4f} ms = {100 * busy / step_ms:.1f}% "
              "of an unprofiled step")
        top_items(device, 20, tag, 8)
        hand = [e for e in device
                if any(f"{k}(" in e.name or f"{k}<" in e.name for k in HAND_KERNELS)]
        top_items(hand, 20, f"{tag} hand kernel", len(HAND_KERNELS))


# the device kernel names of the u8 mask and clear, by kernel kind (the
# xwide ones' first instances: the legality's and the apply's are the second;
# the clear's in both forms, with and without windows)
STEP_KERNEL_NAMES = {"wide": ("mask_wide_kernel<", "clear_wide_kernel<"),
                     "tall": ("mask_tall_kernel<", "clear_tall_kernel<"),
                     "general": ("::mask_kernel(", "::clear_kernel(")}


def u8_step_turns(card: str, shape: dict, tag: str, steps: int = 20) -> None:
    """The u8 clear-kernel step (``backend="jnp"``) on the board
    ``shape`` at N = 49152, uniform-legal draws, with the mask and clear the
    wrappers pick (wide, tall or xwide) and with the general mask and clear
    launched in their place on the same inputs (``chip_smoke.general_calls``),
    in turns general, picked, picked, general, one engine carrying its state
    through all four: host ms a step over ``steps`` unprofiled steps, then
    ``steps`` steps under ``torch.profiler``: device kernels, device ms and
    busy share a step, and the mask's and the clear's device ms a step
    inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blockpuzzle_tpu_torch import make_env
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

    n, cfg = chip_smoke.N_MAIN, EnvConfig(**shape)
    env = make_env(cfg, device="cuda", backend="jnp", state_impl="u8")
    kind = env.mask_kernel.kind
    kernels = {kind: (env.mask_kernel, env.clear_kernel),
               "general": chip_smoke.general_calls(cfg, env.mask_kernel, env.clear_kernel)}
    board = f"{cfg.height}x{cfg.width}"
    state, ts = env.init(0, n)
    draw = UniformLegalSampler(1, n, env.device)

    def run(k):
        nonlocal state, ts
        for _ in range(k):
            state, ts = env.step(state, draw(ts.action_mask))
        torch.cuda.synchronize()

    for which in ("general", kind, kind, "general"):
        env.mask_kernel, env.clear_kernel = kernels[which]
        run(5)                                             # warm-up
        t0 = time.perf_counter()
        run(steps)
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(steps)
        device = device_events(prof)
        if not device:
            print(f"[{tag}] the profiler saw no device events: not measured")
            continue
        parts = [sum(e.time_range.elapsed_us() for e in device if key in e.name)
                 / steps / 1e3 for key in STEP_KERNEL_NAMES[which]]
        busy = busy_us(device) / steps / 1e3
        print(f"[{tag}] u8 jnp step, {kind} {board}, N={n}, {which} mask and clear: "
              f"{step_ms:.4f} ms per step, {len(device) / steps:.2f} device kernels and "
              f"{sum(e.time_range.elapsed_us() for e in device) / steps / 1e3:.6f} ms "
              f"device time a step, busy {busy:.4f} ms = {100 * busy / step_ms:.1f}%, "
              f"mask {parts[0]:.6f} ms, clear {parts[1]:.6f} ms ({card})")
    env.mask_kernel, env.clear_kernel = kernels[kind]


def wide_step_turns(card: str, steps: int = 20) -> None:
    """``u8_step_turns`` on the 8x40 board: the wide mask and clear against
    the general ones."""
    u8_step_turns(card, chip_smoke.WIDE, "general", steps)


def tall_step_turns(card: str, steps: int = 20) -> None:
    """``u8_step_turns`` on 33x9: the tall mask and clear against the
    general ones."""
    u8_step_turns(card, chip_smoke.TALL, "tall", steps)


def packed_tall_times(card: str) -> None:
    """The packed kernels of boards of more than 32 rows at N = 49152 on
    ``chip_smoke.kernel_inputs``' boards: the tall apply, mask and words
    kernels on 33x9 and 36x9 with regions (a hand of three), the general
    ones on 130x8; device times (``chip_smoke.cuda_ms``) and host-paced
    times."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import PackedApplyKernel, PackedMaskKernel
    from blockpuzzle_tpu_torch.kernels.packed import pack_words

    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    for name, shape in (("33x9", chip_smoke.TALL), ("36x9r3", chip_smoke.TALL36R3),
                        ("130x8", chip_smoke.HUGE)):
        cfg = EnvConfig(**shape)
        pak, pmk = PackedApplyKernel(cfg, dev), PackedMaskKernel(cfg, dev)
        board, queue, _, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in chip_smoke.kernel_inputs(cfg, n, seed=0))
        words = pack_words(board.view(n, cfg.height, cfg.width))
        calls = {pak.name: lambda: pak(words, attrs, r, c, valid),
                 pmk.name: lambda: pmk(words, queue),
                 pmk.words_name: lambda: pmk.words(words, queue)}
        for k, fn in calls.items():
            print(f"[tall] {k} {name} N={n}: device {chip_smoke.cuda_ms(fn):.6f} ms, "
                  f"host-paced {chip_smoke.host_paced_ms(fn):.6f} ms ({card})")


class EarlierMask:
    """Stands in for a ``PackedMaskKernel`` (``pmk``) inside an engine's step
    and the words sampler: its mask and words entries launch another
    library ``lib``'s entries with the current wrapper's tables.  On a board
    of 33 to 128 rows (``tall``) those are ``bp_packed_mask_tall`` (at the
    warps a block ``tall_launch_shape`` gives, as the wrapper passed them
    before the segment kernel) and ``bp_packed_words_tall``; on a board of
    at most 32 rows
    ``bp_packed_mask`` and ``bp_packed_words`` at the bit-row launch shape."""

    def __init__(self, lib, pmk, tall: bool = False):
        from blockpuzzle_tpu_torch.kernels.packed import tall_launch_shape

        self.lib, self.pmk, self.cfg = lib, pmk, pmk.cfg
        if tall:
            self.mask_launch = ("bp_packed_mask_tall", tall_launch_shape(pmk.cfg)[1])
            self.words_launch = ("bp_packed_words_tall",)
        else:
            self.mask_launch = ("bp_packed_mask", *pmk.shape)
            self.words_launch = ("bp_packed_words", pmk.shape[0])

    def _launch(self, launch, shape, dtype, words, queue):
        import torch

        from blockpuzzle_tpu_torch.kernels import _build

        entry, *args = launch
        out = torch.empty(shape, dtype=dtype, device=words.device)
        _build.check(getattr(self.lib, entry)(
            *self.pmk._args(words, queue, out), *args,
            torch.cuda.current_stream(words.device).cuda_stream), f"earlier {entry}")
        return out

    def __call__(self, words, queue):
        import torch

        n, cfg = words.shape[0], self.cfg
        return self._launch(self.mask_launch, (n, cfg.queue_size * cfg.num_cells),
                            torch.bool, words, queue)

    def words(self, words, queue):
        import torch

        n, cfg = words.shape[0], self.cfg
        return self._launch(self.words_launch, (n, cfg.queue_size * cfg.height),
                            torch.int64, words, queue)


# boards the ``tall`` part times the tall packed mask and words on
PACKED_TALL_BOARDS = chip_smoke.TALL_PACKED_CASES


def anchor_envs(envs: int) -> list:
    """Env-slots a block the ``tall`` part times the tall packed mask and
    words at beside the wrapper's ``envs``: about half, twice, and one
    fewer (where a warp holds whole segments, a block that then stages and
    stores as one)."""
    return [e for e in dict.fromkeys((max(envs // 2, 1), 2 * envs, max(envs - 1, 1)))
            if e != envs]


def packed_tall_turns(card: str, lib, alts=None, rounds: int = 5) -> None:
    """B7 tall and B7w tall on ``PACKED_TALL_BOARDS`` at N = 49152
    (``chip_smoke.kernel_inputs``, seed 0): where ``lib`` is given first the
    earlier library's ``bp_packed_mask_tall`` and ``bp_packed_words_tall``
    (``EarlierMask``), then the wrapper's kernel, the same entries of
    each library of ``alts`` (label -> library, ``alt_libraries``) at the
    wrapper's block size, the current kernel at the block sizes
    ``anchor_envs`` (``chip_smoke.anchor_pick``) and
    the windowed general kernel launched on the same inputs
    (``chip_smoke.general_mask_pick``); each group held bit-equal, then
    timed in turns (``group_turns``)."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import PackedMaskKernel
    from blockpuzzle_tpu_torch.kernels.packed import pack_words
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    for name, shape in PACKED_TALL_BOARDS.items():
        cfg = EnvConfig(**shape)
        pmk = PackedMaskKernel(cfg, dev)
        if (pmk.name, pmk.words_name) != ("packed_mask_tall", "packed_legal_words_tall"):
            raise AssertionError(f"{name}: the wrapper picked {pmk.name}")
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in chip_smoke.kernel_inputs(cfg, n, seed=0))
        words = pack_words(board.view(n, cfg.height, cfg.width))
        groups = {}
        for key, entry, words_out in (("packed_mask_tall", pmk, False),
                                      ("packed_legal_words_tall", pmk.words, True)):
            fns = {}
            if lib is not None:
                earlier = EarlierMask(lib, pmk, tall=True)
                fns["earlier"] = functools.partial(
                    earlier.words if words_out else earlier, words, queue)
            fns[f"{key} ({pmk.shape[0]} env-slots a block)"] = functools.partial(
                entry, words, queue)
            for label, alt in (alts or {}).items():
                if hasattr(alt, "bp_packed_words_tall"):
                    fns[label] = functools.partial(
                        chip_smoke.anchor_pick(cfg, pmk, pmk.shape[0], words_out, alt), words,
                        queue)
            for envs in anchor_envs(pmk.shape[0]):
                fns[f"{envs} env-slots a block"] = functools.partial(
                    chip_smoke.anchor_pick(cfg, pmk, envs, words_out), words, queue)
            fns["windowed general kernel"] = functools.partial(
                chip_smoke.general_mask_pick(cfg, pmk, windowed=True, words=words_out),
                words, queue)
            groups[key] = fns
        outs = {"packed_mask_tall": pmk(words, queue),
                "packed_legal_words_tall": pmk.words(words, queue)}
        bound = kernel_bounds(cfg, board, queue, cover, valid, words, attrs, r, c, outs)
        group_turns(card, "tall", name, groups, bound, rounds)


def packed_tall_step_turns(card: str, lib, steps: int = 20) -> None:
    """The default (packed) step on 33x9 at N = 49152, with the argmax
    sampler and with the words sampler, one engine each carrying its state:
    where ``lib`` is given with the earlier library's tall mask and words
    swapped in (``EarlierMask``) and with the current ones, in turns
    earlier, current, current, earlier (else the current ones twice): host
    ms a step over ``steps`` unprofiled steps, then ``steps`` steps under
    ``torch.profiler``: device kernels, device ms and busy share a step,
    the tall mask's and words' device ms a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blockpuzzle_tpu_torch import make_env
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler, WordsSampler

    n, cfg = chip_smoke.N_MAIN, EnvConfig(**chip_smoke.TALL)
    keys = ("packed_mask_tall_kernel", "packed_words_tall_kernel", "packed_anchor_kernel")
    order = ("earlier", "current", "current", "earlier") if lib is not None else (
        "current", "current")
    for sampler_name in ("argmax", "words"):
        env = make_env(cfg, device="cuda")
        current = env.packed_mask_kernel
        kernels = {"current": current}
        if lib is not None:
            kernels["earlier"] = EarlierMask(lib, current, tall=True)
        state, ts = env.init(0, n)
        if sampler_name == "words":
            draw = WordsSampler(1, n, env.device)
            policy = lambda: draw(env, state.board, state.queue)
        else:
            draw = UniformLegalSampler(1, n, env.device)
            policy = lambda: draw(ts.action_mask)

        def run(k):
            nonlocal state, ts
            for _ in range(k):
                state, ts = env.step(state, policy())
            torch.cuda.synchronize()

        for which in order:
            env.packed_mask_kernel = kernels[which]
            run(5)                                         # warm-up
            t0 = time.perf_counter()
            run(steps)
            step_ms = 1e3 * (time.perf_counter() - t0) / steps
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(steps)
            device = device_events(prof)
            if not device:
                print("[tall] the profiler saw no device events: not measured")
                continue
            busy = busy_us(device) / steps / 1e3
            part = sum(e.time_range.elapsed_us() for e in device
                       if any(k in e.name for k in keys)) / steps / 1e3
            print(f"[tall] packed step, {sampler_name} sampler, 33x9, N={n}, {which} tall "
                  f"mask and words: {step_ms:.4f} ms per step, {len(device) / steps:.2f} "
                  f"device kernels, "
                  f"{sum(e.time_range.elapsed_us() for e in device) / steps / 1e3:.6f} ms "
                  f"device time a step, busy {busy:.4f} ms = {100 * busy / step_ms:.1f}%, "
                  f"the tall mask and words {part:.6f} ms a step ({card})")
        env.packed_mask_kernel = current


def tall_turn_shapes(card: str, rounds: int = 3) -> None:
    """The tall mask and clear on 33x9 and on 36x9 with regions (a hand of
    three) at N = 49152, launched through their C entries at launch shapes
    (boards a warp, warps a block) other than the wrapper's: one board a
    warp against the turns ``kernels/packed.py`` ``tall_launch_shape``
    picks, held bit-equal to the wrapper's output and timed in turns for
    ``rounds`` rounds."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import ClearScanKernel, MaskKernel, _build

    n, dev, lib = chip_smoke.N_MAIN, torch.device("cuda"), _build.library()
    for shape in (chip_smoke.TALL, chip_smoke.TALL36R3):
        cfg = EnvConfig(**shape)
        mk, ck = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev)
        board, queue = (torch.as_tensor(x, device=dev)
                        for x in chip_smoke.kernel_inputs(cfg, n, seed=0)[:2])
        want_mask, want_clear = mk(board, queue), ck(board)
        region = cfg.region_size if cfg.region_clear else 0

        def mask(launch):
            out = torch.empty_like(want_mask)
            _build.check(lib.bp_mask_tall(
                board.data_ptr(), queue.data_ptr(), mk.piece_table.data_ptr(),
                out.data_ptr(), n, cfg.height, cfg.width, cfg.queue_size, mk.num_pieces,
                mk.max_h, mk.max_w, *launch, torch.cuda.current_stream().cuda_stream),
                "bp_mask_tall")
            return out

        def clear(launch):
            out = torch.empty_like(board)
            k = torch.empty(n, dtype=torch.int32, device=dev)
            _build.check(lib.bp_clear_tall(
                board.data_ptr(), out.data_ptr(), k.data_ptr(), n, cfg.height, cfg.width,
                region, *launch, torch.cuda.current_stream().cuda_stream), "bp_clear_tall")
            return out, k

        launches = ((1, 16), mk.shape, (2, 16), (4, 8))
        for launch in launches:
            if not torch.equal(mask(launch), want_mask) or not all(
                    torch.equal(a, b) for a, b in zip(clear(launch), want_clear)):
                raise AssertionError(f"tall kernels at {launch} != the wrapper's")
        times = {}
        for _ in range(rounds):
            for launch in launches:
                for k, fn in (("mask_tall", mask), ("clear_tall", clear)):
                    times.setdefault((k, launch), []).append(
                        chip_smoke.cuda_ms(lambda: fn(launch)))
        for (k, launch), ts in times.items():
            print(f"[tall] {k} {cfg.height}x{cfg.width} N={n}, {launch[0]} boards a warp, "
                  f"{launch[1]} warps a block{' (the wrapper' + chr(39) + 's)' if launch == mk.shape else ''}"
                  f", in turns, device ms: {', '.join(f'{t:.6f}' for t in ts)} ({card})")


def tall_rollout_rate(card: str) -> None:
    """``cli.rollout --env height=33 --env width=9 --num-envs 49152`` (the
    default, packed engine through the tall kernels), in this process."""
    from blockpuzzle_tpu_torch.cli import rollout

    print(f"[tall] cli.rollout --env height=33 --env width=9 --num-envs {chip_smoke.N_MAIN} "
          f"({card}):", flush=True)
    rollout.main(["--env", "height=33", "--env", "width=9", "--num-envs",
                  str(chip_smoke.N_MAIN), "--steps", "2000"])


def top_items(device, per: int, tag: str, k: int) -> None:
    """The ``k`` largest device items, in ms per step (or per update)."""
    for name, n, us in by_name(device)[:k]:
        print(f"[{tag}]   {us / per / 1e3:8.4f} ms  {n / per:6.1f}x  {name[:90]}")


def rollout_turns(card: str) -> None:
    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.cli.rollout import rollout

    order = list(ENGINES) + list(ENGINES)[::-1]
    for name in order:
        kwargs, sampler_name = ENGINES[name]
        env = make_env(PRESETS["default"](), device="cuda", **kwargs)
        r = rollout(env, chip_smoke.N_MAIN, 200, 3, seed=0, sampler=sampler_name)
        print(f"[rollout] {name} step, N={chip_smoke.N_MAIN}: median "
              f"{statistics.median(r['rates']):.1f} env-steps/s ({card})")


def profiled(fn, reps: int = 20):
    """(device kernels, device ms) per call of ``fn`` under
    ``torch.profiler``: the summed time of its device events, so the
    host's pace does not enter."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = device_events(prof)
    return len(device) / reps, sum(e.time_range.elapsed_us() for e in device) / reps / 1e3


def words_breakdown(card: str) -> None:
    """The words sampler's pieces at N = 49152 on mid-game boards (20 steps
    of the argmax rollout) of the default and tenten presets: the prefix
    counts of ``sample_uniform_legal`` as its static loop of running sums
    and as ``torch.cumsum``, the whole ``sample_uniform_legal``, a
    ``WordsSampler`` call (draw, legal words, sample) and an
    ``UniformLegalSampler`` call; device kernels and device time per call
    under the profiler, and ms per call on the host's clock."""
    import torch

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.env.words import legal_words, sample_uniform_legal
    from blockpuzzle_tpu_torch.kernels.packed import popcount32
    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler, WordsSampler

    n = chip_smoke.N_MAIN
    for preset in ("default", "tenten"):
        env = make_env(PRESETS[preset](), device="cuda")
        state, ts = env.init(0, n)
        argmax = UniformLegalSampler(1, n, env.device)
        for _ in range(20):
            state, ts = env.step(state, argmax(ts.action_mask))
        words = legal_words(env, state.board, state.queue)
        cnt = popcount32(words)
        u = torch.rand(n, device=env.device)
        sampler = WordsSampler(2, n, env.device)

        def running_sums():
            csum = [cnt[:, 0]]
            for k in range(1, cnt.shape[1]):
                csum.append(csum[-1] + cnt[:, k])
            return torch.stack(csum, dim=1)

        if not torch.equal(running_sums(), torch.cumsum(cnt, dim=1)):
            raise AssertionError("running sums != torch.cumsum")
        calls = {
            "prefix counts, static loop (the port's)": running_sums,
            "prefix counts, torch.cumsum": lambda: torch.cumsum(cnt, dim=1),
            "sample_uniform_legal": lambda: sample_uniform_legal(words, u, env.cfg.width),
            "WordsSampler call": lambda: sampler(env, state.board, state.queue),
            "UniformLegalSampler call": lambda: argmax(ts.action_mask),
        }
        for name, fn in calls.items():
            kernels, ms = profiled(fn)
            host = chip_smoke.host_paced_ms(fn)
            print(f"[words] {preset} N={n}, S*H={cnt.shape[1]}: {name}: {kernels:.1f} "
                  f"device kernels, {ms:.6f} ms device time per call, {host:.6f} ms "
                  f"per call on the host's clock ({card})")


# the earlier kernels' entry points, timed against the current ones; the
# bit-row mask and clear where the earlier sources have them
PARENT_ENTRIES = ("bp_mask", "bp_clear", "bp_apply", "bp_legality",
                  "bp_packed_apply", "bp_packed_mask", "bp_packed_words")
PARENT_ROW_ENTRIES = ("bp_mask_rows", "bp_clear_rows")
# the draws' entry points, where the earlier sources have them
PARENT_DRAW_ENTRIES = ("bp_deal", "bp_uniform_legal", "bp_words_select")
# the step tail's entry points, where the earlier sources have them
PARENT_TAIL_ENTRIES = ("bp_packed_tail", "bp_packed_unpack")
# the general packed kernels' entry points and the general u8 apply, where
# the earlier sources have them
PARENT_DEEP_ENTRIES = ("bp_packed_apply_general", "bp_packed_mask_general",
                       "bp_packed_words_general", "bp_apply")
# the xwide u8 kernels' entry points, where the earlier sources have them
PARENT_XWIDE_ENTRIES = ("bp_mask_xwide", "bp_clear_xwide", "bp_apply_xwide",
                        "bp_legality_xwide")
# the tall packed mask's and words' entry points, where the earlier sources
# have them, with the arguments those took before the kernel a thread an
# anchor row: the mask's warps a block (``tall_launch_shape``'s) in place
# of its anchor rows, the words' nothing
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_TALL_SIGNATURES = {"bp_packed_mask_tall": [_P] * 5 + [_I] * 8 + [_P],
                          "bp_packed_words_tall": [_P] * 5 + [_I] * 7 + [_P]}


@functools.cache
def parent_library(csrc: pathlib.Path):
    """The earlier kernels, built by one nvcc into their own library under
    the git-ignored build directory (once a process); prints their ptxas
    lines."""
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
    draws = all(hasattr(lib, name) for name in PARENT_DRAW_ENTRIES)
    tail = all(hasattr(lib, name) for name in PARENT_TAIL_ENTRIES)
    deep = all(hasattr(lib, name) for name in PARENT_DEEP_ENTRIES)
    tall = all(hasattr(lib, name) for name in PARENT_TALL_SIGNATURES)
    xwide = all(hasattr(lib, name) for name in PARENT_XWIDE_ENTRIES)
    signatures = {**_build.SIGNATURES, **PARENT_TALL_SIGNATURES}
    for name in (PARENT_ENTRIES + (PARENT_ROW_ENTRIES if rows else ())
                 + (PARENT_DRAW_ENTRIES if draws else ())
                 + (PARENT_TAIL_ENTRIES if tail else ())
                 + (PARENT_DEEP_ENTRIES if deep else ())
                 + (PARENT_XWIDE_ENTRIES if xwide else ())
                 + (tuple(PARENT_TALL_SIGNATURES) if tall else ())):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = signatures[name], ctypes.c_int
    return lib


def alt_libraries(dirs) -> dict:
    """Directory name -> a library of that directory's ``*.cu`` sources
    (other versions of some of ``kernels/csrc``'s sources, beside the headers
    they include), each built by its own nvcc, all started together, under
    the git-ignored build directory, every entry of ``_build.SIGNATURES``
    it has given its current arguments; prints each build's ptxas lines."""
    from blockpuzzle_tpu_torch.kernels import _build

    builds = {}
    for d in map(pathlib.Path, dirs):
        out = _build.BUILD_DIR / "alt" / d.name
        out.mkdir(parents=True, exist_ok=True)
        so = out / f"libbp_{d.name}.so"
        builds[d.name] = so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             *map(str, sorted(d.glob("*.cu")))], stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, (so, proc) in builds.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        for line in chip_smoke.ptxas_lines(err):
            print(f"[alt] {name} ptxas: {line}")
        lib = ctypes.CDLL(str(so))
        for entry, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


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


def kernel_turns(card: str, parent_csrc, presets=chip_smoke.PACKED_PRESETS,
                 only=None) -> None:
    """The kernels of ``presets`` (all, or the names in ``only``) timed as
    the ``kernels`` part says, in turns with ``parent_csrc``'s where it is
    given."""
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
    for name in presets:
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
                   "packed_mask": lambda: pmk(words, queue),
                   "packed_legal_words": lambda: pmk.words(words, queue)}
        if only is not None:
            current = {k: f for k, f in current.items() if k in only}
        earlier = {}
        if lib is not None:
            calls = parent_calls(lib, cfg, mk, ck, pak, pmk)
            earlier = {"mask": lambda: calls["mask"](board, queue),
                       "clear": lambda: calls["clear"](board),
                       "apply": lambda: calls["apply"](board, cover, valid),
                       "legality": lambda: calls["legality"](board),
                       "packed_apply": lambda: calls["packed_apply"](*args),
                       "packed_mask": lambda: calls["packed_mask"](words, queue)}
            earlier = {k: f for k, f in earlier.items() if k in current}
            for k in earlier:  # the words entry has no earlier counterpart here
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


def draw_calls(lib, key, counter, mask, words, width, num_pieces, board_width) -> dict:
    """Callables that launch the draws of the library ``lib`` (its entry
    points taking the current ones' arguments) on these inputs: the
    ``width``-wide step deal (2S) at per-env counters, the S-wide reset
    deal at counter 0 for all, the argmax and the words draw at counter
    7."""
    import torch

    from blockpuzzle_tpu_torch.env import rng
    from blockpuzzle_tpu_torch.kernels import _build

    n, dev = key.shape[0], key.device

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def deal(per_env=True, tag=rng.TAG_STEP, lanes=width):
        out = torch.empty((n, lanes), dtype=torch.int32, device=dev)
        _build.check(lib.bp_deal(key.data_ptr(), counter.data_ptr() if per_env else None, 0,
                                 tag, lanes, num_pieces, out.data_ptr(), n, stream()),
                     "bp_deal")
        return out

    def uniform_legal():
        out = torch.empty(n, dtype=torch.int64, device=dev)
        _build.check(lib.bp_uniform_legal(key.data_ptr(), 7, rng.TAG_POLICY, mask.data_ptr(),
                                          out.data_ptr(), n, mask.shape[1], stream()),
                     "bp_uniform_legal")
        return out

    def words_select():
        out = torch.empty(n, dtype=torch.int64, device=dev)
        _build.check(lib.bp_words_select(key.data_ptr(), 7, rng.TAG_POLICY, words.data_ptr(),
                                         out.data_ptr(), n, words.shape[1], board_width,
                                         stream()), "bp_words_select")
        return out

    return {"deal": deal,
            "reset_deal": lambda: deal(False, rng.TAG_RESET, width // 2),
            "uniform_legal": uniform_legal, "words_select": words_select}


def draw_turns(card: str, parent_csrc) -> None:
    """The draw kernels (B9 deal, the step's 2S-wide and the S-wide reset
    deal; B2 uniform_legal, B2w words_select) at N = 49152 on every packed
    preset, on ``chip_smoke.draw_inputs``: device times, and with
    ``parent_csrc`` the earlier sources' draws held bit-equal to the
    current ones and timed in turns (earlier, current, current, earlier);
    then the launch floor, an empty launch's device time
    (``torch.cuda._sleep(0)``) back to back."""
    import torch

    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.config import PRESETS
    from blockpuzzle_tpu_torch.env import rng
    from blockpuzzle_tpu_torch.kernels import (
        DealKernel, UniformLegalKernel, WordsSelectKernel, _build,
    )

    _build.library()
    for line in chip_smoke.ptxas_lines(_build.library_path().with_suffix(".log").read_text()):
        if "deal" in line or "uniform_legal" in line or "words_select" in line:
            print(f"[draws] current ptxas: {line}")
    lib = parent_library(pathlib.Path(parent_csrc)) if parent_csrc else None
    if lib is not None and not hasattr(lib, "bp_deal"):
        raise SystemExit("chip_measure: the earlier sources have no draw kernels")
    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    ul, ws = UniformLegalKernel(dev), WordsSelectKernel(dev)
    for name in chip_smoke.PACKED_PRESETS:
        cfg = PRESETS[name]()
        dk = DealKernel(rules.tables_for(cfg).num_pieces, dev)
        key, counter, mask, words = chip_smoke.draw_inputs(cfg, n, 0)
        width = 2 * cfg.queue_size
        inputs = (key, counter, mask, words, width, dk.num_pieces, cfg.width)
        current = {"deal": lambda: dk(key, counter, rng.TAG_STEP, width),
                   "reset_deal": lambda: dk(key, 0, rng.TAG_RESET, cfg.queue_size),
                   "uniform_legal": lambda: ul(key, 7, mask),
                   "words_select": lambda: ws(key, 7, words, cfg.width)}
        earlier = draw_calls(lib, *inputs) if lib is not None else {}
        for k in earlier:
            if not torch.equal(current[k](), earlier[k]()):
                raise AssertionError(f"{k} ({name}): current != earlier kernel")
        for k, fn in current.items():
            if k in earlier:
                old1, new1, new2, old2 = (chip_smoke.cuda_ms(f) for f in (
                    earlier[k], fn, fn, earlier[k]))
                print(f"[draws] {k} {name} N={n} device ms in turns: earlier "
                      f"{old1:.6f}, current {new1:.6f}, current {new2:.6f}, earlier "
                      f"{old2:.6f} ({card})")
            else:
                print(f"[draws] {k} {name} N={n}: device {chip_smoke.cuda_ms(fn):.6f} ms "
                      f"({card})")
        if lib is not None:
            print(f"[draws] {name}: current draws == earlier ones (bit-equal)")
    floors = [chip_smoke.cuda_ms(lambda: torch.cuda._sleep(0)) for _ in range(3)]
    print(f"[draws] launch floor, torch.cuda._sleep(0) back to back, device ms: "
          f"{', '.join(f'{f:.6f}' for f in floors)} ({card})")


# boards the draws part times B2w on beside the presets: the words path's
# boards of more than 32 rows (``tall_words``, ``tall36r3_words``,
# ``huge_words``) and 512x8
SELECT_BOARDS = {"33x9": chip_smoke.TALL, "36x9r3": chip_smoke.TALL36R3,
                 "130x8": chip_smoke.HUGE, "512x8": chip_smoke.DEEP_CASES["512x8"]}
# B2w's segment widths, threads an env
SELECT_LANES = (1, 2, 4, 8, 16, 32)


def select_turns(card: str, lib, alts=None, rounds: int = 5) -> None:
    """B2w at N = 49152 on the presets and ``SELECT_BOARDS``
    (``chip_smoke.draw_inputs``, seed 0, counter 7): where ``lib`` is given
    first the earlier library's ``bp_words_select``, then the wrapper's
    kernel (the host's segment width), then the kernel at each other width
    (``chip_smoke.select_pick``), and each library of ``alts`` (label ->
    library, ``alt_libraries``) that has ``bp_words_select``; held
    bit-equal, timed in turns for ``rounds`` rounds (``group_turns``):
    medians and shares of the bound."""
    import torch

    from blockpuzzle_tpu_torch.config import PRESETS, EnvConfig
    from blockpuzzle_tpu_torch.kernels import WordsSelectKernel
    from blockpuzzle_tpu_torch.kernels.draws import select_lanes
    from blockpuzzle_tpu_torch.utils.bounds import call_bound

    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    ws = WordsSelectKernel(dev)
    boards = {**{k: PRESETS[k]() for k in chip_smoke.PACKED_PRESETS},
              **{k: EnvConfig(**v) for k, v in SELECT_BOARDS.items()}}
    for name, cfg in boards.items():
        key, _, mask, words = chip_smoke.draw_inputs(cfg, n, 0)
        args = (key, 7, words, cfg.width)
        lanes = select_lanes(words.shape[1])
        fns = {}
        if lib is not None:
            fns["earlier"] = draw_calls(lib, key, None, mask, words, 2, 1, cfg.width)[
                "words_select"]
        fns[f"words_select ({lanes} lanes)"] = functools.partial(ws, *args)
        for other in SELECT_LANES:
            if other != lanes:
                fns[f"{other} lanes"] = functools.partial(chip_smoke.select_pick(other), *args)
        for label, alt in (alts or {}).items():
            if hasattr(alt, "bp_words_select"):
                fns[label] = draw_calls(alt, key, None, mask, words, 2, 1, cfg.width)[
                    "words_select"]
        bound = {"words_select": call_bound("words_select", cfg, args, (ws(*args),))}
        empty = int((words == 0).all(dim=1).sum())
        print(f"[draws] words_select {name}: S*H = {words.shape[1]}, {empty} envs with no "
              "legal action")
        group_turns(card, "draws", name, {"words_select": fns}, bound, rounds)


# boards the kernels part times B7w on: the presets and a board of 17-31
# rows, where a warp holds one env-slot
WORDS_BOARDS = {**{k: None for k in chip_smoke.PACKED_PRESETS}, "24x9": chip_smoke.ROWS24}


def words_turns(card: str, lib, alts=None, rounds: int = 5) -> None:
    """B7w and B7 at N = 49152 on ``WORDS_BOARDS`` (``chip_smoke.kernel_inputs``,
    seed 0): where ``lib`` is given first the earlier library's
    ``bp_packed_words`` and ``bp_packed_mask`` (``EarlierMask``), then the
    wrappers' kernels, B7w also through the words kernel the wrapper does not
    pick there (the bit-row kernel or the tall one, ``chip_smoke.words_pick``)
    and through each library of ``alts`` that has ``bp_packed_words``
    (``EarlierMask``) or ``bp_packed_words_tall``; each group held
    bit-equal, then timed in turns (``group_turns``)."""
    import torch

    from blockpuzzle_tpu_torch.config import PRESETS, EnvConfig
    from blockpuzzle_tpu_torch.kernels import PackedMaskKernel
    from blockpuzzle_tpu_torch.kernels.packed import pack_words
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    for name, shape in WORDS_BOARDS.items():
        cfg = PRESETS[name]() if shape is None else EnvConfig(**shape)
        pmk = PackedMaskKernel(cfg, dev)
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in chip_smoke.kernel_inputs(cfg, n, seed=0))
        words = pack_words(board.view(n, cfg.height, cfg.width))
        words_fns, mask_fns = {}, {}
        if lib is not None:
            earlier = EarlierMask(lib, pmk)
            words_fns["earlier"] = functools.partial(earlier.words, words, queue)
            mask_fns["earlier"] = functools.partial(earlier, words, queue)
        words_fns[f"{pmk.words_name} (the wrapper's)"] = functools.partial(
            pmk.words, words, queue)
        mask_fns[pmk.name] = functools.partial(pmk, words, queue)
        other = "tall" if pmk.words_kind == "rows" else "rows"
        words_fns[f"the {other} words kernel"] = functools.partial(
            chip_smoke.words_pick(cfg, pmk, other), words, queue)
        for label, alt in (alts or {}).items():
            if hasattr(alt, "bp_packed_words"):
                words_fns[label] = functools.partial(EarlierMask(alt, pmk).words, words, queue)
            if hasattr(alt, "bp_packed_words_tall"):
                words_fns[f"{label}, tall"] = functools.partial(
                    chip_smoke.words_pick(cfg, pmk, "tall", lib=alt), words, queue)
        outs = {"packed_legal_words": pmk.words(words, queue), "packed_mask": pmk(words, queue)}
        bound = kernel_bounds(cfg, board, queue, cover, valid, words, attrs, r, c, outs)
        group_turns(card, "kernels", name, {"packed_legal_words": words_fns,
                                            "packed_mask": mask_fns}, bound, rounds)


class EarlierSelect:
    """Stands in for the words sampler's ``WordsSelectKernel``: the earlier
    library ``lib``'s ``bp_words_select``."""

    def __init__(self, lib):
        self.lib = lib

    def __call__(self, key, counter, words, width):
        import torch

        from blockpuzzle_tpu_torch.env import rng
        from blockpuzzle_tpu_torch.kernels import _build

        out = torch.empty(key.shape[0], dtype=torch.int64, device=key.device)
        _build.check(self.lib.bp_words_select(
            key.data_ptr(), counter & rng.MASK32, rng.TAG_POLICY, words.data_ptr(),
            out.data_ptr(), key.shape[0], words.shape[1], width,
            torch.cuda.current_stream(key.device).cuda_stream), "earlier bp_words_select")
        return out


def words_step_turns(card: str, lib, steps: int = 20) -> None:
    """The words rollout's step (the default engine, ``WordsSampler``) at N =
    49152 on 10x10 and 33x9, one engine each carrying its state: where
    ``lib`` is given with the earlier library's B2w and, on 10x10, its B7
    and B7w swapped in (``EarlierSelect``, ``EarlierMask``; the tall
    kernels of 33x9 are the same in both), and with the current ones, in
    turns earlier, current, current, earlier (else the current ones
    twice): host ms a step over ``steps`` unprofiled steps, then ``steps``
    steps under ``torch.profiler``: device kernels, device ms and busy
    share a step, and the words kernel's and the select's device ms a
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blockpuzzle_tpu_torch import PRESETS, make_env
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.sampler import WordsSampler

    n = chip_smoke.N_MAIN
    order = ("earlier", "current", "current", "earlier") if lib is not None else (
        "current", "current")
    for name, cfg in (("10x10", PRESETS["default"]()), ("33x9", EnvConfig(**chip_smoke.TALL))):
        env = make_env(cfg, device="cuda")
        draw = WordsSampler(1, n, env.device)
        current = {"mask": env.packed_mask_kernel, "select": draw.kernel}
        kernels = {"current": current}
        if lib is not None:
            kernels["earlier"] = {"mask": EarlierMask(lib, current["mask"])
                                  if cfg.height <= 32 else current["mask"],
                                  "select": EarlierSelect(lib)}
        state, ts = env.init(0, n)

        def run(k):
            nonlocal state, ts
            for _ in range(k):
                state, ts = env.step(state, draw(env, state.board, state.queue))
            torch.cuda.synchronize()

        for which in order:
            env.packed_mask_kernel, draw.kernel = (kernels[which]["mask"],
                                                   kernels[which]["select"])
            run(5)                                         # warm-up
            t0 = time.perf_counter()
            run(steps)
            step_ms = 1e3 * (time.perf_counter() - t0) / steps
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(steps)
            device = device_events(prof)
            if not device:
                print("[words] the profiler saw no device events: not measured")
                continue
            busy = busy_us(device) / steps / 1e3
            part = {k: sum(e.time_range.elapsed_us() for e in device
                           if any(key in e.name for key in keys)) / steps / 1e3
                    for k, keys in (("words", ("packed_words_kernel", "anchor_kernel<true")),
                                    ("select", ("words_select_kernel",)))}
            print(f"[words] words rollout step, {name}, N={n}, {which} kernels: "
                  f"{step_ms:.4f} ms per step, {len(device) / steps:.2f} device kernels, "
                  f"{sum(e.time_range.elapsed_us() for e in device) / steps / 1e3:.6f} ms "
                  f"device time a step, busy {busy:.4f} ms = {100 * busy / step_ms:.1f}%, "
                  f"legal words {part['words']:.6f} ms, select {part['select']:.6f} ms a "
                  f"step ({card})")
        env.packed_mask_kernel, draw.kernel = current["mask"], current["select"]


class EarlierTail:
    """Stands in for the kernel library inside ``PackedTailKernel``'s calls
    (``tail_library``), routing them to an earlier library's
    ``bp_packed_tail`` and ``bp_packed_unpack`` (the arguments
    ``_build.SIGNATURES`` gives them) at the tile the two took before the
    tail's ring, which the unpack keeps (``unpack_block_envs``)."""

    def __init__(self, lib, cfg):
        from blockpuzzle_tpu_torch.kernels.tail import unpack_block_envs

        self.lib, self.envs = lib, unpack_block_envs(cfg)

    def bp_packed_tail_ring(self, *args):
        *head, _envs, _stages, _blocks, stream = args
        return self.lib.bp_packed_tail(*head, self.envs, stream)

    def bp_packed_unpack(self, words, out, n, height, width, _envs, stream):
        return self.lib.bp_packed_unpack(words, out, n, height, width, self.envs, stream)


class TailParts:
    """Stands in for the kernel library inside ``PackedTailKernel``'s calls
    (``tail_library``), routing the tail to ``bp_packed_tail_parts`` with
    ``parts``: a build with only some of the kernel's parts."""

    def __init__(self, lib, parts: int):
        self.lib, self.parts = lib, parts

    def bp_packed_tail_ring(self, *args):
        return self.lib.bp_packed_tail_parts(*args[:-1], self.parts, args[-1])


def tail_library(lib):
    """A callable that runs ``fn`` with ``kernels/_build.library()``
    answering ``lib`` (an ``EarlierTail``)."""
    from blockpuzzle_tpu_torch.kernels import _build

    def run(fn):
        saved = _build.library
        _build.library = lambda: lib
        try:
            return fn()
        finally:
            _build.library = saved

    return run


def turns_ms(fns: dict, rounds: int) -> dict:
    """name -> median device ms (``chip_smoke.cuda_ms``) over ``rounds``
    rounds, each timing the callables in order and back (a, b, b, a)."""
    got = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for k in order:
            got[k].append(chip_smoke.cuda_ms(fns[k]))
    return {k: statistics.median(v) for k, v in got.items()}


def tail_turns(card: str, parent_csrc, rounds: int = 5) -> None:
    """B10 at N = 49152 on ``chip_smoke.TAIL_BOARDS`` (dense boards, and
    mid-game ones on the default preset; the step's call with auto-reset):
    the tail and its unpack, device times and shares of their bounds
    (``utils/bounds.py``); with ``parent_csrc`` the earlier sources'
    ``bp_packed_tail`` and ``bp_packed_unpack`` at their own tiles on the
    same inputs, every output held bit-equal to the current kernels'
    (floats as their int32 bits), the two timed in turns (earlier, current,
    current, earlier) ``rounds`` times, medians printed (``tail_turn``).
    Then the tail at other tiles, rings and grids than the wrapper's
    (``tail_shapes``), on the default preset built with only some of its
    parts (``tail_parts``), and the default engine's step on 33x9 profiled
    as the ``rollout`` part does."""
    import dataclasses

    import torch

    from blockpuzzle_tpu_torch.config import PRESETS, EnvConfig
    from blockpuzzle_tpu_torch.kernels import PackedTailKernel, _build

    _build.library()
    for line in chip_smoke.ptxas_lines(_build.library_path().with_suffix(".log").read_text()):
        if "packed_tail" in line or "packed_unpack" in line:
            print(f"[tail] current ptxas: {line}")
    lib = parent_library(pathlib.Path(parent_csrc)) if parent_csrc else None
    if lib is not None and not hasattr(lib, "bp_packed_tail"):
        raise SystemExit("chip_measure: the earlier sources have no tail kernel")
    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    for name, shape in chip_smoke.TAIL_BOARDS.items():
        # the wrapper as the step binds it, on phase 1's dense inputs and, on
        # the default preset, on mid-game boards, where few games end
        cfg = PRESETS[name]() if shape is None else EnvConfig(**shape)
        k = PackedTailKernel(cfg, dev)
        knobs = dataclasses.replace(cfg, **chip_smoke.TAIL_KNOBS)
        print(f"[tail] {name}: tile {k.envs}, {k.stages} stages, unpack tile "
              f"{k.unpack_envs}")
        for density in (None, MID_GAME) if name == "default" else (None,):
            inputs = chip_smoke.tail_inputs(knobs, n, seed=0, density=density)
            tail_turn(card, f"{name} {'dense' if density is None else 'mid-game'}", k,
                      inputs, lib, rounds)
    tail_shapes(card)
    tail_parts(card, rounds)
    rollout_breakdown(card, EnvConfig(**chip_smoke.TALL), {"packed": ENGINES["packed"]},
                      "tail")


# the chance that a cell of a mid-game board is full
MID_GAME = 0.3


def tail_turn(card: str, what: str, k, inputs, lib, rounds: int) -> None:
    """``tail_turns`` on one board and input set: the tail (auto-reset) and
    the unpack of ``k``, beside the earlier library's where ``lib`` is
    given."""
    import torch

    from blockpuzzle_tpu_torch.utils.bounds import call_bound

    n = inputs[0].shape[0]
    current = {"packed_tail": lambda: k(*inputs, True),
               "packed_unpack": lambda: k.unpack(inputs[0])}
    outs = {key: fn() for key, fn in current.items()}
    bound = {"packed_tail": call_bound("packed_tail", k.cfg, inputs + (True,),
                                       outs["packed_tail"]),
             "packed_unpack": call_bound("packed_unpack", k.cfg, inputs[:1],
                                         (outs["packed_unpack"],))}
    tail = outs["packed_tail"]
    done = float((tail.terminated | tail.truncated).float().mean())
    if lib is None:
        for key, fn in current.items():
            ms = chip_smoke.cuda_ms(fn)
            print(f"[tail] {key} {what} N={n} (done share {done:.4f}): device {ms:.6f} ms, "
                  f"{100 * bound[key]['bound_ms'] / ms:.1f}% of its "
                  f"{bound[key]['bound_ms']:.6f} ms bound ({card})")
        return
    run = tail_library(EarlierTail(lib, k.cfg))
    earlier = {key: (lambda fn=fn: run(fn)) for key, fn in current.items()}
    for key in current:
        got, want = current[key](), earlier[key]()
        got, want = ((chip_smoke.tail_fields(got), chip_smoke.tail_fields(want))
                     if key == "packed_tail" else ([got], [want]))
        if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{key} ({what}): current != earlier kernel")
    for key in current:
        med = turns_ms({"earlier": earlier[key], "current": current[key]}, rounds)
        b = bound[key]["bound_ms"]
        print(f"[tail] {key} {what} N={n} (done share {done:.4f}) device ms, medians of "
              f"{rounds} rounds in turns: earlier {med['earlier']:.6f} "
              f"({100 * b / med['earlier']:.1f}% of the bound), current "
              f"{med['current']:.6f} ({100 * b / med['current']:.1f}%), bound {b:.6f} ms, "
              f"earlier / current {med['earlier'] / med['current']:.3f} ({card})")
    print(f"[tail] {what}: current tail and unpack == earlier ones (bit-equal)")


# builds of the tail with only some of its parts (csrc/packed_tail.cu
# ``Part``): none (the ring's loads alone), termination (the mask OR), with
# the flags and scalars, with the mask output, with the board views and
# words, all
TAIL_PARTS = {"loads": 0, "done": 1, "done+scalars": 9, "done+mask": 3, "done+boards": 5,
              "all": 15}


def tail_parts(card: str, rounds: int) -> None:
    """The tail on the default preset at N = 49152, dense and mid-game
    inputs, built with only some of its parts (``TAIL_PARTS``), all on the
    wrapper's tile, ring and grid, timed in turns: what each part adds to
    the ring's loads."""
    import dataclasses

    import torch

    from blockpuzzle_tpu_torch.config import PRESETS
    from blockpuzzle_tpu_torch.kernels import PackedTailKernel, _build

    cfg = PRESETS["default"]()
    k = PackedTailKernel(cfg, torch.device("cuda"))
    knobs = dataclasses.replace(cfg, **chip_smoke.TAIL_KNOBS)
    for density in (None, MID_GAME):
        inputs = chip_smoke.tail_inputs(knobs, chip_smoke.N_MAIN, seed=0, density=density)
        fns = {}
        for name, parts in TAIL_PARTS.items():
            run = tail_library(TailParts(_build.library(), parts))
            fns[name] = lambda run=run: run(lambda: k(*inputs, True))
        med = turns_ms(fns, rounds)
        print(f"[tail] parts, default {'dense' if density is None else 'mid-game'} "
              f"N={chip_smoke.N_MAIN}, device ms (medians of {rounds} rounds in turns): "
              + ", ".join(f"{name} {ms:.6f}" for name, ms in med.items()) + f" ({card})")


# board -> (envs a tile, stages a ring, blocks an SM; 0: the kernel's choice)
# timed beside one another
TAIL_SHAPES = {"default": ((32, 3, 0), (64, 1, 0), (64, 2, 0), (64, 3, 0), (64, 3, 2),
                           (128, 2, 0)),
               "tenten": ((16, 2, 0), (16, 3, 0), (32, 3, 0)),
               "33x9": ((8, 3, 0), (16, 3, 0), (31, 3, 0)),
               "130x8": ((4, 3, 0), (8, 1, 0), (8, 2, 0))}


def tail_shapes(card: str, rounds: int = 3) -> None:
    """The tail at N = 49152 on each board of ``TAIL_SHAPES`` at each of its
    tiles, rings and grids, held bit-equal to the wrapper's own, timed in
    turns (the shapes in order and back) ``rounds`` times: medians."""
    import dataclasses

    import torch

    from blockpuzzle_tpu_torch.config import PRESETS, EnvConfig
    from blockpuzzle_tpu_torch.kernels import PackedTailKernel

    dev = torch.device("cuda")
    for name, shapes in TAIL_SHAPES.items():
        shape = chip_smoke.TAIL_BOARDS[name]
        cfg = PRESETS[name]() if shape is None else EnvConfig(**shape)
        inputs = chip_smoke.tail_inputs(dataclasses.replace(cfg, **chip_smoke.TAIL_KNOBS),
                                        chip_smoke.N_MAIN, seed=0)
        want = chip_smoke.tail_fields(PackedTailKernel(cfg, dev)(*inputs, True))
        fns = {}
        for envs, stages, per_sm in shapes:
            k = PackedTailKernel(cfg, dev)
            k.envs, k.stages, k.blocks_per_sm = envs, stages, per_sm
            got = chip_smoke.tail_fields(k(*inputs, True))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"packed_tail {name} at {envs, stages, per_sm} != the "
                                     "wrapper's")
            fns[envs, stages, per_sm] = lambda k=k: k(*inputs, True)
        for (envs, stages, per_sm), ms in turns_ms(fns, rounds).items():
            print(f"[tail] packed_tail {name} N={chip_smoke.N_MAIN}, tile {envs}, {stages} "
                  f"stages, blocks an SM {per_sm or 'auto'}: device {ms:.6f} ms, median of "
                  f"{rounds} rounds in turns ({card})")


# boards of more than 128 rows the ``deep`` part times K3 and B7 on
DEEP_BOARDS = {"130x8": chip_smoke.HUGE, "512x8": chip_smoke.DEEP_CASES["512x8"]}


def earlier_deep_calls(lib, cfg, ck, pmk):
    """Callables with the current wrappers' arguments that launch the
    kernels the deep clear and the windowed packed mask and words replace:
    from the earlier library ``lib`` its general u8 clear (``bp_clear``,
    what the clear took on boards of more than 128 rows before its deep
    kernel) and its general packed mask and words (``bp_packed_mask_general``,
    ``bp_packed_words_general``, a thread an anchor row); without ``lib`` the
    same kernels of the current library (``bp_clear``,
    ``bp_packed_mask_general_pick`` and ``bp_packed_words_general_pick`` with
    their thread-an-anchor-row kernels).  Returns (clear, mask, words)."""
    import torch

    from blockpuzzle_tpu_torch.kernels import _build

    if lib is None:
        return (chip_smoke.general_calls(cfg, None, ck)[1],
                chip_smoke.general_mask_pick(cfg, pmk, windowed=False),
                chip_smoke.general_mask_pick(cfg, pmk, windowed=False, words=True))
    dev, lines = ck.device, ck.lines

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def clear(board):
        n = board.shape[0]
        out, k = torch.empty_like(board), torch.empty(n, dtype=torch.int32, device=dev)
        _build.check(lib.bp_clear(
            board.data_ptr(), lines.line_cells.data_ptr(), lines.line_len.data_ptr(),
            out.data_ptr(), k.data_ptr(), n, cfg.num_cells, lines.line_cells.shape[0],
            lines.line_cells.shape[1], stream()), "earlier bp_clear")
        return out, k

    def mask(words, queue):
        n = words.shape[0]
        out = torch.empty((n, cfg.queue_size * cfg.num_cells), dtype=torch.bool, device=dev)
        _build.check(lib.bp_packed_mask_general(*pmk._args(words, queue, out), stream()),
                     "earlier bp_packed_mask_general")
        return out

    def legal_words(words, queue):
        n = words.shape[0]
        out = torch.empty((n, cfg.queue_size * cfg.height), dtype=torch.int64, device=dev)
        _build.check(lib.bp_packed_words_general(*pmk._args(words, queue, out), stream()),
                     "earlier bp_packed_words_general")
        return out

    return clear, mask, legal_words


def group_turns(card: str, tag: str, name: str, groups: dict, bound: dict,
                rounds: int, n: int = chip_smoke.N_MAIN) -> None:
    """Each group of ``groups`` (kernel -> {label: callable}) held bit-equal,
    then timed in turns, in order and back, ``rounds`` times (``turns_ms``):
    medians, the share of the kernel's ``bound`` (``utils/bounds.py``) and
    each median over the group's first; ``n``: the envs of the inputs."""
    import torch

    for key, fns in groups.items():
        got = [fn() for fn in fns.values()]
        got = [g if isinstance(g, tuple) else (g,) for g in got]
        if not all(torch.equal(a, b) for g in got[1:] for a, b in zip(g, got[0])):
            raise AssertionError(f"{key} {name}: the kernels disagree")
    print(f"[{tag}] {name} N={n}: " + "; ".join(
        f"{' == '.join(fns)} (bit-equal)" for fns in groups.values()))
    for key, fns in groups.items():
        med = turns_ms(fns, rounds)
        b = bound[key]["bound_ms"]
        first = next(iter(med.values()))
        for k, ms in med.items():
            print(f"[{tag}] {k} {name} N={n}: median {ms:.6f} ms of {rounds} rounds in "
                  f"turns, {100 * b / ms:.1f}% of the {b:.6f} ms bound "
                  f"({bound[key]['bytes']} B), {ms / first:.3f}x the first ({card})")


def deep_turns(card: str, lib, rounds: int = 5) -> None:
    """K3, B7 and B7w on ``DEEP_BOARDS`` at N = 49152
    (``chip_smoke.kernel_inputs``, seed 0): the deep clear beside the
    general clear launched directly (``bp_clear``), the windowed general
    packed mask's and words' entries beside their thread-an-anchor-row
    kernels (``bp_packed_mask_general_pick``, ``bp_packed_words_general_pick``),
    and, where ``lib`` is given, first the earlier library's ``bp_clear``,
    ``bp_packed_mask_general`` and ``bp_packed_words_general``; each group
    held bit-equal, then timed in turns (``group_turns``)."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import ClearScanKernel, PackedMaskKernel
    from blockpuzzle_tpu_torch.kernels.packed import pack_words
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    for name, shape in DEEP_BOARDS.items():
        cfg = EnvConfig(**shape)
        ck, pmk = ClearScanKernel(cfg, dev), PackedMaskKernel(cfg, dev)
        if (ck.name, pmk.name, pmk.words_name) != ("clear_deep", "packed_mask_general",
                                                   "packed_legal_words_general"):
            raise AssertionError(f"{name}: the wrappers picked {ck.name}, {pmk.name}")
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in chip_smoke.kernel_inputs(cfg, n, seed=0))
        words = pack_words(board.view(n, cfg.height, cfg.width))
        general_clear, mask_rows, words_rows = earlier_deep_calls(None, cfg, ck, pmk)
        groups = {"clear_deep": {}, "packed_mask_general": {},
                  "packed_legal_words_general": {}}
        if lib is not None:
            earlier_clear, earlier_mask, earlier_words = earlier_deep_calls(lib, cfg, ck, pmk)
            groups["clear_deep"]["earlier bp_clear"] = lambda: earlier_clear(board)
            groups["packed_mask_general"]["earlier bp_packed_mask_general"] = (
                lambda: earlier_mask(words, queue))
            groups["packed_legal_words_general"]["earlier bp_packed_words_general"] = (
                lambda: earlier_words(words, queue))
        groups["clear_deep"].update({"clear_deep": lambda: ck(board),
                                     "clear_general": lambda: general_clear(board)})
        groups["packed_mask_general"].update({
            "packed_mask_general": lambda: pmk(words, queue),
            "thread-an-anchor-row kernel": lambda: mask_rows(words, queue)})
        groups["packed_legal_words_general"].update({
            "packed_legal_words_general": lambda: pmk.words(words, queue),
            "thread-an-anchor-row words kernel": lambda: words_rows(words, queue)})
        outs = {"clear_deep": ck(board), "packed_mask_general": pmk(words, queue),
                "packed_legal_words_general": pmk.words(words, queue)}
        bound = kernel_bounds(cfg, board, queue, cover, valid, words, attrs, r, c, outs)
        group_turns(card, "deep", name, groups, bound, rounds)


# boards the ``apply`` part times K2 on: its wide, tall and deep kernels
APPLY_BOARDS = {"8x40": chip_smoke.WIDE, "33x9": chip_smoke.TALL, "130x8": chip_smoke.HUGE,
                "512x8": chip_smoke.DEEP_CASES["512x8"], "8x136": chip_smoke.XWIDE,
                "40x136": chip_smoke.XTALL, "2x1056": chip_smoke.W1056}


def apply_turns(card: str, lib, rounds: int = 5) -> None:
    """K2 on ``APPLY_BOARDS`` at N = 49152 (``chip_smoke.kernel_inputs``,
    seed 0): the wide, tall, deep or xwide apply beside the general apply launched
    directly on the same inputs (``chip_smoke.general_apply``, ``bp_apply``),
    and, where ``lib`` is given, first the earlier library's ``bp_apply``;
    held bit-equal, then timed in turns (``group_turns``)."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import ApplyKernel
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    for name, shape in APPLY_BOARDS.items():
        cfg = EnvConfig(**shape)
        ak = ApplyKernel(cfg, dev)
        if ak.kind not in ("wide", "tall", "deep", "xwide"):
            raise AssertionError(f"{name}: the wrapper picked {ak.name}")
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in chip_smoke.kernel_inputs(cfg, n, seed=0))
        fns = {}
        if lib is not None:
            earlier = chip_smoke.general_apply(cfg, ak, lib)
            fns["earlier bp_apply"] = lambda: earlier(board, cover, valid)
        general = chip_smoke.general_apply(cfg, ak)
        fns.update({ak.name: lambda: ak(board, cover, valid),
                    "apply_general": lambda: general(board, cover, valid)})
        bound = kernel_bounds(cfg, board, queue, cover, valid, None, attrs, r, c,
                              {ak.name: ak(board, cover, valid)})
        print(f"[apply] {name}: {ak.name} launch shape {ak.shape} (envs a warp, warps a "
              "block)")
        group_turns(card, "apply", name, {ak.name: fns}, bound, rounds)


def swap_turns(card: str, tag: str, what: tuple, env, attr: str, kernels: dict, labels: dict,
               keys, steps: int = 20) -> None:
    """``env``'s step at N = 49152 from a fresh ``init``, uniform-legal
    draws, one state carried through, with each of ``kernels`` (label -> a
    callable with the wrapper's arguments) in turn as its ``attr`` kernel
    (``"apply_kernel"``, ``"clear_kernel"``), in order and back: host ms a
    step over ``steps`` unprofiled steps, then ``steps`` steps under
    ``torch.profiler``: device kernels, device ms and busy share a step,
    and the device ms a step of the kernels whose device names hold one of
    ``keys``.  ``what`` names the step and the swapped kernel (``"u8 pallas
    step, 8x40"``, ``"apply"``), ``labels`` a label's printed name.  The
    wrapper is put back at the end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

    n, (step, kind) = chip_smoke.N_MAIN, what
    current = getattr(env, attr)
    state, ts = env.init(0, n)
    draw = UniformLegalSampler(1, n, env.device)

    def run(k):
        nonlocal state, ts
        for _ in range(k):
            state, ts = env.step(state, draw(ts.action_mask))
        torch.cuda.synchronize()

    for which in [*kernels, *reversed(kernels)]:
        setattr(env, attr, kernels[which])
        run(5)                                             # warm-up
        t0 = time.perf_counter()
        run(steps)
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(steps)
        device = device_events(prof)
        if not device:
            print(f"[{tag}] the profiler saw no device events: not measured")
            continue
        busy = busy_us(device) / steps / 1e3
        part = sum(e.time_range.elapsed_us() for e in device
                   if any(k in e.name for k in keys)) / steps / 1e3
        print(f"[{tag}] {step}, N={n}, {which} {kind} ({labels.get(which, which)}): "
              f"{step_ms:.4f} ms per step, {len(device) / steps:.2f} device kernels, "
              f"{sum(e.time_range.elapsed_us() for e in device) / steps / 1e3:.6f} ms "
              f"device time a step, busy {busy:.4f} ms = {100 * busy / step_ms:.1f}%, "
              f"the {kind} {part:.6f} ms a step ({card})")
    setattr(env, attr, current)


def pallas_step_turns(card: str, lib, steps: int = 20,
                      names=("8x40", "33x9", "130x8", "8x136"), others=None) -> None:
    """The u8 apply-kernel step (``backend="pallas"``) on 8x40, 33x9, 130x8
    and 8x136 at N = 49152 (``swap_turns``), one engine each: with the
    general apply swapped in (the earlier library's ``bp_apply`` where
    ``lib`` is given, else the current library's,
    ``chip_smoke.general_apply``), with the wrapper's wide, tall, deep or
    xwide apply and with each apply ``others(cfg, wrapper)`` names (label ->
    a callable with the wrapper's arguments), in turns earlier, current,
    the others, then back.  Where ``names`` is given, those boards only."""
    from blockpuzzle_tpu_torch import make_env
    from blockpuzzle_tpu_torch.config import EnvConfig

    # the device names of the general apply and of the clear kernels' apply
    # instances (the wide, tall and deep ones' last template argument, the
    # xwide one's first: kApply)
    keys = ("::apply_kernel(", "true>(", "clear_xwide_kernel<true,")
    for name in names:
        cfg = EnvConfig(**APPLY_BOARDS[name])
        env = make_env(cfg, device="cuda", backend="pallas", state_impl="u8")
        current = env.apply_kernel
        kernels = {"earlier": chip_smoke.general_apply(cfg, current, lib), "current": current,
                   **(others(cfg, current) if others else {})}
        swap_turns(card, "apply", (f"u8 pallas step, {name}", "apply"), env, "apply_kernel",
                   kernels, {"earlier": "general apply", "current": current.name}, keys,
                   steps)

def xwide_calls(lib, cfg, mk=None, ck=None, ak=None, lk=None, warps=None) -> dict:
    """Callables with the wrappers' arguments that launch ``lib``'s xwide
    mask, clear, apply and legality (``bp_mask_xwide``, ``bp_clear_xwide``,
    ``bp_apply_xwide``, ``bp_legality_xwide``: an earlier build's, an
    ``--alt-csrc`` build's or the current one's; those of the wrappers
    given, ``mk``, ``ck``, ``ak``, ``lk``, that ``lib`` has) at the
    wrappers' launch shapes, or at ``warps`` warps a block."""
    import torch

    from blockpuzzle_tpu_torch.kernels import _build

    wrappers = {"mask": mk, "clear": ck, "apply": ak, "legality": lk}
    dev = next(w for w in wrappers.values() if w is not None).device
    region = cfg.region_size if cfg.region_clear else 0

    def shape(kernel):
        return kernel.shape[0], warps or kernel.shape[1]

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def mask(board, queue):
        n = board.shape[0]
        out = torch.empty((n, cfg.queue_size * cfg.num_cells), dtype=torch.bool, device=dev)
        _build.check(lib.bp_mask_xwide(
            board.data_ptr(), queue.data_ptr(), mk.piece_table.data_ptr(), out.data_ptr(), n,
            cfg.height, cfg.width, cfg.queue_size, mk.num_pieces, mk.max_h, mk.max_w,
            *shape(mk), stream()), "bp_mask_xwide")
        return out

    def clear(board):
        n = board.shape[0]
        out, k = torch.empty_like(board), torch.empty(n, dtype=torch.int32, device=dev)
        _build.check(lib.bp_clear_xwide(
            board.data_ptr(), out.data_ptr(), k.data_ptr(), n, cfg.height, cfg.width, region,
            *shape(ck), stream()), "bp_clear_xwide")
        return out, k

    def apply(board, cover, valid):
        n = board.shape[0]
        out, k = torch.empty_like(board), torch.empty(n, dtype=torch.int32, device=dev)
        legal = torch.empty(n, dtype=torch.bool, device=dev)
        _build.check(lib.bp_apply_xwide(
            board.data_ptr(), cover.data_ptr(), valid.data_ptr(), out.data_ptr(), k.data_ptr(),
            legal.data_ptr(), n, cfg.height, cfg.width, region, *shape(ak), stream()),
            "bp_apply_xwide")
        return out, k, legal

    def legality(board):
        n = board.shape[0]
        out = torch.empty((n, lk.num_pieces, cfg.num_cells), dtype=torch.bool, device=dev)
        _build.check(lib.bp_legality_xwide(
            board.data_ptr(), lk.piece_table.data_ptr(), out.data_ptr(), n, cfg.height,
            cfg.width, lk.num_pieces, lk.max_h, lk.max_w, *shape(lk), stream()),
            "bp_legality_xwide")
        return out

    calls = {"mask": (mask, "bp_mask_xwide"), "clear": (clear, "bp_clear_xwide"),
             "apply": (apply, "bp_apply_xwide"), "legality": (legality, "bp_legality_xwide")}
    return {k: fn for k, (fn, entry) in calls.items()
            if hasattr(lib, entry) and wrappers[k] is not None}


def xwide_times(card: str, lib, alts=None, rounds: int = 5) -> None:
    """The u8 mask, clear, apply and legality on rows of more than 128
    cells at N = 49152 (``chip_smoke.kernel_inputs``, seed 0), on 8x136
    (``chip_smoke.XWIDE``) and ``chip_smoke.XWIDE_CASES`` (boards of at most
    32 rows) and on 40x136 (``chip_smoke.XTALL``) and
    ``chip_smoke.XTALL_CASES`` (more than 32 rows): each xwide kernel beside
    the general kernel it replaces, launched directly on the same inputs
    (``chip_smoke.general_calls``: ``bp_mask``, ``bp_clear``;
    ``chip_smoke.general_apply``: ``bp_apply``;
    ``chip_smoke.general_legality``: ``bp_legality``), and, where ``lib``
    (an earlier build, one whose xwide apply and legality take any height)
    is given, first that build's xwide kernel.  Each ``alts`` build's (``--alt-csrc``) xwide kernels (those it
    has) join their groups on every board; on the boards of more than 32
    rows each kernel also at the other warps a block that fit.  Every group
    held bit-equal, then timed in turns (``group_turns``)."""
    import dataclasses

    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel, _build,
    )
    from blockpuzzle_tpu_torch.kernels.packed import (
        XWIDE_WARPS, xwide_apply_smem_bytes, xwide_smem_bytes,
    )
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    boards = {"8x136": chip_smoke.XWIDE, **chip_smoke.XWIDE_CASES,
              "40x136": chip_smoke.XTALL, **chip_smoke.XTALL_CASES}
    for name, shape in boards.items():
        cfg = EnvConfig(**shape)
        tall = cfg.height > 32
        mk, ck, ak = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev), ApplyKernel(cfg, dev)
        lk = LegalityKernel(cfg, dev)
        got = (mk.name, ck.name, ak.name, lk.name)
        if got != ("mask_xwide", "clear_xwide", "apply_xwide", "legality_xwide"):
            raise AssertionError(f"{name}: the wrappers picked {got}")
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in chip_smoke.kernel_inputs(cfg, n, seed=0))
        args = {"mask": (board, queue), "clear": (board,), "apply": (board, cover, valid),
                "legality": (board,)}
        general_mask, general_clear = chip_smoke.general_calls(cfg, mk, ck)
        general_apply = chip_smoke.general_apply(cfg, ak)
        general_legality = chip_smoke.general_legality(cfg, lk)
        groups = {f"{key}_xwide": {} for key in args}
        if lib is not None:
            for key, fn in xwide_calls(lib, cfg, mk, ck, ak, lk).items():
                groups[f"{key}_xwide"][f"earlier {key}_xwide"] = (
                    lambda fn=fn, key=key: fn(*args[key]))
        current = {"mask": mk, "clear": ck, "apply": ak, "legality": lk}
        general = {"mask": general_mask, "clear": general_clear, "apply": general_apply,
                   "legality": general_legality}
        for key in args:
            groups[f"{key}_xwide"].update({
                f"{key}_xwide": lambda key=key: current[key](*args[key]),
                f"{key}_general": lambda key=key: general[key](*args[key])})
        for alt, alib in (alts or {}).items():  # the alternative builds
            for key, fn in xwide_calls(alib, cfg, mk, ck, ak, lk).items():
                groups[f"{key}_xwide"][f"{alt} {key}_xwide"] = (
                    lambda fn=fn, key=key: fn(*args[key]))
            fn = xwide_calls(alib, cfg, ak=ak, warps=XWIDE_WARPS).get("apply")
            if tall and fn is not None and ak.shape[1] != XWIDE_WARPS:  # at the mask's warps
                groups["apply_xwide"][f"{alt} apply_xwide {XWIDE_WARPS} warps"] = (
                    lambda fn=fn: fn(*args["apply"]))
        every = dataclasses.replace(cfg, queue_size=lk.num_pieces)
        smem = {"mask": lambda e: xwide_smem_bytes(cfg, e),
                "clear": lambda e: xwide_smem_bytes(cfg, e),
                "apply": lambda e: xwide_apply_smem_bytes(cfg, e),
                "legality": lambda e: xwide_smem_bytes(every, e)}
        if tall:  # other warps a block
            per_warp = mk.shape[0]
            for warps in (1, 2, 4, 8):
                other = xwide_calls(_build.library(), cfg, mk, ck, ak, lk, warps=warps)
                for key, fn in other.items():
                    if (warps == current[key].shape[1]
                            or smem[key](per_warp * warps) > 227 * 1024):
                        continue
                    groups[f"{key}_xwide"][f"{key}_xwide {warps} warps"] = (
                        lambda fn=fn, key=key: fn(*args[key]))
        outs = {f"{key}_xwide": current[key](*args[key]) for key in args}
        bound = kernel_bounds(cfg, board, queue, cover, valid, None, attrs, r, c, outs)
        del outs
        print(f"[xwide] {name}: launch shapes (segments a warp, warps a block) mask and clear "
              f"{mk.shape}, apply {ak.shape}, legality {lk.shape}; shared memory a block: "
              f"mask and clear {xwide_smem_bytes(cfg, mk.shape[0] * mk.shape[1])} B, apply "
              f"{xwide_apply_smem_bytes(cfg, ak.shape[0] * ak.shape[1])} B, legality "
              f"{xwide_smem_bytes(every, lk.shape[0] * lk.shape[1])} B")
        group_turns(card, "xwide", name, groups, bound, rounds)


def xwide_step_turns(card: str, lib, alts=None, steps: int = 20) -> None:
    """The u8 apply-kernel step on 8x136 and 40x136 with the general apply
    swapped in (the earlier build's ``bp_apply`` where ``lib`` is given: on
    40x136 the earlier tree's step, whose wrapper took the general apply
    there) and with the xwide apply, in turns (``pallas_step_turns``); on
    40x136 also the xwide apply at ``XWIDE_WARPS`` warps a block and each
    ``alts`` build's (``--alt-csrc``) at the wrapper's and at
    ``XWIDE_WARPS`` warps."""
    from blockpuzzle_tpu_torch.kernels import _build
    from blockpuzzle_tpu_torch.kernels.packed import XWIDE_WARPS

    def others(cfg, ak):
        if cfg.height <= 32:
            return {}
        got = {f"apply_xwide {XWIDE_WARPS} warps":
               xwide_calls(_build.library(), cfg, ak=ak, warps=XWIDE_WARPS)["apply"]}
        for alt, alib in (alts or {}).items():
            for warps in (None, XWIDE_WARPS):
                fn = xwide_calls(alib, cfg, ak=ak, warps=warps).get("apply")
                if fn is not None:                  # a build with an xwide apply
                    got[f"{alt} apply_xwide {warps or ak.shape[1]} warps"] = fn
        return got

    pallas_step_turns(card, lib, steps, names=("8x136", "40x136"), others=others)


def long_times(card: str, lib, alts=None, rounds: int = 5) -> None:
    """K1, K2, K3 and K4 on rows of more than 1024 cells (``chip_smoke.W1056``
    and ``chip_smoke.XLONG_CASES``; ``chip_smoke.kernel_inputs``, seed 0,
    N = 49152, 8192 on the board of more than 32 rows): the long-row xwide
    instances of the mask, clear, apply and legality beside the general
    kernels launched directly on the same inputs
    (``chip_smoke.general_calls``, ``chip_smoke.general_apply``,
    ``chip_smoke.general_legality``), first the earlier build's general
    mask and legality where ``lib`` is given (its wrappers took these boards
    with them; its clear and apply are the long-row ones, joined as
    ``earlier``), each ``alts`` build's (``--alt-csrc``) long-row instances
    it has, and the long-row instances at 1, 2 and 8 warps a block (the
    wrappers take ``XWIDE_WARPS``, or ``XWIDE_APPLY_WARPS`` for the apply
    above 32 rows); every group held bit-equal, then timed in turns
    (``group_turns``)."""
    import dataclasses

    import torch

    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel, _build,
    )
    from blockpuzzle_tpu_torch.kernels.packed import (
        xwide_apply_smem_bytes, xwide_clear_smem_bytes, xwide_smem_bytes, xwide_staged_envs,
    )
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    dev = torch.device("cuda")
    for name, shape in {"2x1056": chip_smoke.W1056, **chip_smoke.XLONG_CASES}.items():
        cfg = EnvConfig(**shape)
        n = chip_smoke.N_MAIN if cfg.height <= 32 else 8192
        mk, ck, ak = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev), ApplyKernel(cfg, dev)
        lk = LegalityKernel(cfg, dev)
        got = (mk.name, ck.name, ak.name, lk.name)
        if got != chip_smoke.u8_kernel_names(cfg) or mk.instance != "xwide_long":
            raise AssertionError(f"{name}: the wrappers picked {got}")
        every = dataclasses.replace(cfg, queue_size=lk.num_pieces)
        board, queue, cover, valid, attrs, r, c = (
            torch.as_tensor(x, device=dev) for x in chip_smoke.kernel_inputs(cfg, n, seed=0))
        args = {"mask": (board, queue), "clear": (board,), "apply": (board, cover, valid),
                "legality": (board,)}
        current = {"mask": mk, "clear": ck, "apply": ak, "legality": lk}
        general_mask, general_clear = chip_smoke.general_calls(cfg, mk, ck)
        general = {"mask": general_mask, "clear": general_clear,
                   "apply": chip_smoke.general_apply(cfg, ak),
                   "legality": chip_smoke.general_legality(cfg, lk)}
        groups = {f"{key}_xwide_long": {} for key in args}
        if lib is not None:
            earlier = {"mask": chip_smoke.general_calls(cfg, mk, ck, lib)[0],
                       "legality": chip_smoke.general_legality(cfg, lk, lib),
                       **{f"{key}_xwide_long": fn for key, fn in
                          xwide_calls(lib, cfg, ck=ck, ak=ak).items()}}
            for key, fn in earlier.items():
                label = f"earlier {key}" if key.endswith("_long") else f"earlier bp_{key}"
                key = key.removesuffix("_xwide_long")
                groups[f"{key}_xwide_long"][label] = lambda fn=fn, key=key: fn(*args[key])
        smem = {"mask": lambda w: xwide_smem_bytes(cfg, w),
                "clear": lambda w: xwide_clear_smem_bytes(cfg, w),
                "apply": lambda w: xwide_apply_smem_bytes(cfg, w),
                "legality": lambda w: xwide_smem_bytes(every, w)}
        staged = {"mask": lambda w: xwide_staged_envs(cfg, w),
                  "legality": lambda w: xwide_staged_envs(every, w)}
        for key in args:
            group = groups[f"{key}_xwide_long"]
            group[f"{key}_xwide_long"] = lambda key=key: current[key](*args[key])
            group[f"{key}_general"] = lambda key=key: general[key](*args[key])
        for alt, alib in (alts or {}).items():  # the alternative builds
            for key, fn in xwide_calls(alib, cfg, mk, ck, ak, lk).items():
                groups[f"{key}_xwide_long"][f"{alt} {key}_xwide_long"] = (
                    lambda fn=fn, key=key: fn(*args[key]))
        for warps in (1, 2, 8):
            other = xwide_calls(_build.library(), cfg, mk, ck, ak, lk, warps=warps)
            for key, fn in other.items():
                envs = staged.get(key, lambda w: w)(warps)
                if (warps == current[key].shape[1] or smem[key](warps) > 227 * 1024
                        or envs * cfg.num_cells >= 1 << 21):
                    continue
                groups[f"{key}_xwide_long"][f"{key}_xwide_long {warps} warps"] = (
                    lambda fn=fn, key=key: fn(*args[key]))
        outs = {f"{key}_xwide_long": current[key](*args[key]) for key in args}
        bound = kernel_bounds(cfg, board, queue, cover, valid, None, attrs, r, c, outs)
        del outs
        print(f"[xwide] {name}: long-row launch shapes (env-slots or envs a warp, warps a "
              f"block) mask {mk.shape}, clear {ck.shape}, apply {ak.shape}, legality "
              f"{lk.shape}; shared memory a block: mask {xwide_smem_bytes(cfg, mk.shape[1])} "
              f"B, clear {xwide_clear_smem_bytes(cfg, ck.shape[1])} B, apply "
              f"{xwide_apply_smem_bytes(cfg, ak.shape[1])} B, legality "
              f"{xwide_smem_bytes(every, lk.shape[1])} B")
        group_turns(card, "xwide", name, groups, bound, rounds, n)
        del board, queue, cover, valid, groups, general, current, mk, ck, ak, lk
        rules._TABLE_CACHE.pop(cfg, None)


def long_step_turns(card: str, lib, steps: int = 20) -> None:
    """The u8 clear-kernel (``backend="jnp"``) and apply-kernel
    (``backend="pallas"``) steps on 2x1056 at N = 49152 (``swap_turns``):
    with the general mask swapped in (the earlier library's ``bp_mask``
    where ``lib`` is given, whose wrapper took this board with it: the
    earlier tree's step; else the current library's) and with the wrapper's
    long-row xwide mask, in turns earlier, current, current, earlier.  The
    clear and the apply are the wrappers' long-row ones in both."""
    from blockpuzzle_tpu_torch import make_env
    from blockpuzzle_tpu_torch.config import EnvConfig

    cfg = EnvConfig(**chip_smoke.W1056)
    for backend in ("jnp", "pallas"):
        env = make_env(cfg, device="cuda", backend=backend, state_impl="u8")
        current = env.mask_kernel
        kernels = {"earlier": chip_smoke.general_calls(cfg, current, env.clear_kernel, lib)[0],
                   "current": current}
        swap_turns(card, "xwide", (f"u8 {backend} step, 2x1056", "mask"), env, "mask_kernel",
                   kernels, {"earlier": "general mask", "current": current.name},
                   ("::mask_kernel(", "mask_xwide_kernel<"), steps)


def general_long_times(card: str) -> None:
    """The four general u8 kernels (``bp_mask``, ``bp_clear``, ``bp_apply``,
    ``bp_legality``) on 2x4128 (``chip_smoke.W4128``), rows of more than
    4096 cells, where the wrappers pick them, at N = 49152
    (``chip_smoke.kernel_inputs``, seed 0): each through its wrapper, its
    device time (``chip_smoke.cuda_ms``) beside its bound
    (``utils/bounds.py``)."""
    import torch

    from blockpuzzle_tpu_torch import rules
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import (
        ApplyKernel, ClearScanKernel, LegalityKernel, MaskKernel,
    )
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    cfg = EnvConfig(**chip_smoke.W4128)
    mk, ck, ak = MaskKernel(cfg, dev), ClearScanKernel(cfg, dev), ApplyKernel(cfg, dev)
    lk = LegalityKernel(cfg, dev)
    if {w.kind for w in (mk, ck, ak, lk)} != {"general"}:
        raise AssertionError(f"2x4128: the wrappers picked {mk.name}, {ck.name}, {ak.name}, "
                             f"{lk.name}")
    board, queue, cover, valid, attrs, r, c = (
        torch.as_tensor(x, device=dev) for x in chip_smoke.kernel_inputs(cfg, n, seed=0))
    calls = {"mask_general": lambda: mk(board, queue), "clear_general": lambda: ck(board),
             "apply_general": lambda: ak(board, cover, valid),
             "legality_general": lambda: lk(board)}
    for k, f in calls.items():
        b = kernel_bounds(cfg, board, queue, cover, valid, None, attrs, r, c, {k: f()})[k]
        ms = chip_smoke.cuda_ms(f)
        print(f"[xwide] {k} 2x4128 N={n}: {ms:.6f} ms, {100 * b['bound_ms'] / ms:.1f}% of its "
              f"{b['bound_ms']:.6f} ms bound by {b['bound_by']} ({b['bytes']} B) ({card})")
    rules._TABLE_CACHE.pop(cfg, None)


def deep_step_turns(card: str, lib, steps: int = 20) -> None:
    """The default (packed) step and the u8 clear-kernel step on 130x8 at
    N = 49152, uniform-legal draws, one engine each carrying its state:
    with the kernels the deep clear and the windowed packed mask replace
    swapped in (``earlier_deep_calls``: the earlier library's where ``lib``
    is given, else the current library's) and with the current wrappers, in
    turns earlier, current, current, earlier: host ms a step over ``steps``
    unprofiled steps, then ``steps`` steps under ``torch.profiler``: device
    kernels, device ms and busy share a step, the changed kernel's device
    ms a step and the largest items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from blockpuzzle_tpu_torch import make_env
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

    n, cfg = chip_smoke.N_MAIN, EnvConfig(**chip_smoke.HUGE)
    # engine -> (make_env arguments, the device names of its changed kernel)
    engines = {"packed": ({}, ("packed_mask_general_kernel", "packed_mask_rows_general")),
               "u8-jnp": ({"backend": "jnp", "state_impl": "u8"},
                          ("clear_deep_kernel", "::clear_kernel("))}
    for engine, (kwargs, keys) in engines.items():
        env = make_env(cfg, device="cuda", **kwargs)
        kernels = {"current": (env.clear_kernel, env.packed_mask_kernel),
                   "earlier": earlier_deep_calls(lib, cfg, env.clear_kernel,
                                                 env.packed_mask_kernel)[:2]}
        state, ts = env.init(0, n)
        draw = UniformLegalSampler(1, n, env.device)

        def run(k):
            nonlocal state, ts
            for _ in range(k):
                state, ts = env.step(state, draw(ts.action_mask))
            torch.cuda.synchronize()

        for which in ("earlier", "current", "current", "earlier"):
            env.clear_kernel, env.packed_mask_kernel = kernels[which]
            run(5)                                         # warm-up
            t0 = time.perf_counter()
            run(steps)
            step_ms = 1e3 * (time.perf_counter() - t0) / steps
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(steps)
            device = device_events(prof)
            if not device:
                print("[deep] the profiler saw no device events: not measured")
                continue
            busy = busy_us(device) / steps / 1e3
            part = sum(e.time_range.elapsed_us() for e in device
                       if any(k in e.name for k in keys)) / steps / 1e3
            print(f"[deep] {engine} step, 130x8, N={n}, {which} clear and packed mask: "
                  f"{step_ms:.4f} ms per step, {len(device) / steps:.2f} device kernels, "
                  f"{sum(e.time_range.elapsed_us() for e in device) / steps / 1e3:.6f} ms "
                  f"device time a step, busy {busy:.4f} ms = {100 * busy / step_ms:.1f}%, "
                  f"the changed kernel {part:.6f} ms a step ({card})")
            top_items(device, steps, f"deep {engine} {which}", 8)
        env.clear_kernel, env.packed_mask_kernel = kernels["current"]


def legality_turns(card: str, lib, rounds: int = 5) -> None:
    """K4 beyond 32x32 at N = 49152 on ``chip_smoke.LEGALITY_BOARDS``
    (``chip_smoke.kernel_inputs``, seed 0): the every-piece instance the
    wrapper picks beside the general legality launched directly on the
    same inputs (``chip_smoke.general_legality``, ``bp_legality``), and,
    where ``lib`` is given, first the earlier library's ``bp_legality``;
    held bit-equal, then timed in turns (``group_turns``)."""
    import torch

    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels import LegalityKernel
    from blockpuzzle_tpu_torch.utils.bounds import kernel_bounds

    n, dev = chip_smoke.N_MAIN, torch.device("cuda")
    for name, (shape, _) in chip_smoke.LEGALITY_BOARDS.items():
        cfg = EnvConfig(**shape)
        lk = LegalityKernel(cfg, dev)
        if lk.kind not in ("wide", "tall", "deep", "xwide"):
            raise AssertionError(f"{name}: the wrapper picked {lk.name}")
        board = torch.as_tensor(chip_smoke.kernel_inputs(cfg, n, seed=0)[0], device=dev)
        fns = {}
        if lib is not None:
            earlier = chip_smoke.general_legality(cfg, lk, lib)
            fns["earlier bp_legality"] = lambda: earlier(board)
        general = chip_smoke.general_legality(cfg, lk)
        fns.update({lk.name: lambda: lk(board), "legality_general": lambda: general(board)})
        bound = kernel_bounds(cfg, board, None, None, None, None, None, None, None,
                              {lk.name: lk(board)})
        print(f"[legality] {name}: {lk.name} launch shape {lk.shape} (env-slots a warp, "
              "warps a block)")
        group_turns(card, "legality", name, {lk.name: fns}, bound, rounds)


PARTS = ("build", "train", "rollout", "kernels", "words", "general", "draws", "tall",
         "packed_tall", "tail", "deep", "apply", "xwide", "long", "legality")


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parts", default=",".join(PARTS),
                   help="comma-separated subset of " + ", ".join(PARTS))
    p.add_argument("--parent-csrc", default=None,
                   help="directory of earlier kernel sources (*.cu, *.cuh)")
    p.add_argument("--alt-csrc", action="append", default=[],
                   help="directory of other versions of some kernel sources with the "
                        "current entries' arguments, timed beside the tall packed mask and "
                        "words (packed_tall, tall), B7w (kernels), B2w (draws) and the xwide "
                        "kernels it has (xwide); repeatable")
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
    alts = alt_libraries(args.alt_csrc)
    if "build" in parts:
        build_times()
    if "kernels" in parts:
        kernel_turns(card, args.parent_csrc)
        words_turns(card, parent_library(pathlib.Path(args.parent_csrc))
                    if args.parent_csrc else None, alts)
    if "train" in parts:
        for argv_ in (chip_smoke.TRAIN_ARGV, chip_smoke.TRAIN_U8_ARGV):
            train_breakdown(card, argv_)
        for argv_ in (chip_smoke.TRAIN_DQN_ARGV, chip_smoke.TRAIN_DQN_U8_ARGV):
            dqn_breakdown(card, argv_)
    if "rollout" in parts:
        rollout_breakdown(card)
        rollout_turns(card)
    if "words" in parts:
        words_breakdown(card)
        words_step_turns(card, parent_library(pathlib.Path(args.parent_csrc))
                         if args.parent_csrc else None)
    if "general" in parts:
        chip_smoke.wide_turns(card, "general")
        wide_step_turns(card)
    if "draws" in parts:
        draw_turns(card, args.parent_csrc)
        select_turns(card, parent_library(pathlib.Path(args.parent_csrc))
                     if args.parent_csrc else None, alts)
    if "tall" in parts:
        chip_smoke.tall_turns(card, "tall")
        tall_turn_shapes(card)
        tall_step_turns(card)
        packed_tall_times(card)
    if "tall" in parts or "packed_tall" in parts:
        lib = parent_library(pathlib.Path(args.parent_csrc)) if args.parent_csrc else None
        packed_tall_turns(card, lib, alts)
        packed_tall_step_turns(card, lib)
    if "tall" in parts:
        from blockpuzzle_tpu_torch.config import EnvConfig

        rollout_breakdown(card, EnvConfig(**chip_smoke.TALL),
                          {k: ENGINES[k] for k in ("packed", "packed-words")}, "tall")
        if args.parent_csrc:
            kernel_turns(card, args.parent_csrc, presets=("default",),
                         only=("mask", "clear", "packed_apply", "packed_mask"))
        tall_rollout_rate(card)
    if "tail" in parts:
        tail_turns(card, args.parent_csrc)
    if "deep" in parts:
        lib = parent_library(pathlib.Path(args.parent_csrc)) if args.parent_csrc else None
        deep_turns(card, lib)
        deep_step_turns(card, lib)
    if "apply" in parts:
        lib = parent_library(pathlib.Path(args.parent_csrc)) if args.parent_csrc else None
        apply_turns(card, lib)
        pallas_step_turns(card, lib)
    if "xwide" in parts or "long" in parts:
        lib = parent_library(pathlib.Path(args.parent_csrc)) if args.parent_csrc else None
        if "xwide" in parts:
            xwide_times(card, lib, alts)
            xwide_step_turns(card, lib, alts)
        long_times(card, lib, alts)
        long_step_turns(card, lib)
        general_long_times(card)
    if "legality" in parts:
        lib = parent_library(pathlib.Path(args.parent_csrc)) if args.parent_csrc else None
        legality_turns(card, lib)
    print(f"[done] {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
