"""Headline benchmark of the port: batched env-steps/s per card.

    python -m blockpuzzle_tpu_torch.bench [--device cuda|cpu]

The port of the repo's root ``bench.py``: the batched engine at the bench
batch with a uniform-legal random policy, steady state.  One warm-up chunk
(it also builds the kernels), then ``WINDOWS`` windows of ``ITERS`` chunks
of ``CHUNK`` steps; the median window is the value.  Each step draws the
action (``sampler.UniformLegalSampler`` on the step's bool mask, or
``sampler.WordsSampler`` on the state's legal words), steps the engine and
adds the step's reward sum into a device accumulator; nothing is read by
the host inside a window.  A window ends in ``torch.cuda.synchronize()``
and a host read of its reward sum.

Knobs, read from the environment in ``main()``:

* ``BP_BENCH_PRESET`` (``default``), ``BP_BENCH_NUM_ENVS`` (49152);
* ``BP_BENCH_STATE_IMPL``: ``auto`` (packed where rows fit a 32-bit word),
  ``packed`` or ``u8``;
* ``BP_BENCH_BACKEND``: ``jnp``, ``hybrid`` or ``pallas`` (u8 boards: the
  apply kernel with ``pallas``, the clear kernel otherwise);
* ``BP_BENCH_SAMPLER``: ``argmax`` or ``words`` (packed engine only).

``BP_BENCH_MASK_IMPL`` and ``BP_BENCH_MASK_DTYPE`` chose how the TPU
computed the same mask; they change no output, so only their defaults
(``bitboard``, ``int8``) or unset are accepted.

Prints ONE JSON line on stdout:
  {"metric": "env_steps_per_s_per_chip", "value": N, "unit": "steps/s",
   "vs_baseline": N / 10_000_000}
``vs_baseline`` divides by the 10M steps/s north-star target of
``BASELINE.json``.  A bad knob prints its reason on stderr, no JSON line,
and exits 2; a failure on the card raises.  The single-env CPU oracle's
rate goes to stderr for context.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from blockpuzzle_tpu_torch.cli.rollout import device_name, sync
from blockpuzzle_tpu_torch.config import PRESETS, default_config
from blockpuzzle_tpu_torch.env import VecBlockPuzzle, make_env
from blockpuzzle_tpu_torch.env.words import pack_bool_mask
from blockpuzzle_tpu_torch.sampler import UniformLegalSampler, WordsSampler

BASELINE_STEPS_PER_S = 10_000_000  # BASELINE.json north-star target
NUM_ENVS = 49152
CHUNK = 400
ITERS = 8
WINDOWS = 5
# policies of the bench body: the two BP_BENCH_SAMPLER values, and
# ``packsel`` (the bool mask packed to words, then the rank-select), a mode
# of ``scripts/bench_words.py``
SAMPLERS = ("argmax", "packsel", "words")
# knobs of the JAX bench that change no output: only their default passes
NOT_PORTED = {"BP_BENCH_MASK_IMPL": "bitboard", "BP_BENCH_MASK_DTYPE": "int8"}


def bench_oracle(max_steps: int = 2000) -> float:
    """Single-env CPU oracle steps/s (the reference-shaped baseline)."""
    import random

    import numpy as np

    from blockpuzzle_tpu_torch.oracle import BlockPuzzleOracleEnv

    env = BlockPuzzleOracleEnv(default_config())
    rng = random.Random(0)
    obs, info = env.reset(seed=0)
    t0 = time.perf_counter()
    steps = 0
    while steps < max_steps:
        legal = np.flatnonzero(info["action_mask"])
        if legal.size == 0:
            obs, info = env.reset()
            continue
        obs, r, term, trunc, info = env.step(int(rng.choice(legal)))
        steps += 1
        if term or trunc:
            obs, info = env.reset()
    return steps / (time.perf_counter() - t0)


Policy = Callable[[object, torch.Tensor], torch.Tensor]


def make_policy(env: VecBlockPuzzle, sampler: str, num_envs: int,
                seed: int = 1) -> Policy:
    """``policy(state, mask) -> (N,) actions`` of a bench sampler, drawing
    from ``seed``'s ``rng.TAG_POLICY`` streams; ``policy.sampler`` is the
    sampler.  ``words`` and ``packsel`` need a packed engine."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; valid: {SAMPLERS}")
    if sampler != "argmax" and env.state_impl != "packed":
        raise ValueError(f"sampler {sampler!r} needs the packed engine")
    cfg = env.cfg
    if sampler == "argmax":
        draw = UniformLegalSampler(seed, num_envs, env.device)
        policy = lambda state, mask: draw(mask)
    elif sampler == "words":
        draw = WordsSampler(seed, num_envs, env.device)
        policy = lambda state, mask: draw(env, state.board, state.queue)
    else:
        # packsel: WordsSampler's draw, rank-selected in the packed bool mask
        draw = WordsSampler(seed, num_envs, env.device)
        policy = lambda state, mask: draw.select(
            pack_bool_mask(mask, cfg.height, cfg.width, cfg.queue_size), cfg.width)
    policy.sampler = draw
    return policy


def run_chunk(env: VecBlockPuzzle, state, mask: torch.Tensor, policy: Policy,
              steps: int) -> Tuple[object, torch.Tensor, torch.Tensor]:
    """``steps`` steps of the bench body; returns the state, the last
    step's bool mask and the float32 reward sum, all on the device."""
    total = torch.zeros((), dtype=torch.float32, device=env.device)
    for _ in range(steps):
        state, ts = env.step(state, policy(state, mask))
        mask = ts.action_mask
        total = total + ts.reward.sum()
    return state, mask, total


def time_windows(run: Callable, carry, device: torch.device, env_steps: int,
                 iters: int, windows: int, tag: str
                 ) -> Tuple[object, List[float], float]:
    """One warm-up call of ``run(carry) -> (carry, reward_sum)``, then
    ``windows`` windows of ``iters`` calls, each window ending in a device
    synchronize and a host read of its reward sum.  ``env_steps`` is the
    env-steps of one call.  Returns the last carry, the windows'
    env-steps/s in order (each also on stderr) and the warm-up's seconds
    (kernel builds and library autotuning included).  No gradient is
    taken."""
    rates = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        carry, r = run(carry)
        sync(device)
        float(r)
        warmup_s = time.perf_counter() - t0
        for w in range(windows):
            t0 = time.perf_counter()
            total = torch.zeros((), dtype=torch.float32, device=device)
            for _ in range(iters):
                carry, r = run(carry)
                total = total + r
            sync(device)
            float(total)
            # two reads within the timer's resolution must not divide by 0
            rates.append(iters * env_steps / max(time.perf_counter() - t0, 1e-9))
            print(f"[{tag}] window {w}: {rates[-1] / 1e6:.2f}M steps/s",
                  file=sys.stderr)
    return carry, rates, warmup_s


def bench_device(env: VecBlockPuzzle, num_envs: int = NUM_ENVS,
                 sampler: str = "argmax", chunk: int = CHUNK, iters: int = ITERS,
                 windows: int = WINDOWS, seed: int = 0) -> Dict:
    """The bench protocol on ``env`` (``make_bench_env``): the engine from
    ``seed``, the policy from ``seed + 1``.  Returns the value (the median
    window, ``rates[len // 2]`` of the sorted rates, as the JAX bench takes
    it), the window rates in order, the warm-up chunk's seconds, the final
    state and bool mask."""
    state, ts = env.init(seed, num_envs)
    policy = make_policy(env, sampler, num_envs, seed + 1)

    def run(carry):
        state, mask, r = run_chunk(env, *carry, policy, chunk)
        return (state, mask), r

    (state, mask), rates, warmup_s = time_windows(
        run, (state, ts.action_mask), env.device, chunk * num_envs, iters, windows,
        "bench")
    ranked = sorted(rates)
    value = ranked[len(ranked) // 2]
    print(f"[bench] median {value / 1e6:.2f}M, best {ranked[-1] / 1e6:.2f}M "
          f"steps/s over {windows} windows", file=sys.stderr)
    return {"value": value, "rates": rates, "warmup_s": warmup_s, "state": state,
            "mask": mask}


def make_bench_env(preset: str = "default", state_impl: str = "auto",
                   backend: str = "jnp", device="cuda") -> VecBlockPuzzle:
    """The engine the knobs name (``state_impl="auto"``: ``make_env``'s
    choice)."""
    return make_env(PRESETS[preset](), device=device, backend=backend,
                    state_impl=None if state_impl == "auto" else state_impl)


def knob_error(environ) -> Optional[str]:
    """The reason the knobs in ``environ`` cannot run, or None."""
    preset = environ.get("BP_BENCH_PRESET", "default")
    backend = environ.get("BP_BENCH_BACKEND", "jnp")
    state_impl = environ.get("BP_BENCH_STATE_IMPL", "auto")
    sampler = environ.get("BP_BENCH_SAMPLER", "argmax")
    num_envs = environ.get("BP_BENCH_NUM_ENVS", str(NUM_ENVS))
    for name, default in NOT_PORTED.items():
        value = environ.get(name, default)
        if value != default:
            return (f"{name}={value!r} is not ported: it chose how the TPU "
                    f"computed the same mask; only {default!r} (or unset) runs")
    for name, value, allowed in (
        ("BP_BENCH_PRESET", preset, sorted(PRESETS)),
        ("BP_BENCH_BACKEND", backend, ["jnp", "hybrid", "pallas"]),
        ("BP_BENCH_STATE_IMPL", state_impl, ["auto", "u8", "packed"]),
        ("BP_BENCH_SAMPLER", sampler, ["argmax", "words"]),
    ):
        if value not in allowed:
            return f"{name}={value!r} not in {allowed}"
    if state_impl == "packed" and backend != "jnp":
        return ("BP_BENCH_STATE_IMPL=packed supports BP_BENCH_BACKEND=jnp "
                f"only (got {backend!r})")
    if sampler == "words" and (state_impl == "u8" or backend != "jnp"):
        return ("BP_BENCH_SAMPLER=words needs the packed engine "
                "(BP_BENCH_STATE_IMPL auto/packed, BP_BENCH_BACKEND=jnp); got "
                f"state_impl={state_impl!r} backend={backend!r}")
    try:
        if int(num_envs) <= 0:
            return f"BP_BENCH_NUM_ENVS={num_envs!r} must be positive"
    except ValueError:
        return f"BP_BENCH_NUM_ENVS={num_envs!r} is not an integer"
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="headline bench of the port")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    error = knob_error(os.environ)
    if error is not None:
        print(f"[bench] {error}", file=sys.stderr)
        return 2
    env = make_bench_env(os.environ.get("BP_BENCH_PRESET", "default"),
                         os.environ.get("BP_BENCH_STATE_IMPL", "auto"),
                         os.environ.get("BP_BENCH_BACKEND", "jnp"), args.device)
    num_envs = int(os.environ.get("BP_BENCH_NUM_ENVS", NUM_ENVS))
    oracle_sps = bench_oracle()
    print(f"[bench] oracle single-env: {oracle_sps:,.0f} steps/s (1 CPU core)",
          file=sys.stderr)
    value = bench_device(env, num_envs, os.environ.get("BP_BENCH_SAMPLER", "argmax"),
                         CHUNK, ITERS, WINDOWS)["value"]
    print(f"[bench] device batched ({device_name(env.device)}): "
          f"{value / 1e6:.2f}M steps/s ({value / oracle_sps:,.0f}x oracle)",
          file=sys.stderr)
    print(json.dumps({
        "metric": "env_steps_per_s_per_chip",
        "value": round(value),
        "unit": "steps/s",
        "vs_baseline": round(value / BASELINE_STEPS_PER_S, 3),
    }))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
