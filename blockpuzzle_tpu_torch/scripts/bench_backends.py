"""The u8 engine's three backends head to head on the card.

    python -m blockpuzzle_tpu_torch.scripts.bench_backends [--device cuda|cpu]

The port of ``scripts/bench_backends.py``: ``jnp``, ``hybrid`` and
``pallas`` on u8 boards (``jnp`` and ``hybrid`` step through the torch
collision test and the clear kernel, ``pallas`` through the apply kernel;
all three through the mask kernel), each timed with the bench's protocol
at N = 16384 in 100-step chunks, median of 3 windows of 10 chunks.  One
process: a kernel that fails to build raises here, where the JAX script
ran each backend in a subprocess to survive a hung TPU compile.  The
policy is the bench's argmax sampler, uniform over the legal actions as
the JAX script's categorical draw over masked zeros is.

Every backend gives the same bits, so from one seed the three final
states must be equal: they are compared, and a difference raises.  Prints
one JSON line per backend (``backend``, ``platform``, ``device``,
``num_envs``, ``init_s``, ``compile_s``: the warm-up chunk's seconds,
kernel builds included, ``steps_per_s``, ``best_steps_per_s``), and a
table on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from blockpuzzle_tpu_torch import bench
from blockpuzzle_tpu_torch.cli.rollout import device_name, sync

NUM_ENVS = 16384
CHUNK = 100
ITERS = 10
WINDOWS = 3
BACKENDS = ("jnp", "hybrid", "pallas")
STATE_FIELDS = ("board", "queue", "rng_counter", "steps", "score", "streak")


def run_backend(backend: str, num_envs: int, chunk: int, iters: int, windows: int,
                device) -> dict:
    """One backend's record, and its final state (``"state"``)."""
    t0 = time.perf_counter()
    env = bench.make_bench_env("default", "u8", backend, device)
    env.init(0, num_envs)
    sync(env.device)
    init_s = time.perf_counter() - t0
    r = bench.bench_device(env, num_envs, "argmax", chunk, iters, windows)
    ranked = sorted(r["rates"])
    return {
        "backend": backend,
        "platform": "gpu" if env.device.type == "cuda" else "cpu",
        "device": device_name(env.device),
        "num_envs": num_envs,
        "init_s": round(init_s, 2),
        "compile_s": round(r["warmup_s"], 2),
        "steps_per_s": round(r["value"]),
        "best_steps_per_s": round(ranked[-1]),
        "state": r["state"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backends", nargs="*", default=list(BACKENDS), choices=BACKENDS)
    p.add_argument("--num-envs", type=int, default=NUM_ENVS)
    p.add_argument("--chunk", type=int, default=CHUNK)
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--windows", type=int, default=WINDOWS)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    results = []
    for backend in args.backends:
        print(f"[backends] running {backend}...", file=sys.stderr)
        rec = run_backend(backend, args.num_envs, args.chunk, args.iters,
                          args.windows, args.device)
        state = rec.pop("state")
        if results:
            first, ref = results[0]
            differ = [f for f in STATE_FIELDS
                      if not torch.equal(getattr(state, f), getattr(ref, f))]
            if differ:
                raise AssertionError(f"{backend} and {first['backend']} final states "
                                     f"differ in {differ}")
        results.append((rec, state))
        print(json.dumps(rec))
        sys.stdout.flush()
    if len(results) > 1:
        print(f"[backends] final states bit-equal across "
              f"{', '.join(r['backend'] for r, _ in results)}", file=sys.stderr)
    print("| backend | init (s) | compile (s) | median steps/s | device |",
          file=sys.stderr)
    print("|---|---|---|---|---|", file=sys.stderr)
    for r, _ in results:
        print(f"| {r['backend']} | {r['init_s']} | {r['compile_s']} "
              f"| {r['steps_per_s'] / 1e6:.1f}M | {r['device']} |", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
