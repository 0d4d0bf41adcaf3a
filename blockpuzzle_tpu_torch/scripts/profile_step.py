"""Device profile of the bench body: the next bottleneck of a step.

    python -m blockpuzzle_tpu_torch.scripts.profile_step [--num-envs 32768] \\
        [--trace-dir DIR] [--device cuda|cpu]

The port of ``scripts/profile_step.py``: one warm-up chunk of the bench
body (``bench.run_chunk``, uniform-legal argmax policy), ``--chunks``
chunks timed without the profiler, then ``--chunks`` chunks under
``torch.profiler`` (``utils/profiling.py``).  Prints the top device
kernels by total time, in µs per step (the kernel's time over the steps
of the traced chunks, so a step's kernel sum is its device time), the
device kernels launched per step and the device's busy share of an
unprofiled step (the profiler's own host cost stretches the traced
steps), and one JSON line.  With ``--trace-dir`` the Chrome trace is
written there.  On the CPU the profile has no device kernels: the device
fields are null ("not measured").

Not ported: ``--mask-impl`` and ``--mask-dtype`` (how the TPU computed the
same mask) and ``--unroll`` (XLA's scan unrolling); the port's step has
one mask and runs eagerly.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from blockpuzzle_tpu_torch import bench
from blockpuzzle_tpu_torch.cli.rollout import device_name, sync
from blockpuzzle_tpu_torch.config import PRESETS
from blockpuzzle_tpu_torch.utils.profiling import (
    TRACE_FILE,
    busy_us,
    by_name,
    device_events,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-envs", type=int, default=32768)
    p.add_argument("--chunk", type=int, default=100)
    p.add_argument("--chunks", type=int, default=3, help="traced chunks")
    p.add_argument("--preset", choices=sorted(PRESETS), default="default")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--trace-dir", default=None,
                   help="also write the Chrome trace here")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    env = bench.make_bench_env(args.preset, device=args.device)
    n = args.num_envs
    state, ts = env.init(0, n)
    policy = bench.make_policy(env, "argmax", n)
    activities = [ProfilerActivity.CPU]
    if env.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    steps = args.chunks * args.chunk

    def chunks():
        """``--chunks`` chunks from the carried state; their wall µs."""
        nonlocal state, mask
        t0 = time.perf_counter()
        for _ in range(args.chunks):
            state, mask, r = bench.run_chunk(env, state, mask, policy, args.chunk)
        sync(env.device)
        float(r)
        return 1e6 * (time.perf_counter() - t0)

    mask = ts.action_mask
    with torch.inference_mode():
        state, mask, r = bench.run_chunk(env, state, mask, policy, args.chunk)
        sync(env.device)
        float(r)
        step_us = chunks() / steps
        with profile(activities=activities) as prof:
            traced_us = chunks()
    print(f"[profile] {steps} steps: {step_us / 1e3:.4f} ms a step unprofiled, "
          f"{traced_us / steps / 1e3:.4f} ms traced ({device_name(env.device)})",
          file=sys.stderr)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, TRACE_FILE))
    device = device_events(prof)
    total_us = sum(e.time_range.elapsed_us() for e in device)
    rows = [{"kernel": name, "us_per_step": round(us / steps, 2),
             "per_step": round(count / steps, 2),
             "pct": round(100 * us / total_us, 1)}
            for name, count, us in by_name(device)[: args.top]]
    for row in rows:
        print(f"[profile] {row['us_per_step']:>8.2f} us/step  {row['pct']:>5.1f}%  "
              f"{row['per_step']:>5.2f}x  {row['kernel'][:90]}", file=sys.stderr)
    if not device:
        print("[profile] no device kernels in the profile: device time not measured",
              file=sys.stderr)
    print(json.dumps({
        "num_envs": n,
        "preset": args.preset,
        "steps": steps,
        "device": device_name(env.device),
        "step_us": round(step_us, 2),
        "device_total_us_per_step": round(total_us / steps, 2) if device else None,
        "launches_per_step": round(len(device) / steps, 2) if device else None,
        "busy_share": round(busy_us(device) / steps / step_us, 4) if device else None,
        "top_kernels": rows,
        "trace_dir": args.trace_dir,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
