"""Rollout CLI: batched uniform-legal rollout on the port's engine.

    python -m blockpuzzle_tpu_torch.cli.rollout --num-envs N --steps T \
        --preset P --seed S [--state-impl auto|packed|u8] [--device cuda|cpu]

Runs one warm-up chunk (which also builds the kernels on first use), then
``max(round(T / 100), 1)`` measured chunks of 100 env steps per env, each
chunk ending in a device synchronize, and prints episode statistics and the
cumulative rate: the env-steps of all measured chunks over their summed wall
time, as the JAX CLI does.
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import torch

from blockpuzzle_tpu_torch.config import PRESETS, cli_env_config
from blockpuzzle_tpu_torch.env import VecBlockPuzzle, make_env
from blockpuzzle_tpu_torch.sampler import UniformLegalSampler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BlockPuzzle batched rollout (PyTorch)")
    p.add_argument("--preset", choices=sorted(PRESETS), default="default")
    p.add_argument("--env", action="append", default=[], metavar="KEY=VALUE",
                   help="override any EnvConfig field on top of --preset "
                        "(repeatable), e.g. --env streak_bonus=5")
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=512)
    p.add_argument("--state-impl", choices=["auto", "packed", "u8"],
                   default="auto", help="EnvState board layout "
                        "(auto = packed where supported)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rollout(
    env: VecBlockPuzzle, num_envs: int, chunk: int, chunks: int, seed: int
) -> Dict:
    """Uniform-legal rollout: one warm-up chunk, then ``chunks`` timed
    chunks of ``chunk`` steps, each ending in a device synchronize.

    Returns the final state, the per-chunk env-steps/s of the timed chunks,
    their summed wall time and totals over them (reward, finished episodes
    and their returns)."""
    dev = env.device
    state, ts = env.init(seed, num_envs)
    sampler = UniformLegalSampler(seed + 1, num_envs, dev)
    mask = ts.action_mask
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    totals = [zero, zero, zero]        # reward, episode returns, episodes
    rates, seconds = [], 0.0
    for i in range(chunks + 1):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(chunk):
            state, ts = env.step(state, sampler(mask))
            mask = ts.action_mask
            if i:
                done = ts.done
                totals[0] = totals[0] + ts.reward.sum(dtype=torch.float64)
                totals[1] = totals[1] + (
                    ts.info["episode_return"] * done
                ).sum(dtype=torch.float64)
                totals[2] = totals[2] + done.sum(dtype=torch.float64)
        _sync(dev)
        if i:
            # two reads within the timer's resolution must not divide by 0
            dt = max(time.perf_counter() - t0, 1e-9)
            rates.append(chunk * num_envs / dt)
            seconds += dt
    reward, ep_return, episodes = (float(x) for x in totals)
    return {
        "state": state,
        "rates": rates,
        "seconds": seconds,
        "env_steps": chunks * chunk * num_envs,
        "reward": reward,
        "episode_return": ep_return,
        "episodes": int(episodes),
    }


def summary_line(r: Dict, chunk: int, device_name: str) -> str:
    """Episode statistics and the cumulative rate: the env-steps of all
    timed chunks over their summed wall time."""
    steps = r["env_steps"]
    sps = steps / r["seconds"]
    return (
        f"{steps} env-steps (chunks of {chunk}) | {sps / 1e6:.2f}M steps/s "
        f"steady | reward/step {r['reward'] / steps:.3f} | "
        f"episodes {r['episodes']} | mean episode return "
        f"{r['episode_return'] / max(r['episodes'], 1):.1f} | "
        f"device {device_name}"
    )


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = cli_env_config(args.preset, args.env)
    env = make_env(cfg, device=args.device, state_impl=None
                   if args.state_impl == "auto" else args.state_impl)
    chunk = 100
    chunks = max(round(args.steps / chunk), 1)
    r = rollout(env, args.num_envs, chunk, chunks, args.seed)
    print(summary_line(r, chunk, device_name(env.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
