"""Actor throughput: the policy in the loop, no learning.

    python -m blockpuzzle_tpu_torch.scripts.bench_actor [--torsos mlp conv] \\
        [--policies greedy sample] [--device cuda|cpu]

The port of ``scripts/bench_actor.py``: the serving program of
``cli/evaluate.py``, at the bench's batch, timed with the bench's protocol
(``bench.time_windows``).  A step is the ``ActorCritic`` forward on the
current observation, an argmax (``greedy``) or a Gumbel-max draw from the
masked logits (``networks.masked_categorical``, ``sample``), and
``env.step``, whose timestep is the next observation (``env.init``'s
gives the first, as in the JAX script; ``PPO.observe`` would make the mask
again from the state, one more mask launch a step); the reward sum stays
on the device.  The parameters come from ``PPO.init(0)``.  The first chunk, in
which cuDNN picks its algorithms, is the warm-up and is not timed.

Prints one JSON line per (torso, policy):
  {"metric": "actor_steps_per_s", "torso": ..., "policy": ..., "preset": ...,
   "num_envs": N, "value": steps_per_s, "device": ...}
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from blockpuzzle_tpu_torch import bench
from blockpuzzle_tpu_torch.cli.rollout import device_name
from blockpuzzle_tpu_torch.config import PRESETS
from blockpuzzle_tpu_torch.learn import PPO, PPOConfig
from blockpuzzle_tpu_torch.learn.networks import masked_categorical

POLICIES = ("greedy", "sample")


def act(net, obs, policy: str, gen: torch.Generator) -> torch.Tensor:
    """(N,) actions of ``net`` on ``obs`` = (board, queue, mask)."""
    logits, _ = net(*obs)
    if policy == "greedy":
        return logits.argmax(dim=-1)
    return masked_categorical(logits, gen)


def run_chunk(env, net, state, obs, policy: str, gen: torch.Generator, steps: int):
    """``steps`` actor steps; returns the state, the next observation and
    the float32 reward sum, on the device."""
    total = torch.zeros((), dtype=torch.float32, device=env.device)
    for _ in range(steps):
        state, ts = env.step(state, act(net, obs, policy, gen))
        obs = (ts.board, ts.queue, ts.action_mask)
        total = total + ts.reward.sum()
    return state, obs, total


def bench_one(ppo: PPO, net, policy: str, chunk: int, iters: int, windows: int,
              seed: int = 0) -> float:
    """The median window (``rates[len // 2]`` of the sorted rates) of one
    (torso, policy), from ``ppo``'s initial engine state of ``seed``."""
    env, n = ppo.env, ppo.cfg.num_envs
    state, ts = env.init(seed, n)
    gen = torch.Generator(device=env.device).manual_seed(seed + 1)

    def run(carry):
        state, obs, r = run_chunk(env, net, *carry, policy, gen, chunk)
        return (state, obs), r

    obs = (ts.board, ts.queue, ts.action_mask)
    _, rates, _ = bench.time_windows(run, (state, obs), env.device, chunk * n, iters,
                                     windows, "actor")
    return sorted(rates)[len(rates) // 2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-envs", type=int, default=bench.NUM_ENVS,
                   help="the bench's batch")
    p.add_argument("--torsos", nargs="*", default=["mlp", "conv"],
                   choices=["mlp", "conv"])
    p.add_argument("--policies", nargs="*", default=list(POLICIES), choices=POLICIES)
    p.add_argument("--preset", choices=sorted(PRESETS), default="default")
    p.add_argument("--mlp-width", type=int, default=512)
    p.add_argument("--queue-mode", choices=["embed", "planes"], default="embed")
    p.add_argument("--chunk", type=int, default=400)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--windows", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    env = bench.make_bench_env(args.preset, device=args.device)
    for torso in args.torsos:
        ppo = PPO(env, PPOConfig(num_envs=args.num_envs, rollout_len=8, torso=torso,
                                 mlp_width=args.mlp_width, queue_mode=args.queue_mode))
        net = ppo.init(0).net
        for policy in args.policies:
            rate = bench_one(ppo, net, policy, args.chunk, args.iters, args.windows)
            print(json.dumps({
                "metric": "actor_steps_per_s",
                "torso": torso,
                "policy": policy,
                "preset": args.preset,
                "num_envs": args.num_envs,
                "value": round(rate),
                "device": device_name(env.device),
            }))
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
