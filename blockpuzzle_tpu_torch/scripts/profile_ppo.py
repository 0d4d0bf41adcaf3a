"""PPO update time, and its two halves.

    python -m blockpuzzle_tpu_torch.scripts.profile_ppo [--variants perm roll none] \\
        [--device cuda|cpu]

The port of ``scripts/profile_ppo.py``, at N = 4096 and T = 64 with the
JAX CLI's network (conv torso, packed engine): the whole update
(``PPO.update``), the rollout and GAE alone (``PPO._rollout`` and
``PPO._gae``), and the minibatch epochs alone (``PPO._epochs`` on one
rollout's batch) under each minibatch order of ``PPOConfig.shuffle``:
``perm`` (a random permutation), ``roll`` (one random rotation, the
default) and ``none`` (the rollout's order; the JAX script's
``reshape``).  Each part runs once, then ``--iters`` times in a row,
ending in a device synchronize and a host read; its time is their mean.

Not ported: the ``noperm`` variant, an identity permutation gathered as
``perm`` gathers, which isolated the cost of the TPU's sort.

Prints one JSON line: ``update_ms``, ``rollout_gae_ms``,
``epochs_<variant>_ms`` for each variant, ``frames_per_s`` (N * T over the
update's time) and ``device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from blockpuzzle_tpu_torch import bench
from blockpuzzle_tpu_torch.cli.rollout import device_name, sync
from blockpuzzle_tpu_torch.learn import PPO, PPOConfig, default_hypers
from blockpuzzle_tpu_torch.learn.ppo import SHUFFLES

NOT_PORTED = {"noperm": "an identity permutation, gathered as perm gathers, "
                        "isolated the cost of the TPU's sort"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--rollout-len", type=int, default=64)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--variants", nargs="*", default=["perm", "roll", "none"],
                   help=f"epoch orders, of {list(SHUFFLES)}")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    for v in args.variants:
        if v in NOT_PORTED:
            p.error(f"variant {v!r} is not ported: {NOT_PORTED[v]}")
        if v not in SHUFFLES:
            p.error(f"unknown variant {v!r}; valid: {list(SHUFFLES)}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    env = bench.make_bench_env(device=args.device)
    cfg = PPOConfig(num_envs=args.num_envs, rollout_len=args.rollout_len)
    ppo = PPO(env, cfg)
    hypers = default_hypers(cfg)
    state = ppo.init(0)

    def timed(fn, label):
        """Mean ms of ``fn() -> 0-d tensor`` over ``--iters`` calls after
        one warm-up call."""
        float(fn())
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn()
        sync(env.device)
        float(out)
        ms = 1e3 * (time.perf_counter() - t0) / args.iters
        print(f"[profile] {label}: {ms:.1f} ms", file=sys.stderr)
        return ms

    results = {"update_ms": timed(lambda: ppo.update(state, hypers)[1]["loss"],
                                  "full update")}

    def rollout_gae():
        _, batch, last_value, _ = ppo._rollout(state)
        adv, ret = ppo._gae(batch, last_value)
        return adv.sum() + ret.sum() + batch.reward.sum()

    results["rollout_gae_ms"] = timed(rollout_gae, "rollout+GAE")
    # one rollout's batch for the epoch variants
    _, batch, last_value, _ = ppo._rollout(state)
    adv, ret = ppo._gae(batch, last_value)
    for variant in args.variants:
        learner = PPO(env, dataclasses.replace(cfg, shuffle=variant))
        results[f"epochs_{variant}_ms"] = timed(
            lambda: learner._epochs(state, batch, adv, ret, hypers)["loss"],
            f"epochs[{variant}]")
    results["frames_per_s"] = round(
        cfg.num_envs * cfg.rollout_len / (results["update_ms"] / 1e3))
    results["device"] = device_name(env.device)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
