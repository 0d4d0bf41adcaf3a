"""Parity CLI: replay seeded oracle episodes through the port's engine.

Records seeded random-policy episodes on the port's CPU oracle
(``blockpuzzle_tpu_torch.oracle``) and replays them through the port's
engine with the oracle's deal stream injected and ``auto_reset=False``.
Exit code 0 iff every compared quantity is bit-equal.  The CLI replays on
``--device`` (default ``cuda``, as the other CLIs; ``cpu`` runs the plain
versions) through the default (packed) engine, as the JAX CLI replays on
its default device.

    python -m blockpuzzle_tpu_torch.cli.parity --preset P --seeds 8 [--batch] \
        [--state-impl auto|packed|u8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from blockpuzzle_tpu_torch.config import PRESETS, cli_env_config
from blockpuzzle_tpu_torch.env import make_env
from blockpuzzle_tpu_torch.oracle import record_trajectory


def _record(cfg, seed: int, max_steps: int):
    """One oracle episode under ``cfg``."""
    return record_trajectory(cfg, seed=seed, max_steps=max_steps)


def replay(env, init_deals, actions, deals):
    """Replay recorded actions with injected deals on a batch of B envs.

    Args: init_deals (B, S), actions (T, B), deals (T, B, S).
    Returns the initial TimeStep and numpy stacks (T, B, ...) of boards,
    queues, masks, rewards and terminated flags.
    """
    state, ts0 = env.init(0, init_deals.shape[0], deal_override=init_deals)
    outs = []
    for a, d in zip(actions, deals):
        state, ts = env.step(state, a, deal_override=d, auto_reset=False)
        outs.append((ts.board, ts.queue, ts.action_mask, ts.reward, ts.terminated))
    stacks = [torch.stack([o[i] for o in outs]).cpu().numpy() for i in range(5)]
    return ts0, stacks


def check_seed(cfg, seed: int, max_steps: int, env=None, device="cuda") -> dict:
    """One oracle episode replayed through ``env`` (default: the default
    engine on ``device``)."""
    traj = _record(cfg, seed, max_steps)
    if env is None:
        env = make_env(cfg, device=device)
    T = len(traj.actions)
    ts0, (boards, queues, masks, rewards, terms) = replay(
        env, traj.init_deals[None], traj.actions[:, None], traj.deals[:, None]
    )
    mismatches = []

    def cmp(name, got, want):
        if got.shape != want.shape or not np.array_equal(got, want):
            bad = np.nonzero(
                ~np.all((got == want).reshape(got.shape[0], -1), axis=1)
            )[0] if got.shape == want.shape else []
            mismatches.append(f"{name}@t={list(bad[:3])}")

    cmp("board0", ts0.board[0].cpu().numpy(), traj.boards[0])
    cmp("board", boards[:, 0].reshape(T, -1), traj.boards[1:].reshape(T, -1))
    cmp("queue", queues[:, 0], traj.queues[1:])
    cmp("mask", masks[:, 0], traj.masks[1:])
    cmp("reward", rewards[:, 0], traj.rewards)
    cmp("terminated", terms[:, 0], traj.terminated)
    return {
        "seed": seed,
        "steps": T,
        "oracle_return": traj.episode_return,
        "device_return": float(rewards[:, 0].sum()),
        "mismatches": mismatches,
    }


def check_batched_lockstep(cfg, env, seeds, max_steps: int) -> dict:
    """All seeds replayed in ONE lockstep batch: batched semantics ==
    independent single-env runs.  Each oracle episode is compared within
    its own length; shorter episodes pad with action 0 and no deals."""
    trajs = [_record(cfg, s, max_steps) for s in seeds]
    B = len(trajs)
    T = max(len(tr.actions) for tr in trajs)
    actions = np.zeros((T, B), np.int32)
    deals = np.full((T, B, cfg.queue_size), env.empty_id, np.int32)
    for b, tr in enumerate(trajs):
        actions[: len(tr.actions), b] = tr.actions
        deals[: len(tr.actions), b] = tr.deals
    init_deals = np.stack([tr.init_deals for tr in trajs])
    _, (boards, _, _, rewards, terms) = replay(env, init_deals, actions, deals)
    mismatches = []
    for b, tr in enumerate(trajs):
        L = len(tr.actions)
        if not np.array_equal(
            boards[:L, b].reshape(L, -1), tr.boards[1:].reshape(L, -1)
        ):
            mismatches.append(f"board@env{b}")
        if not np.array_equal(rewards[:L, b], tr.rewards):
            mismatches.append(f"reward@env{b}")
        if not np.array_equal(terms[:L, b], tr.terminated):
            mismatches.append(f"terminated@env{b}")
    return {
        "episodes": B,
        "returns_equal": all(
            float(rewards[: len(tr.actions), b].sum()) == tr.episode_return
            for b, tr in enumerate(trajs)
        ),
        "mismatches": mismatches,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="seeded oracle <-> port parity check")
    p.add_argument("--preset", choices=sorted(PRESETS), default="default")
    p.add_argument("--env", action="append", default=[], metavar="KEY=VALUE",
                   help="override any EnvConfig field on top of --preset")
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--max-steps", type=int, default=512)
    p.add_argument("--batch", action="store_true",
                   help="replay all seeds in one lockstep batch")
    p.add_argument("--state-impl", choices=["auto", "packed", "u8"],
                   default="auto", help="EnvState board layout "
                        "(auto = packed where supported)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the replay (cpu runs the plain "
                        "versions of the kernels)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = cli_env_config(args.preset, args.env)
    env = make_env(cfg, device=args.device, state_impl=None
                   if args.state_impl == "auto" else args.state_impl)
    if args.batch:
        r = check_batched_lockstep(cfg, env, list(range(args.seeds)), args.max_steps)
        ok = r["returns_equal"] and not r["mismatches"]
        print(
            f"[{'OK ' if ok else 'FAIL'}] lockstep batch of {r['episodes']} "
            f"episodes, returns equal: {r['returns_equal']}"
            + (f", mismatches: {r['mismatches'][:5]}" if r["mismatches"] else "")
        )
        print("parity:", "PASS (bit-exact)" if ok else "FAIL")
        return 0 if ok else 1
    failed = False
    for seed in range(args.seeds):
        r = check_seed(cfg, seed, args.max_steps, env=env)
        ok = not r["mismatches"] and r["oracle_return"] == r["device_return"]
        print(
            f"[{'OK ' if ok else 'FAIL'}] seed {seed}: {r['steps']} steps, "
            f"return oracle={r['oracle_return']:.1f} device={r['device_return']:.1f}"
            + (f" mismatches: {r['mismatches'][:5]}" if r["mismatches"] else "")
        )
        failed |= not ok
    print("parity:", "FAIL" if failed else "PASS (bit-exact)")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
