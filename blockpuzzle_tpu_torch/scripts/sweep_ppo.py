"""PPO hyperparameter sweep in one process, on ``PPO.update``.

    python -m blockpuzzle_tpu_torch.scripts.sweep_ppo --configs base anneal \\
        [--updates 2000] [--checkpoint-dir DIR] [--metrics-jsonl FILE] \\
        [--device cuda|cpu]

The port of ``scripts/sweep_ppo.py``, with its 32 flags (``--device`` in
place of ``--platform``).  ``PPO.update(state, hypers)`` takes lr,
entropy_coef, clip_eps, gamma, gae_lambda and value_coef at run time
(``learn/ppo.py`` ``default_hypers``); the host interpolates each config's
schedules and feeds them in per update.

Per config: ``PPO.init(seed * 131 + i)``, ``--updates`` updates, then a
greedy evaluation (argmax policy, mean completed-episode return over
``--eval-steps`` steps of ``--eval-envs`` envs, the metric of
``cli/evaluate.py --greedy``).  Prints one JSON line per config and a
final summary; with ``--checkpoint-dir`` the best config's final state is
saved (``utils/checkpoint.py``) with a ``run_meta.json`` that
``cli/evaluate.py`` reads, holding the recipe.

Host-side controllers, each reading the update's metrics on the host only
when it fires (every ``--ent-every`` / ``--kl-every`` updates, 0 = at log
boundaries): the entropy floor (``--ent-floor``: the entropy coefficient's
multiplier times ``exp(--ent-adapt * (floor - entropy))``, clamped to
``[1, --ent-max-mult]``) and the KL-adaptive clip (``--kl-target``: the
clip multiplier divided by ``--kl-adapt`` when approx_kl exceeds twice the
target, multiplied when under half, within ``[--kl-min-mult,
--kl-max-mult]``).  ``--lr0``/``--lr1`` override the config's lr
endpoints; the lr holds until ``--lr-decay-start`` (a fraction of the
run), then decays linearly or by a cosine (``--lr-shape``).

``--metrics-jsonl`` appends one row per log boundary with the JAX script's
field names (``config``, ``update``, the applied ``ent_mult``, ``lr``,
``entropy_coef``, ``clip_mult``, ``clip_eps``, then the update's metrics
as floats), so ``scripts/compare_metrics.py`` compares two runs' streams
bit for bit.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from blockpuzzle_tpu_torch import bench
from blockpuzzle_tpu_torch.config import PRESETS
from blockpuzzle_tpu_torch.learn import PPO, PPOConfig
from blockpuzzle_tpu_torch.utils import CheckpointManager
from blockpuzzle_tpu_torch.utils.metrics import host_metrics

# name -> (lr start/end, entropy start/end, clip, gamma, gae lambda,
# value coef); schedules interpolate linearly over the run
CONFIGS = {
    "base": dict(lr0=3e-4, lr1=3e-4, ent0=0.01, ent1=0.01,
                 clip=0.2, gamma=0.995, lam=0.95, vc=0.5),
    "anneal": dict(lr0=3e-4, lr1=0.0, ent0=0.01, ent1=0.001,
                   clip=0.2, gamma=0.995, lam=0.95, vc=0.5),
    "hot": dict(lr0=1e-3, lr1=0.0, ent0=0.01, ent1=0.01,
                clip=0.2, gamma=0.995, lam=0.95, vc=0.5),
    "lowent": dict(lr0=3e-4, lr1=0.0, ent0=0.003, ent1=0.0,
                   clip=0.2, gamma=0.995, lam=0.95, vc=0.5),
    "gamma99": dict(lr0=3e-4, lr1=0.0, ent0=0.01, ent1=0.001,
                    clip=0.2, gamma=0.99, lam=0.95, vc=0.5),
    "widelam": dict(lr0=3e-4, lr1=0.0, ent0=0.01, ent1=0.001,
                    clip=0.2, gamma=0.995, lam=0.8, vc=0.5),
}
# the record's measured outcomes: kept out of run_meta's recipe, so that
# recipe equality is a same-input check
OUTCOME_KEYS = {"greedy_return", "eval_episodes", "final_train_return", "train_s",
                "frames_per_s", "ent_mult_final", "clip_mult_final"}
EVAL_CHUNK = 64


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--configs", nargs="*", default=list(CONFIGS),
                   choices=sorted(CONFIGS), help="subset to run")
    p.add_argument("--updates", type=int, default=2000)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--rollout-len", type=int, default=64)
    p.add_argument("--eval-envs", type=int, default=2048)
    p.add_argument("--eval-steps", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the best config's final state here")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also save the in-progress state every N updates "
                        "(single-config runs; requires --checkpoint-dir)")
    p.add_argument("--keep", type=int, default=3, help="checkpoints retained")
    p.add_argument("--torso", choices=["conv", "mlp"], default="conv")
    p.add_argument("--mlp-width", type=int, default=512,
                   help="mlp-torso width (ignored by conv)")
    p.add_argument("--preset", choices=sorted(PRESETS), default="default")
    p.add_argument("--queue-mode", choices=["embed", "planes"], default="embed")
    p.add_argument("--shuffle", choices=["roll", "perm", "none"], default="roll",
                   help="PPO minibatch order (PPOConfig.shuffle)")
    p.add_argument("--ent-floor", type=float, default=0.0,
                   help="target policy entropy in nats (0 = controller off)")
    p.add_argument("--ent-adapt", type=float, default=1.0,
                   help="controller rate: ent multiplier *= "
                        "exp(rate * (floor - entropy)) per firing")
    p.add_argument("--ent-max-mult", type=float, default=20.0,
                   help="cap on the controller's coefficient multiplier")
    p.add_argument("--ent-every", type=int, default=0,
                   help="entropy-controller cadence in updates (0 = at log "
                        "boundaries); each firing reads the metrics")
    p.add_argument("--kl-target", type=float, default=0.0,
                   help="target approx_kl per update (0 = controller off)")
    p.add_argument("--kl-adapt", type=float, default=1.5,
                   help="band factor: clip multiplier /= adapt when "
                        "approx_kl > 2*target, *= adapt when < target/2")
    p.add_argument("--kl-min-mult", type=float, default=0.25,
                   help="floor on the clip multiplier")
    p.add_argument("--kl-max-mult", type=float, default=2.0,
                   help="cap on the clip multiplier")
    p.add_argument("--kl-every", type=int, default=0,
                   help="KL-controller cadence in updates (0 = at log "
                        "boundaries); each firing reads the metrics")
    p.add_argument("--lr0", type=float, default=None,
                   help="override the config's starting learning rate")
    p.add_argument("--lr1", type=float, default=None,
                   help="override the config's final learning rate")
    p.add_argument("--lr-decay-start", type=float, default=0.0,
                   help="fraction of the run before LR decay begins")
    p.add_argument("--lr-shape", choices=["linear", "cosine"], default="linear",
                   help="decay shape past --lr-decay-start")
    p.add_argument("--metrics-jsonl", default=None,
                   help="append one full-precision JSON metrics row per log "
                        "boundary to this path")
    p.add_argument("--eval-kept", action="store_true",
                   help="after training, greedy-eval every kept checkpoint "
                        "and record the best step in run_meta.json")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p


def lr_at(args, c: dict, frac: float) -> float:
    """Piecewise LR: lr0 until --lr-decay-start, then decay to lr1."""
    lr0 = args.lr0 if args.lr0 is not None else c["lr0"]
    lr1 = args.lr1 if args.lr1 is not None else c["lr1"]
    s = args.lr_decay_start
    if frac <= s:
        return lr0
    t = (frac - s) / max(1.0 - s, 1e-9)
    if args.lr_shape == "cosine":
        return lr1 + (lr0 - lr1) * 0.5 * (1.0 + math.cos(math.pi * t))
    return lr0 + (lr1 - lr0) * t


def greedy_return(ppo: PPO, net, num_envs: int, steps: int, seed: int):
    """(mean completed-episode return, episodes) of the argmax policy over
    ``max(1, steps // 64)`` chunks of 64 steps of ``num_envs`` envs from
    ``seed``; the sums stay on the device until the end."""
    env = ppo.env
    state, ts = env.init(seed, num_envs)
    obs = (ts.board, ts.queue, ts.action_mask)
    totals = torch.zeros(2, dtype=torch.float64, device=env.device)
    with torch.inference_mode():
        for _ in range(max(1, steps // EVAL_CHUNK) * EVAL_CHUNK):
            logits, _ = net(*obs)
            state, ts = env.step(state, logits.argmax(dim=-1))
            obs = (ts.board, ts.queue, ts.action_mask)
            done = ts.done
            totals += torch.stack([
                (ts.info["episode_return"] * done).sum(dtype=torch.float64),
                done.sum(dtype=torch.float64)])
    ep_r, eps = totals.tolist()
    return ep_r / max(eps, 1.0), int(eps)


def parse_args(argv=None) -> argparse.Namespace:
    """The flags, with the usage errors raised before anything is built
    (no empty checkpoint directory is left behind)."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.checkpoint_every and not args.checkpoint_dir:
        p.error("--checkpoint-every requires --checkpoint-dir")
    if args.checkpoint_every and len(args.configs) > 1:
        # periodic step numbers would collide across configs
        p.error("--checkpoint-every supports a single --configs entry")
    if args.eval_kept and not (args.checkpoint_dir and args.checkpoint_every):
        p.error("--eval-kept requires --checkpoint-dir and --checkpoint-every")
    return args


def build(args: argparse.Namespace) -> PPO:
    """The learner every config of the sweep trains, on the preset's
    default engine."""
    return PPO(bench.make_bench_env(args.preset, device=args.device), PPOConfig(
        num_envs=args.num_envs, rollout_len=args.rollout_len, torso=args.torso,
        mlp_width=args.mlp_width, queue_mode=args.queue_mode, shuffle=args.shuffle,
    ))


def main(argv=None) -> int:
    args = parse_args(argv)
    sweep(args, build(args))
    return 0


def sweep(args: argparse.Namespace, ppo: PPO) -> None:
    """Every config of ``args`` on ``ppo``: the records, the summary, the
    metrics rows and the checkpoints (see the module docstring)."""
    env = ppo.env
    mgr = run_meta = None
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir, max_to_keep=args.keep)
        # self-describing checkpoint directory (cli/evaluate.py reads it)
        run_meta = {
            "algo": "ppo", "preset": args.preset, "env_overrides": [],
            "torso": args.torso, "mlp_width": args.mlp_width,
            "queue_mode": args.queue_mode,
            "state_impl": env.state_impl,  # cli/train.py --resume must match
        }
        mgr.save_run_meta(run_meta)
    ent_cadence = args.ent_every if args.ent_every > 0 else args.log_every
    kl_cadence = args.kl_every if args.kl_every > 0 else args.log_every
    metrics_f = open(args.metrics_jsonl, "a") if args.metrics_jsonl else None
    try:
        results, best = [], None  # best: (greedy return, name, state, record)
        for ci, name in enumerate(args.configs):
            c = CONFIGS[name]
            state = ppo.init(args.seed * 131 + ci)
            t0 = time.perf_counter()
            ent_mult = clip_mult = 1.0  # the controllers' host-side state
            for u in range(args.updates):
                frac = u / max(args.updates - 1, 1)
                ent = c["ent0"] + (c["ent1"] - c["ent0"]) * frac
                hypers = {
                    "lr": lr_at(args, c, frac),
                    "entropy_coef": ent_mult * ent,
                    "clip_eps": clip_mult * c["clip"],
                    "gamma": c["gamma"],
                    "gae_lambda": c["lam"],
                    "value_coef": c["vc"],
                }
                state, metrics = ppo.update(state, hypers)
                log_now = (u + 1) % args.log_every == 0 or u == 0
                ent_now = args.ent_floor > 0.0 and ((u + 1) % ent_cadence == 0 or u == 0)
                kl_now = args.kl_target > 0.0 and ((u + 1) % kl_cadence == 0 or u == 0)
                if log_now or ent_now or kl_now:
                    host = host_metrics(metrics)  # one device -> host read
                    # the multipliers this update ran with: the controllers
                    # below set those of the next update
                    applied_ent, applied_clip = ent_mult, clip_mult
                    if ent_now:
                        ent_mult = min(max(1.0, ent_mult * math.exp(
                            args.ent_adapt * (args.ent_floor - host["entropy"]))),
                            args.ent_max_mult)
                    if kl_now:
                        kl = host["approx_kl"]
                        if kl > 2.0 * args.kl_target:
                            clip_mult = max(clip_mult / args.kl_adapt, args.kl_min_mult)
                        elif kl < 0.5 * args.kl_target:
                            clip_mult = min(clip_mult * args.kl_adapt, args.kl_max_mult)
                    if log_now and metrics_f is not None:
                        # json floats round-trip exactly: two runs' streams
                        # compare bit for bit
                        row = {"config": name, "update": u + 1,
                               "ent_mult": applied_ent, "lr": hypers["lr"],
                               "entropy_coef": hypers["entropy_coef"],
                               "clip_mult": applied_clip,
                               "clip_eps": hypers["clip_eps"]}
                        row.update(sorted(host.items()))
                        metrics_f.write(json.dumps(row) + "\n")
                        metrics_f.flush()
                    if log_now:
                        print(f"[{name}] update {u + 1}/{args.updates}: train return "
                              f"{host['episode_return']:.1f} entropy "
                              f"{host['entropy']:.3f}"
                              + (f" ent_mult {ent_mult:.2f}" if args.ent_floor > 0.0
                                 else "")
                              + (f" clip_mult {clip_mult:.3f}" if args.kl_target > 0.0
                                 else "")
                              + (f" lr {hypers['lr']:.2e}" if args.lr_decay_start > 0.0
                                 else ""), file=sys.stderr)
                if (args.checkpoint_every and (u + 1) % args.checkpoint_every == 0
                        and u + 1 < args.updates):  # the final save comes below
                    mgr.save(u + 1, state)
                    print(f"[{name}] checkpointed update {u + 1}", file=sys.stderr)
            # timing barrier: the last update's metrics, read on the host
            last_ret = host_metrics(metrics)["episode_return"]
            train_s = time.perf_counter() - t0
            ret, n_eps = greedy_return(ppo, state.net, args.eval_envs, args.eval_steps,
                                       10_000 + ci)
            frames = args.updates * args.num_envs * args.rollout_len
            rec = {
                "config": name, "seed": args.seed, "num_envs": args.num_envs,
                "rollout_len": args.rollout_len, "preset": args.preset,
                "torso": args.torso, "mlp_width": args.mlp_width,
                "queue_mode": args.queue_mode, "shuffle": args.shuffle, **c,
                # the effective LR schedule: CLI overrides and shape
                "lr0_eff": args.lr0 if args.lr0 is not None else c["lr0"],
                "lr1_eff": args.lr1 if args.lr1 is not None else c["lr1"],
                "lr_decay_start": args.lr_decay_start, "lr_shape": args.lr_shape,
                "ent_floor": args.ent_floor,
                "ent_every": ent_cadence if args.ent_floor > 0.0 else 0,
                "ent_mult_final": round(ent_mult, 3),
                "kl_target": args.kl_target, "kl_adapt": args.kl_adapt,
                "kl_min_mult": args.kl_min_mult, "kl_max_mult": args.kl_max_mult,
                "kl_every": kl_cadence if args.kl_target > 0.0 else 0,
                "clip_mult_final": round(clip_mult, 4),
                "updates": args.updates,
                "greedy_return": round(ret, 1),
                "eval_episodes": n_eps,
                "final_train_return": round(last_ret, 1),
                "train_s": round(train_s, 1),
                "frames_per_s": round(frames / train_s),
            }
            print(json.dumps(rec))
            sys.stdout.flush()
            results.append(rec)
            if best is None or ret > best[0]:
                best = (ret, name, state, rec)
        results.sort(key=lambda r: -r["greedy_return"])
        print(json.dumps({"summary": results, "best": results[0]["config"]}))
        if mgr is not None and best is not None:
            save_best(args, ppo, mgr, run_meta, best)
            mgr.close()
    finally:
        if metrics_f is not None:
            metrics_f.close()


def save_best(args, ppo: PPO, mgr: CheckpointManager, run_meta: dict, best) -> None:
    """The best config's final state at step ``--updates``, its recipe (the
    record's inputs) in ``run_meta.json``; with ``--eval-kept`` every kept
    checkpoint greedy-evaluated from one seed and the best step recorded
    (``cli/evaluate.py`` defaults to it)."""
    _, name, state, rec = best
    mgr.save(args.updates, state, force=True)
    run_meta["recipe"] = {k: v for k, v in rec.items() if k not in OUTCOME_KEYS}
    mgr.save_run_meta(run_meta)
    print(f"[sweep] saved best ({name}) to {args.checkpoint_dir}", file=sys.stderr)
    if not args.eval_kept:
        return
    net = ppo.make_net(torch.Generator().manual_seed(0))
    curve = []
    for s in mgr.all_steps():
        mgr.restore_params(net, step=s)
        ret, n_eps = greedy_return(ppo, net, args.eval_envs, args.eval_steps, 20_000)
        row = {"checkpoint_step": s, "greedy_return": round(ret, 1),
               "eval_episodes": n_eps}
        curve.append(row)
        print(json.dumps(row))
        sys.stdout.flush()
    top = max(curve, key=lambda r: r["greedy_return"])
    run_meta["best_step"] = top["checkpoint_step"]
    run_meta["checkpoint_curve"] = curve
    mgr.save_run_meta(run_meta)
    print(json.dumps({"kept_eval_best_step": top["checkpoint_step"],
                      "kept_eval_best_return": top["greedy_return"]}))
    print(f"[sweep] kept-checkpoint peak: step {top['checkpoint_step']} greedy "
          f"{top['greedy_return']} (recorded in run_meta.json)", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
