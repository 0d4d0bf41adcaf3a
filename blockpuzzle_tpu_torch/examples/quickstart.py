"""Quickstart: every public surface of the port in four sections.

    python -m blockpuzzle_tpu_torch.examples.quickstart [--device cuda|cpu]

The port of ``examples/quickstart.py``: a single env through Gymnasium, the
vector env through Gymnasium, the raw batched engine (and the packed
legal-words sampler), and a short training run.  Each section is a
function.  The two Gymnasium sections import gymnasium and
``blockpuzzle_tpu_torch.vector_env`` (which registers the port's ids)
inside their functions, so the others run where gymnasium is missing; there
those two raise ``ImportError``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from blockpuzzle_tpu_torch.env import make_env
from blockpuzzle_tpu_torch.env.words import legal_words
from blockpuzzle_tpu_torch.sampler import UniformLegalSampler, WordsSampler

ENV_ID = "BlockPuzzleTpuTorch/BlockPuzzle-v0"


def single_env() -> None:
    """1. One env through the Gymnasium API (the reference usage), played
    uniform-legal to the end of its episode."""
    import gymnasium

    import blockpuzzle_tpu_torch.vector_env  # noqa: F401  (registers the ids)

    env = gymnasium.make(ENV_ID, render_mode="ansi")
    obs, info = env.reset(seed=42)
    rng = np.random.default_rng(0)
    while True:
        legal = np.flatnonzero(info["action_mask"])
        if legal.size == 0:
            break
        obs, r, term, trunc, info = env.step(int(rng.choice(legal)))
        if term or trunc:
            break
    print("single env final board:")
    print(env.render())


def vector_env(device: str) -> None:
    """2. The batched engine on ``device``, still through Gymnasium."""
    import gymnasium

    import blockpuzzle_tpu_torch.vector_env  # noqa: F401  (registers the ids)

    venv = gymnasium.make_vec(ENV_ID, num_envs=256, device=device)
    obs, infos = venv.reset(seed=0)
    rng = np.random.default_rng(1)
    for _ in range(50):
        mask = infos["action_mask"]
        actions = (rng.random(mask.shape) * mask).argmax(1)
        obs, rew, term, trunc, infos = venv.step(actions)
    print(f"vector env: mean reward/step {rew.mean():.2f}")
    venv.close()


def engine(device: str) -> None:
    """3. The raw engine: functions of tensors on ``device``; then the
    packed legal words and their rank-select sampler (a consumer that
    wants the mask as (N, S*H) row words, e.g. to ship it over a wire)."""
    env = make_env(device=device)
    n = 1024
    state, ts = env.init(0, n)
    sampler = UniformLegalSampler(1, n, env.device)
    total = torch.zeros((), dtype=torch.float32, device=env.device)
    with torch.inference_mode():
        for _ in range(100):
            state, ts = env.step(state, sampler(ts.action_mask))
            total = total + ts.reward.sum()
        print(f"engine: 100x{n} steps, reward/step {float(total) / (100 * n):.2f}")
        wmask = legal_words(env, state.board, state.queue)
        acts = WordsSampler(2, n, env.device)(env, state.board, state.queue)
    print(f"words sampler: one uniform-legal action per env (N={acts.shape[0]}, "
          f"words {tuple(wmask.shape)}), first id {int(acts[0])}")


def train(device: str) -> None:
    """4. Training: two PPO updates through the train CLI, then the CLIs."""
    from blockpuzzle_tpu_torch.cli import train as train_cli

    train_cli.main(["--num-envs", "256", "--rollout-len", "16", "--updates", "2",
                    "--log-every", "1", "--device", device])
    print("train:    python -m blockpuzzle_tpu_torch.cli.train --algo ppo")
    print("evaluate: python -m blockpuzzle_tpu_torch.cli.evaluate "
          "--checkpoint-dir ...")
    print("parity:   python -m blockpuzzle_tpu_torch.cli.parity")
    print("bench:    python -m blockpuzzle_tpu_torch.bench")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    single_env()
    vector_env(args.device)
    engine(args.device)
    train(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
