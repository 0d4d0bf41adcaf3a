"""Scaling of the batched step over 1, 2, 4, ... ranks (the JAX harness of
``scripts/bench_scaling.py``, over ``torch.distributed``).

    python -m blockpuzzle_tpu_torch.scripts.bench_scaling [--cpu-sim] \\
        [--envs-per-device 4096] [--chunk 50] [--iters 3]

For each size d in 1, 2, 4, ... up to the number of cards, d ranks are
spawned (``torch.multiprocessing``, start method ``spawn``) and join one
process group through ``dist.init_distributed``, with ``dist``'s backend
rule: nccl where each rank has a card, gloo where ranks share one or run on
the CPU.  ``--cpu-sim`` runs 8 gloo ranks on the CPU, the JAX flag's 8
simulated devices: it shows that the harness works, not how the port
scales.  So do ranks sharing one card: on one H100 the sizes are ``[1]``.

Rank r of d holds the envs ``[r*n, (r+1)*n)`` of one global batch (the
default engine from ``env.init(seed, n, env_offset=r*n)``) and draws its
actions uniformly over the legal ones from its rows of one global policy
stream (``UniformLegalSampler(seed + 1, n, device, env_offset=r*n)``, the
distribution of JAX's ``categorical(where(mask, 0, -1e9))``; the port draws
from its own stream).  Each rank steps one warm chunk, meets the others at
a barrier, steps ``--iters`` timed chunks (``bench.run_chunk``), syncs and
meets them again.  The global rate is d * n * chunk * iters over the
slowest rank's seconds.  The envs are independent, so the step has no
collective; the loss against linear is the harness's own.

Prints a line per size, its rate and its efficiency against linear, and
ONE JSON line ``{"metric": "scaling_efficiency", "devices": [...],
"steps_per_s": {"1": ..., ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from blockpuzzle_tpu_torch import bench, dist
from blockpuzzle_tpu_torch.cli.rollout import sync
from blockpuzzle_tpu_torch.dist.mesh import gather_rows
from blockpuzzle_tpu_torch.env import EnvState
from blockpuzzle_tpu_torch.sampler import UniformLegalSampler

CPU_SIM_RANKS = 8


def start(device, seed: int, num_envs: int, env_offset: int = 0):
    """The envs ``[env_offset, env_offset + num_envs)`` of the global
    batch on ``device``: (engine, state, mask, policy)."""
    env = bench.make_bench_env(device=device)
    state, ts = env.init(seed, num_envs, env_offset=env_offset)
    draw = UniformLegalSampler(seed + 1, num_envs, env.device, env_offset=env_offset)
    return env, state, ts.action_mask, lambda state, mask: draw(mask)


def unsharded_state(device, num_envs: int, chunk: int, iters: int,
                    seed: int = 0) -> EnvState:
    """One process's final state (on the CPU) after the steps a rank takes
    (a warm chunk and ``iters`` chunks), on all ``num_envs`` envs."""
    env, state, mask, policy = start(device, seed, num_envs)
    with torch.inference_mode():
        for _ in range(1 + iters):
            state, mask, _ = bench.run_chunk(env, state, mask, policy, chunk)
    return state.to("cpu")


def _rank(rank: int, world: int, port: int, device: str, n: int, chunk: int,
          iters: int, seed: int, gather: bool, out: str) -> None:
    """One rank of a size-``world`` run, as torchrun would start it; writes
    its timed seconds, and rank 0 the gathered final states, under
    ``out``."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    dist.init_distributed(device)
    try:
        env, state, mask, policy = start(dist.pick_device(device), seed, n, rank * n)
        with torch.inference_mode():
            state, mask, r = bench.run_chunk(env, state, mask, policy, chunk)
            sync(env.device)
            float(r)
            tdist.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                state, mask, r = bench.run_chunk(env, state, mask, policy, chunk)
            sync(env.device)
            float(r)
            seconds = time.perf_counter() - t0
            tdist.barrier()
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"seconds": seconds, "backend": tdist.get_backend(),
                       "device": str(env.device)}, f)
        if gather:
            rows = gather_rows(dict(vars(state)), tdist.group.WORLD)
            if rank == 0:
                torch.save({k: v.cpu() for k, v in rows.items()},
                           os.path.join(out, "state.pt"))
    finally:
        tdist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(sizes: List[int], device: str = "cuda", envs_per_device: int = 4096,
        chunk: int = 50, iters: int = 3, seed: int = 0, gather: bool = False
        ) -> Dict:
    """Each size of ``sizes`` as that many spawned ranks on ``device``.
    Returns ``steps_per_s`` (size -> global env-steps/s), ``ranks`` (size ->
    each rank's backend, device and seconds) and, with ``gather``,
    ``states`` (size -> the ranks' final ``EnvState`` gathered in rank
    order, on the CPU)."""
    steps_per_s, ranks, states = {}, {}, {}
    for d in sizes:
        with tempfile.TemporaryDirectory() as out:
            mp.start_processes(_rank, args=(d, _free_port(), device, envs_per_device,
                                            chunk, iters, seed, gather, out),
                               nprocs=d, join=True, start_method="spawn")
            recs = []
            for r in range(d):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    recs.append(json.load(f))
            if gather:
                states[d] = EnvState(**torch.load(os.path.join(out, "state.pt"),
                                                  weights_only=True))
        ranks[d] = recs
        slowest = max(rec["seconds"] for rec in recs)
        steps_per_s[d] = d * envs_per_device * chunk * iters / max(slowest, 1e-9)
    out = {"steps_per_s": steps_per_s, "ranks": ranks}
    if gather:
        out["states"] = states
    return out


def sizes_up_to(count: int) -> List[int]:
    """1, 2, 4, ... up to ``count``."""
    sizes = [1]
    while sizes[-1] * 2 <= count:
        sizes.append(sizes[-1] * 2)
    return sizes


def report(results: Dict) -> List[str]:
    """The printed lines of ``run``'s results: one per size, with its
    efficiency against linear, then the JSON line."""
    rates = results["steps_per_s"]
    sizes = list(rates)
    lines = []
    for d in sizes:
        eff = rates[d] / (rates[sizes[0]] * d / sizes[0])
        rec = results["ranks"][d][0]
        lines.append(f"devices={d}: {rates[d] / 1e6:8.2f}M steps/s (efficiency vs "
                     f"linear: {eff * 100:5.1f}%) [{rec['backend']}, {rec['device']}]")
    lines.append(json.dumps({"metric": "scaling_efficiency", "devices": sizes,
                             "steps_per_s": {str(d): rates[d] for d in sizes}}))
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu-sim", action="store_true",
                   help=f"{CPU_SIM_RANKS} gloo ranks on the CPU")
    p.add_argument("--envs-per-device", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args(argv)
    if args.cpu_sim:
        device, count = "cpu", CPU_SIM_RANKS
    else:
        if not torch.cuda.is_available():
            p.error("no CUDA card: pass --cpu-sim for the CPU harness")
        device, count = "cuda", torch.cuda.device_count()
    results = run(sizes_up_to(count), device, args.envs_per_device, args.chunk,
                  args.iters)
    for line in report(results):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
