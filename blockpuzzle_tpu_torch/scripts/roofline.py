"""Roofline of the bench's step: bytes and operations a step an env, the
least time the card could take for a batched step, and the measured rate
as a share of it.

    python -m blockpuzzle_tpu_torch.scripts.roofline [--num-envs 49152] \\
        [--chunk 400] [--preset default] [--no-time] [--iters 8] \\
        [--windows 3] [--device cuda|cpu]

The port of ``scripts/roofline.py``.  It counts the bench's exact chunk:
the engine of ``bench.make_bench_env``, the policy of
``bench.make_policy(env, "argmax", n)`` and ``bench.run_chunk``, the body
``bench.py`` and ``scripts.profile_step`` run.  The JAX script asks XLA's
cost model (``Compiled.cost_analysis()``); the port has none, so it counts
one chunk itself, in a pass of its own that is never timed:

* torch ops: an ``OpCounter`` (a ``TorchDispatchMode``) sees every aten op
  of the chunk.  Its bytes are the op's tensor inputs plus its tensor
  outputs (an input broadcast along a stride-0 dimension counts each
  distinct element once); its operations one per output element, or one
  per input element for a reduction.  Views, aliases and ``empty``
  allocations count zero.
* hand kernels: they launch through ctypes, which the mode never sees on
  the card, while on the CPU the same call runs its plain version as torch
  ops, which the mode does see.  For the count pass only, the engine's
  kernel wrappers (the deal's and, on packed boards, the step tail's among
  them) and the policy's draw kernel are
  wrapped (``counted_kernels``): each call runs with the count paused and
  adds the bytes and operations that ``utils/bounds.py`` gives for the
  call's own tensors, so both devices count the same work.  The engine and
  the sampler are otherwise unchanged.
* the state floor: the least any implementation of the step must move,
  each ``EnvState`` field read and written once, the action in and the
  mask, reward and done flags out (``state_floor_bytes``).

The floors are those of one H100 SXM (``utils/bounds.py``): bytes over
3.35 TB/s, operations (integer and float alike, as XLA counts
elementwise work) over the 16.7 T/s 32-bit integer rate.  The step has no matrix
product, so JAX's ``mxu_bf16_*`` keys have no counterpart.  Timed windows
follow the JAX protocol through ``bench.bench_device``: a warm-up chunk,
then ``--windows`` windows of ``--iters`` chunks, each ending in a sync and
a host read of its reward sum; the median window is the rate.  On the CPU
the rate is printed but says nothing of the card.

``--mask-impl`` and ``--mask-dtype`` chose how the TPU computed the same
mask; only their defaults (``bitboard``, ``int8``) are accepted.

Prints ONE JSON line: ``metric`` ("roofline"), ``num_envs``, ``chunk``,
``mask_impl``, ``device``, ``flops_per_step_env``, ``bytes_per_step_env``,
``kernel_bytes_per_step_env`` (the hand kernels' share),
``state_bytes_per_step_env``, ``kernel_launches_per_step``, the floors of
one batched step (``hbm_floor_us_per_batched_step``,
``core_ops_floor_us_per_batched_step``,
``state_floor_us_per_batched_step``) with the rates they allow
(``hbm_bound_steps_per_s``, ``core_bound_steps_per_s``), and unless
``--no-time`` ``measured_steps_per_s``, ``measured_us_per_batched_step``
and ``pct_of_hbm_bound``, ``pct_of_core_bound``, ``pct_of_state_bound``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import sys
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from blockpuzzle_tpu_torch import bench
from blockpuzzle_tpu_torch.cli.rollout import device_name
from blockpuzzle_tpu_torch.config import PRESETS
from blockpuzzle_tpu_torch.env import VecBlockPuzzle
from blockpuzzle_tpu_torch.utils.bounds import (
    COSTS,
    HBM_BYTES_PER_S,
    INT_OPS_PER_S,
    nbytes,
)

# knobs of the JAX script that change no output: only their default runs
NOT_PORTED = {"mask_impl": "bitboard", "mask_dtype": "int8"}
# aten ops whose operations are one per input element
REDUCTIONS = frozenset({"sum", "any", "all", "argmax", "argmin", "amax", "amin",
                        "max", "min", "prod", "mean"})
# aten ops that move no data: allocations and reshapes of fresh results
FREE = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "_unsafe_view"})
# the engine's step kernels: attribute -> kernel name in ``COSTS``, or None
# for the wrappers that pick their kernel by shape and name it (``name``:
# ``mask_wide``, ``clear_tall``, ``packed_apply_general``, ...)
STEP_KERNELS = {"deal_kernel": "deal", "mask_kernel": None, "apply_kernel": None,
                "clear_kernel": None, "packed_apply_kernel": None,
                "packed_mask_kernel": None, "packed_tail_kernel": None}
# a sampler's draw kernel: sampler class name -> kernel name in ``COSTS``
POLICY_KERNELS = {"UniformLegalSampler": "uniform_legal",
                  "WordsSampler": "words_select"}


def read_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads of input ``t``: each distinct element once (a
    dimension of stride 0 is a broadcast of one element)."""
    distinct = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            distinct *= size
    return distinct * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the bytes and operations of every aten op run under it
    (``torch_*``, the bytes also by op in ``op_bytes``) and of every
    hand-kernel call made through ``kernel`` (``kernel_*``, ``launches`` by
    kernel name)."""

    def __init__(self) -> None:
        super().__init__()
        self.torch_bytes = self.torch_ops = self.torch_calls = 0
        self.kernel_bytes, self.kernel_ops = 0, 0.0
        self.launches: Dict[str, int] = collections.Counter()
        self.op_bytes: Dict[str, int] = collections.Counter()
        self._paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if self._paused or func.is_view or name in FREE:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        moved = sum(map(read_bytes, ins)) + nbytes(outs)
        self.torch_bytes += moved
        self.op_bytes[name] += moved
        if name in REDUCTIONS and ins:
            self.torch_ops += ins[0].numel()
        else:
            self.torch_ops += sum(t.numel() for t in outs)
        self.torch_calls += 1
        return out

    def kernel(self, name: str, cfg, fn, args):
        """``fn(*args)`` (a hand kernel's call) with the torch count paused;
        adds the call's bytes and operations from ``COSTS[name]``."""
        self._paused = True
        try:
            out = fn(*args)
            nb, ops = COSTS[name](cfg, args, out if isinstance(out, tuple) else (out,))
        finally:
            self._paused = False
        self.kernel_bytes += nb
        self.kernel_ops += ops
        self.launches[name] += 1
        return out


class CountedKernel:
    """A kernel wrapper of the engine whose calls ``counter`` counts as
    that kernel's work; every other attribute is the wrapped one's."""

    def __init__(self, kernel, name: str, counter: OpCounter) -> None:
        self._kernel, self._name, self._counter = kernel, name, counter

    def __call__(self, *args):
        cfg = getattr(self._kernel, "cfg", None)  # the draws are bound to no config
        return self._counter.kernel(self._name, cfg, self._kernel, args)

    def __getattr__(self, attr):
        return getattr(self._kernel, attr)


@contextlib.contextmanager
def counted_kernels(env: VecBlockPuzzle, counter: OpCounter, sampler=None):
    """The engine's step kernels (each under the name of the kernel its
    wrapper picks on the board) and ``sampler``'s draw kernel replaced by
    ``CountedKernel``s inside the block; restored after it."""
    saved = {attr: getattr(env, attr) for attr in STEP_KERNELS}
    draw = None if sampler is None else sampler.kernel
    try:
        for attr, name in STEP_KERNELS.items():
            k = saved[attr]
            if k is None:
                continue
            setattr(env, attr, CountedKernel(k, name or k.name, counter))
        if sampler is not None:
            sampler.kernel = CountedKernel(draw, POLICY_KERNELS[type(sampler).__name__],
                                           counter)
        yield
    finally:
        for attr, k in saved.items():
            setattr(env, attr, k)
        if sampler is not None:
            sampler.kernel = draw


def state_floor_bytes(state, action: torch.Tensor, ts) -> int:
    """The least bytes any implementation of one batched step moves: each
    ``EnvState`` field read and written once, the action in, the mask,
    reward and done flags out."""
    fields = [getattr(state, f.name) for f in dataclasses.fields(state)]
    return 2 * nbytes(fields) + nbytes(
        [action, ts.action_mask, ts.reward, ts.terminated, ts.truncated])


@dataclasses.dataclass
class Count:
    """One chunk's count, totals over ``steps`` steps of ``num_envs`` envs."""

    num_envs: int
    steps: int
    torch_bytes: int
    torch_ops: int
    kernel_bytes: int
    kernel_ops: float
    launches: Dict[str, int]
    op_bytes: Dict[str, int]  # the torch ops' bytes by aten op
    state_bytes: int          # the state floor of one batched step

    def per_step_env(self, total) -> float:
        return total / (self.num_envs * self.steps)


def count_chunk(env: VecBlockPuzzle, num_envs: int, chunk: int, seed: int = 0) -> Count:
    """The bench's chunk (engine from ``seed``, policy from ``seed + 1``,
    as ``bench.bench_device`` starts them) run once under an ``OpCounter``
    with the engine's kernels counted; the state floor from the initial
    state, a first action and the initial timestep (a step's fields and
    dtypes), taken outside the count."""
    state, ts = env.init(seed, num_envs)
    with torch.inference_mode():
        first = bench.make_policy(env, "argmax", num_envs, seed + 1)(state,
                                                                     ts.action_mask)
        floor = state_floor_bytes(state, first, ts)
        policy = bench.make_policy(env, "argmax", num_envs, seed + 1)
        counter = OpCounter()
        with counted_kernels(env, counter, policy.sampler), counter:
            bench.run_chunk(env, state, ts.action_mask, policy, chunk)
    return Count(num_envs, chunk, counter.torch_bytes, counter.torch_ops,
                 counter.kernel_bytes, counter.kernel_ops, dict(counter.launches),
                 dict(counter.op_bytes), floor)


def roofline(env: VecBlockPuzzle, num_envs: int, chunk: int, timed: bool = True,
             iters: int = 8, windows: int = 3) -> Dict:
    """The JSON record of the script for ``env``'s bench chunk."""
    c = count_chunk(env, num_envs, chunk)
    nb = c.per_step_env(c.torch_bytes + c.kernel_bytes)
    ops = c.per_step_env(c.torch_ops + c.kernel_ops)
    hbm_s = nb * num_envs / HBM_BYTES_PER_S
    core_s = ops * num_envs / INT_OPS_PER_S
    state_s = c.state_bytes / HBM_BYTES_PER_S
    out = {
        "metric": "roofline",
        "num_envs": num_envs,
        "chunk": chunk,
        "mask_impl": NOT_PORTED["mask_impl"],
        "device": device_name(env.device),
        "flops_per_step_env": ops,
        "bytes_per_step_env": nb,
        "kernel_bytes_per_step_env": c.per_step_env(c.kernel_bytes),
        "state_bytes_per_step_env": c.state_bytes / num_envs,
        "kernel_launches_per_step": {k: v / chunk for k, v in c.launches.items()},
        "hbm_floor_us_per_batched_step": 1e6 * hbm_s,
        "hbm_bound_steps_per_s": num_envs / hbm_s,
        "core_ops_floor_us_per_batched_step": 1e6 * core_s,
        "core_bound_steps_per_s": num_envs / core_s,
        "state_floor_us_per_batched_step": 1e6 * state_s,
    }
    print(f"[roofline] {c.per_step_env(c.torch_bytes):.1f} B/step/env in torch ops, "
          f"{out['kernel_bytes_per_step_env']:.1f} in hand kernels {c.launches}; "
          f"{ops:.1f} ops/step/env; state floor "
          f"{out['state_bytes_per_step_env']:.1f} B/step/env; the torch ops' "
          "largest: " + ", ".join(f"{k} {c.per_step_env(v):.1f}" for k, v in
                                  sorted(c.op_bytes.items(), key=lambda kv: -kv[1])[:6]),
          file=sys.stderr)
    if timed:
        value = bench.bench_device(env, num_envs, "argmax", chunk, iters, windows)["value"]
        if env.device.type != "cuda":
            print(f"[roofline] timed on {env.device}: the rate says nothing of "
                  "the card", file=sys.stderr)
        step_us = 1e6 * num_envs / value
        out.update({
            "measured_steps_per_s": value,
            "measured_us_per_batched_step": step_us,
            "pct_of_hbm_bound": 100 * out["hbm_floor_us_per_batched_step"] / step_us,
            "pct_of_core_bound": 100 * out["core_ops_floor_us_per_batched_step"] / step_us,
            "pct_of_state_bound": 100 * out["state_floor_us_per_batched_step"] / step_us,
        })
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-envs", type=int, default=49152)
    p.add_argument("--chunk", type=int, default=400)
    p.add_argument("--preset", choices=sorted(PRESETS), default="default")
    p.add_argument("--mask-impl", default=NOT_PORTED["mask_impl"])
    p.add_argument("--mask-dtype", default=NOT_PORTED["mask_dtype"])
    p.add_argument("--no-time", action="store_true",
                   help="the count only (no timed windows)")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    for knob, default in NOT_PORTED.items():
        value = getattr(args, knob)
        if value != default:
            p.error(f"--{knob.replace('_', '-')} {value!r} is not ported: it chose "
                    f"how the TPU computed the same mask; only {default!r} runs")
    env = bench.make_bench_env(args.preset, device=args.device)
    print(json.dumps(roofline(env, args.num_envs, args.chunk, not args.no_time,
                              args.iters, args.windows)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
