"""The words sampler against the bench's argmax sampler, on the bench body.

    python -m blockpuzzle_tpu_torch.scripts.bench_words [--modes base packsel words]

The port of ``scripts/bench_words.py``.  Three modes, one process, the
bench's protocol (``bench.bench_device``) on the packed engine:

* ``base``: the bench's sampler, an iid u32 draw over the (N, A) bool mask
  and an argmax (``sampler.UniformLegalSampler``);
* ``packsel``: the bool mask packed to (N, S*H) row words
  (``env/words.py`` ``pack_bool_mask``), then one (N,) uniform and the
  rank-select (``sample_uniform_legal``);
* ``words``: the legal mask made as row words by the packed mask kernel's
  words entry (``sampler.WordsSampler``), then the same rank-select.

All three are uniform over the legal actions (up to the float32 rank
draw's ~total/2**24 bias).  Prints one JSON line per mode
(``{"mode", "num_envs", "steps_per_s", "device"}``, the true median of
the windows) and, with ``base`` among them, ``{"relative_to_base": ...}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from blockpuzzle_tpu_torch import bench
from blockpuzzle_tpu_torch.cli.rollout import device_name
from blockpuzzle_tpu_torch.config import PRESETS

MODES = {"base": "argmax", "packsel": "packsel", "words": "words"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--modes", nargs="*", default=list(MODES), choices=list(MODES))
    p.add_argument("--num-envs", type=int, default=bench.NUM_ENVS)
    p.add_argument("--chunk", type=int, default=200)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--preset", choices=sorted(PRESETS), default="default")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    env = bench.make_bench_env(args.preset, "packed", device=args.device)
    results = {}
    for mode in args.modes:
        r = bench.bench_device(env, args.num_envs, MODES[mode], args.chunk,
                               args.iters, args.windows)
        # the true median: for an even count, the mean of the middle pair
        results[mode] = statistics.median(r["rates"])
        print(json.dumps({"mode": mode, "num_envs": args.num_envs,
                          "steps_per_s": round(results[mode]),
                          "device": device_name(env.device)}))
        sys.stdout.flush()
    if len(results) > 1 and "base" in results:
        print(json.dumps({"relative_to_base": {
            m: round(v / results["base"], 4) for m, v in results.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
