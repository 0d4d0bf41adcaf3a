"""Seeded oracle trajectories replayed through the port (twin of
tests/test_parity.py, through blockpuzzle_tpu_torch.cli.parity).

The port's own oracle (``blockpuzzle_tpu_torch.oracle``, held to the JAX
package's in test_torch_oracle.py) records the episodes.  Its deal stream
is injected with ``auto_reset=False``; boards, queues, masks, rewards and
termination must be bit-equal to the oracle's and episode returns equal,
with zero mismatches.  The replays run on the
u8 apply-kernel step (``backend="pallas"``, the test ids without a
suffix), on the u8 clear-kernel step (``backend="jnp"``,
``state_impl="u8"``, ids ending in ``-jnp``) and on the packed engine, the
default (ids ending in ``-packed``).
"""

import dataclasses

import pytest
import torch

from blockpuzzle_tpu_torch import config as tcfg
from blockpuzzle_tpu_torch.cli import parity
from blockpuzzle_tpu_torch.env import make_env

SEEDS = {"default": [0, 1, 17], "tenten": [0, 5], "woodoku": [0, 9], "big": [0]}
BY_BACKEND = [
    pytest.param(preset, backend, state_impl, id=preset + suffix)
    for backend, state_impl, suffix in (
        ("pallas", "u8", ""), ("jnp", "u8", "-jnp"), ("jnp", "packed", "-packed"))
    for preset in sorted(SEEDS)
]


def _cfg(preset, **knobs):
    return dataclasses.replace(tcfg.PRESETS[preset](), **knobs)


@pytest.mark.parametrize("preset,backend,state_impl", BY_BACKEND)
def test_check_seed_zero_mismatches(preset, backend, state_impl):
    ct = _cfg(preset)
    env = make_env(ct, device="cpu", backend=backend, state_impl=state_impl)
    for seed in SEEDS[preset]:
        r = parity.check_seed(ct, seed, 256, env=env)
        assert r["mismatches"] == [], (seed, r["mismatches"])
        assert r["oracle_return"] == r["device_return"]
        assert r["steps"] > 0


@pytest.mark.parametrize("preset,backend,state_impl", BY_BACKEND)
def test_batched_lockstep_zero_mismatches(preset, backend, state_impl):
    ct = _cfg(preset)
    env = make_env(ct, device="cpu", backend=backend, state_impl=state_impl)
    r = parity.check_batched_lockstep(ct, env, [0, 1, 2, 3], 256)
    assert r["mismatches"] == [] and r["returns_equal"]
    assert r["episodes"] == 4


@pytest.mark.parametrize("knobs", [
    {"max_steps": 12},
    {"piece_set": "mini5", "queue_size": 2, "refill_batch": True},
    {"height": 5, "width": 5, "piece_set": "mini5", "streak_bonus": 7.0},
], ids=["truncation", "mini5-hand2", "streak"])
def test_check_seed_config_knobs(knobs):
    """On the default engine, packed."""
    ct = _cfg("default", **knobs)
    env = make_env(ct, device="cpu")
    assert env.state_impl == "packed"
    for seed in (0, 3):
        r = parity.check_seed(ct, seed, 300, env=env)
        assert r["mismatches"] == [] and r["oracle_return"] == r["device_return"]


def test_parity_cli_exit_codes(capsys):
    cpu = ["--device", "cpu"]
    assert parity.main(["--preset", "tenten", "--seeds", "2"] + cpu) == 0
    assert parity.main(["--seeds", "3", "--batch"] + cpu) == 0
    assert parity.main(["--seeds", "2", "--state-impl", "u8"] + cpu) == 0
    out = capsys.readouterr().out
    assert out.count("PASS (bit-exact)") == 3


def test_parity_cli_defaults_to_cuda():
    """Read off the parser: this machine may have no card to build on."""
    args = parity.build_parser().parse_args([])
    assert args.device == "cuda" and args.state_impl == "auto"
    assert parity.build_parser().parse_args(["--device", "cpu"]).device == "cpu"


def test_parity_cli_asked_for_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this checks the failure without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity.main(["--seeds", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity.check_seed(_cfg("default"), 0, 8)
