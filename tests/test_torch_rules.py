"""The port's copies of config.py and rules.py against the JAX package's.

The port keeps its own copies (the JAX package imports gymnasium when it is
imported), so these tests pin every config field and every rule table to
the JAX package's, bit for bit, and check that importing the port loads
neither JAX nor the JAX package.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

from blockpuzzle_tpu import config as jax_config
from blockpuzzle_tpu import rules as jax_rules
from blockpuzzle_tpu_torch import config as torch_config
from blockpuzzle_tpu_torch import rules as torch_rules

CASES = sorted(jax_config.PRESETS) + ["mini5"]


def _pair(case):
    if case == "mini5":
        return (jax_config.EnvConfig(piece_set="mini5"),
                torch_config.EnvConfig(piece_set="mini5"))
    return jax_config.PRESETS[case](), torch_config.PRESETS[case]()


def test_preset_names_match():
    assert sorted(torch_config.PRESETS) == sorted(jax_config.PRESETS)
    assert torch_rules.PIECE_SETS == jax_rules.PIECE_SETS


@pytest.mark.parametrize("case", CASES)
def test_config_fields_match(case):
    cj, ct = _pair(case)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.num_actions() == cj.num_actions()
    assert ct.board_shape == cj.board_shape


@pytest.mark.parametrize("case", CASES)
def test_rule_tables_match(case):
    """Every RuleTables field equal, dtype included."""
    cj, ct = _pair(case)
    tj, tt = jax_rules.tables_for(cj), torch_rules.tables_for(ct)
    for f in dataclasses.fields(tj):
        a, b = getattr(tj, f.name), getattr(tt, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("case", CASES)
def test_piece_plane_table_matches(case):
    cj, ct = _pair(case)
    a, b = jax_rules.piece_plane_table(cj), torch_rules.piece_plane_table(ct)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)


def test_decompose_rects_matches():
    for grids in jax_rules.PIECE_SETS.values():
        for g in grids:
            g = np.asarray(g, np.uint8)
            assert torch_rules.decompose_rects(g) == jax_rules.decompose_rects(g)


def test_overrides_and_validation_match():
    over = ["streak_bonus=5", "queue_size=3", "refill_batch=yes"]
    a = jax_config.apply_env_overrides(jax_config.EnvConfig(), over)
    b = torch_config.apply_env_overrides(torch_config.EnvConfig(), over)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for bad in ({"piece_set": "nope"}, {"height": 0},
                {"region_clear": True, "height": 10}):
        with pytest.raises(ValueError):
            torch_config.EnvConfig(**bad)
    with pytest.raises(ValueError):
        torch_config.apply_env_overrides(torch_config.EnvConfig(), ["bogus=1"])


def test_import_loads_no_jax():
    """In a fresh interpreter (conftest has already imported jax here)."""
    code = (
        "import sys, blockpuzzle_tpu_torch, blockpuzzle_tpu_torch.cli.rollout, "
        "blockpuzzle_tpu_torch.cli.parity, blockpuzzle_tpu_torch.cli.train, "
        "blockpuzzle_tpu_torch.interop, blockpuzzle_tpu_torch.learn, "
        "blockpuzzle_tpu_torch.sampler\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'blockpuzzle_tpu', 'gymnasium')]\n"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
