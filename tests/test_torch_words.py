"""The port's packed legal words and rank-select sampler
(``blockpuzzle_tpu_torch/env/words.py``, ``sampler.WordsSampler`` and the
packed mask kernel's words entry) against JAX's
``blockpuzzle_tpu/env/words.py``, twinning ``tests/test_bench_words.py``.

Everything compared is an integer and must be bit-equal.  JAX is imported
inside the tests that use it, so the ``gpu`` test runs on a machine
without it: ``python -m pytest --noconftest -m gpu tests/test_torch_words.py``.
"""

import functools

import numpy as np
import pytest
import torch

from blockpuzzle_tpu_torch import PRESETS, make_env
from blockpuzzle_tpu_torch.cli.rollout import rollout
from blockpuzzle_tpu_torch.env.words import (
    legal_words,
    pack_bool_mask,
    rank_select_bit,
    sample_uniform_legal,
)
from blockpuzzle_tpu_torch.kernels import PackedMaskKernel
from blockpuzzle_tpu_torch.kernels.packed import popcount32
from blockpuzzle_tpu_torch.sampler import (
    UniformLegalSampler,
    WordsSampler,
    uniform_from_bits,
)

ALL_PRESETS = ["default", "tenten", "woodoku", "big"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU has only the plain versions)")
    return torch.device("cuda")


def jax_modules():
    """jax, jax.numpy and the JAX package's words module."""
    import jax
    import jax.numpy as jnp

    from blockpuzzle_tpu.env import words

    return jax, jnp, words


@functools.cache
def jax_packed_engine(preset):
    """JAX's packed engine and its jitted step in parity mode without
    auto-reset (finished envs keep their boards, so both engines agree)."""
    jax, _, _ = jax_modules()
    from blockpuzzle_tpu import config as jcfg
    from blockpuzzle_tpu.env import make_env as jax_make_env

    env_j = jax_make_env(jcfg.PRESETS[preset](), state_impl="packed")
    step_j = jax.jit(lambda s, a, d: env_j.step(s, a, deal_override=d, auto_reset=False))
    return env_j, step_j


def legal_choice(mask, rng):
    return np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0 for m in mask],
                    dtype=np.int32)


def midgame(preset, n, steps, seed=0):
    """A CPU packed engine and its state after ``steps`` uniform-legal
    steps."""
    env = make_env(PRESETS[preset](), device="cpu")
    state, ts = env.init(seed, n)
    sampler = UniformLegalSampler(seed + 1, n, "cpu")
    for _ in range(steps):
        state, ts = env.step(state, sampler(ts.action_mask))
    return env, state, ts


# ------------------------------------------------------------ legal words ----


@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_legal_words_bit_matches_bool_mask(preset):
    env = make_env(PRESETS[preset](), device="cpu")
    cfg = env.cfg
    state, ts = env.init(0, 32)
    sampler = UniformLegalSampler(1, 32, "cpu")
    for _ in range(6):
        state, ts = env.step(state, sampler(ts.action_mask))
        got = legal_words(env, state.board, state.queue)
        assert got.dtype == torch.int64 and got.shape == (32, cfg.queue_size * cfg.height)
        assert torch.equal(got, pack_bool_mask(ts.action_mask, cfg.height, cfg.width,
                                               cfg.queue_size))
        assert env.packed_mask_kernel.launches == env.packed_mask_kernel.words_launches == 0


@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_legal_words_match_jax(preset):
    """Both engines take the same actions and injected deals; after every
    step (and at init) the port's legal words equal JAX's ``legal_words``
    and JAX's bool mask packed by JAX's ``pack_bool_mask``."""
    jax, jnp, jwords = jax_modules()
    env_j, step_j = jax_packed_engine(preset)
    env_t = make_env(PRESETS[preset](), device="cpu")
    cfg = env_t.cfg
    n, s = 16, cfg.queue_size
    rng = np.random.default_rng(3)
    init = rng.integers(0, env_t.num_pieces, (n, s)).astype(np.int32)
    sj, tj = env_j.init(jax.random.key(0), n, deal_override=jnp.asarray(init))
    st, _ = env_t.init(0, n, deal_override=init)
    for t in range(9):
        want = np.asarray(jwords.legal_words(env_j, sj.board, sj.queue))
        got = legal_words(env_t, st.board, st.queue).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64), f"t={t}")
        np.testing.assert_array_equal(
            want, np.asarray(jwords.pack_bool_mask(tj.action_mask, cfg.height,
                                                   cfg.width, s)))
        a = legal_choice(np.asarray(tj.action_mask), rng)
        d = rng.integers(0, env_t.num_pieces, (n, s)).astype(np.int32)
        sj, tj = step_j(sj, jnp.asarray(a), jnp.asarray(d))
        st, _ = env_t.step(st, a, deal_override=d, auto_reset=False)


def tall_words_envs(cfg) -> int:
    """Env-slots a block of the tall words kernel on a board of at most 32
    rows: ``kernels/packed.py`` ``anchor_launch_shape``'s count, which the
    wrapper takes from ``WORDS_TALL_FROM`` rows."""
    from blockpuzzle_tpu_torch.kernels.packed import ANCHOR_ROWS, ANCHOR_THREADS

    seg = -(-cfg.height // ANCHOR_ROWS)
    step = 16 // int(np.gcd(cfg.num_cells, 16))
    return -(-(-(-ANCHOR_THREADS // seg)) // step) * step


def emulate_words(kernel, cfg, words, queue, mk):
    """The numpy emulation of words kernel ``kernel`` on a board of at most
    32 rows: ``"bit-row"`` (csrc/packed_mask.cu) or ``"tall"`` (the tall
    words kernel of csrc/packed_tall.cu at ``tall_words_envs``)."""
    from test_torch_packed import emulate_packed_words
    from test_torch_tall import emulate_packed_anchor_words

    if kernel == "bit-row":
        return emulate_packed_words(cfg, words, queue, mk)
    return emulate_packed_anchor_words(cfg, words, queue, mk, tall_words_envs(cfg))


@pytest.mark.parametrize("kernel", ["bit-row", "tall"])
@pytest.mark.parametrize("preset", ALL_PRESETS + ["wide32", "24x9", "17x12"])
def test_words_kernel_emulation_matches_jax(preset, kernel):
    """A numpy emulation of each words kernel of boards of at most 32 rows,
    lane by lane (the bit-row kernel, ``test_torch_packed.emulate_packed_words``,
    and the tall one, ``test_torch_tall.emulate_packed_anchor_words``, the
    wrapper's from ``WORDS_TALL_FROM`` rows), on crafted boards with empty
    slots, at a ragged N, against JAX's ``legal_words``, on the presets and
    on boards of 6, 17 and 24 rows."""
    jax, jnp, jwords = jax_modules()
    from test_torch_packed import _pair, crafted_cells, np_words

    from blockpuzzle_tpu.env import make_env as jax_make_env

    cj, ct = _pair(preset)
    env_j = jax_make_env(cj, state_impl="packed")
    n = 37
    rng = np.random.default_rng(6)
    words = np_words(crafted_cells(ct, n, rng, fill=0.3))
    mk = PackedMaskKernel(ct, "cpu")
    queue = rng.integers(0, mk.num_pieces + 1, (n, ct.queue_size)).astype(np.int32)
    queue[0] = mk.num_pieces
    want = np.asarray(jwords.legal_words(env_j, jnp.asarray(words), jnp.asarray(queue)))
    np.testing.assert_array_equal(emulate_words(kernel, ct, words, queue, mk), want)
    tw, tq = torch.as_tensor(words.astype(np.int64)), torch.as_tensor(queue)
    np.testing.assert_array_equal(mk.words(tw, tq).numpy(), want)
    assert want[0].sum() == 0 and 0 < (want != 0).mean() < 1


@pytest.mark.parametrize("height", range(1, 33))
def test_words_entry_picks_its_kernel_by_rows(height):
    """The words entry of a board of at most 32 rows takes the tall words
    kernel from 16 rows and where the bit-row warp leaves 5 or more of its
    32 lanes without a row (9 and 11-13 rows), else the bit-row kernel
    (``words_kernel_kind``; its name, launch shape and counter follow); the
    mask keeps its bit-row kernel."""
    from blockpuzzle_tpu_torch.config import EnvConfig
    from blockpuzzle_tpu_torch.kernels.packed import (
        WORDS_TALL_FROM, WORDS_TALL_IDLE, words_kernel_kind,
    )

    assert (WORDS_TALL_FROM, WORDS_TALL_IDLE) == (16, 5)
    tall = height in (9, 11, 12, 13) or height >= 16
    for width, slots in ((9, 1), (12, 3), (32, 2)):
        cfg = EnvConfig(height=height, width=width, queue_size=slots,
                        piece_set="mini5" if height < 5 else "classic19")
        mk = PackedMaskKernel(cfg, "cpu")
        kind = "tall" if tall else "rows"
        assert (mk.kind, mk.words_kind, words_kernel_kind(cfg)) == ("rows", kind, kind)
        assert mk.words_name == "packed_legal_words" + ("_tall" if tall else "")
        assert mk.words_shape == ((tall_words_envs(cfg),) if tall else mk.shape)
    for preset, kind in (("default", "rows"), ("tenten", "rows"), ("woodoku", "tall"),
                         ("big", "tall")):
        assert PackedMaskKernel(PRESETS[preset](), "cpu").words_kind == kind
    # no packed words beyond 32 columns: the packed mask's kind, no tables read
    assert words_kernel_kind(EnvConfig(height=height, width=40)) == (
        "rows" if height <= 32 else "tall")


@pytest.mark.parametrize("preset", ALL_PRESETS + ["24x9"])
def test_words_kernel_emulation_on_crafted_boards(preset):
    """Both words kernels' emulations on boards where the answer is known:
    every hand empty (every word 0), full boards (no legal action: every
    word 0), and empty boards holding the 1x1 piece (every anchor legal:
    every word 2^W - 1), each against JAX's ``legal_words``, the plain
    version and the packed bool mask packed to words."""
    jax, jnp, jwords = jax_modules()
    from test_torch_packed import _pair

    from blockpuzzle_tpu.env import make_env as jax_make_env

    cj, ct = _pair(preset)
    env_j = jax_make_env(cj, state_impl="packed")
    mk = PackedMaskKernel(ct, "cpu")
    n, s, full = 13, ct.queue_size, (1 << ct.width) - 1
    empty = np.zeros((n, ct.height), np.uint32)
    cases = {"empty hands": (empty, np.full((n, s), mk.num_pieces, np.int32), 0),
             "full boards": (np.full((n, ct.height), full, np.uint32),
                             np.zeros((n, s), np.int32), 0),
             "every anchor": (empty, np.zeros((n, s), np.int32), full)}
    for what, (words, queue, value) in cases.items():
        want = np.asarray(jwords.legal_words(env_j, jnp.asarray(words), jnp.asarray(queue)))
        assert (want == value).all(), what
        tw, tq = torch.as_tensor(words.astype(np.int64)), torch.as_tensor(queue)
        for got in (emulate_words("bit-row", ct, words, queue, mk),
                    emulate_words("tall", ct, words, queue, mk),
                    mk.words(tw, tq).numpy(),
                    pack_bool_mask(mk(tw, tq), ct.height, ct.width, s).numpy()):
            np.testing.assert_array_equal(got, want, what)


def test_legal_words_refuses_a_u8_engine():
    env = make_env(PRESETS["default"](), device="cpu", state_impl="u8")
    state, _ = env.init(0, 2)
    with pytest.raises(ValueError, match="packed"):
        legal_words(env, state.board, state.queue)


def test_words_entry_validates_inputs():
    cfg = PRESETS["tenten"]()
    mk = PackedMaskKernel(cfg, "cpu")
    words = torch.zeros(4, cfg.height, dtype=torch.int64)
    queue = torch.zeros(4, cfg.queue_size, dtype=torch.int32)
    assert mk.words(words, queue).shape == (4, cfg.queue_size * cfg.height)
    with pytest.raises(ValueError):
        mk.words(words.to(torch.int32), queue)
    with pytest.raises(ValueError):
        mk.words(words, queue[:, :1])
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no packed mask kernel"):
        PackedMaskKernel(cfg, meta).words(words.to(meta), queue.to(meta))
    assert mk.words_launches == 0


# ---------------------------------------------------------------- sampler ----


def test_popcount32_counts_every_bit():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, (64, 3), dtype=np.uint64).astype(np.int64)
    x[0] = [0, 2**32 - 1, 1 << 31]
    want = np.vectorize(lambda v: int(v).bit_count())(x)
    np.testing.assert_array_equal(popcount32(torch.as_tensor(x)).numpy(), want)


def test_rank_select_bit_exact():
    _, jnp, jwords = jax_modules()
    rng = np.random.default_rng(0)
    words, ranks, expect = [], [], []
    for _ in range(128):
        word = np.uint32(rng.integers(1, 2**32, dtype=np.uint64))
        setbits = np.flatnonzero([(word >> i) & 1 for i in range(32)])
        j = int(rng.integers(0, len(setbits)))
        words.append(word)
        ranks.append(j)
        expect.append(setbits[j])
    got = rank_select_bit(torch.as_tensor(np.array(words, np.int64)),
                          torch.as_tensor(np.array(ranks, np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)
    want = jwords.rank_select_bit(jnp.asarray(words), jnp.asarray(ranks, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("preset", ["default", "tenten"])
def test_sample_uniform_legal_matches_jax(preset):
    """Fed ``jax.random.uniform(key, (n,))``, the port picks JAX's action
    for every env, over 32 keys, on mid-game legal words at a ragged N with
    some all-zero and some single-bit rows."""
    jax, jnp, jwords = jax_modules()
    env, state, _ = midgame(preset, 37, 12)
    words = legal_words(env, state.board, state.queue)
    words[3] = 0
    words[4] = 0
    words[4, -1] = 1 << (env.cfg.width - 1)
    wj = jnp.asarray(words.numpy().astype(np.uint32))
    w = env.cfg.width
    sample_j = jax.jit(jwords.sample_uniform_legal, static_argnums=2)
    for k in range(32):
        key = jax.random.key(100 + k)
        u = torch.tensor(np.asarray(jax.random.uniform(key, (37,))))
        got = sample_uniform_legal(words, u, w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(sample_j(wj, key, w)),
                                      f"key {k}")
        assert got[3] == 0 and got[4] == env.num_actions - 1


def test_sample_uniform_legal_empty_mask_returns_zero():
    """All-zero words (a frozen terminal state) give action 0, not the
    out-of-range id of the unguarded arithmetic, and never index past the
    last word; in a mixed batch the non-empty env stays legal."""
    words = torch.zeros((4, 10), dtype=torch.int64)
    u = torch.tensor([0.0, 0.5, 0.999, 1 - 2.0 ** -23], dtype=torch.float32)
    np.testing.assert_array_equal(sample_uniform_legal(words, u, 10).numpy(), 0)
    words[1] = 0b100100            # every word of env 1 holds bits {2, 5}
    a = sample_uniform_legal(words, u, 10).numpy()
    assert a[0] == 0 and a[2] == 0 and a[3] == 0
    assert a[1] % 10 in (2, 5)


def test_uniform_from_bits_is_jax_uniform():
    """``float32(bits >> 9) * 2**-23`` on JAX's own u32 bits is
    ``jax.random.uniform`` bit for bit (five keys, 1000 draws each): the
    port's uniform is JAX's wherever the bits are."""
    jax, jnp, _ = jax_modules()
    for k in range(5):
        key = jax.random.key(k)
        bits = np.asarray(jax.random.bits(key, (1000,), jnp.uint32))
        want = np.asarray(jax.random.uniform(key, (1000,)))
        np.testing.assert_array_equal(
            (bits >> 9).astype(np.float32) * np.float32(2.0 ** -23), want)
        got = uniform_from_bits(torch.as_tensor(bits.astype(np.int64)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_words_sampler_uniform_legal():
    """``WordsSampler`` draws only legal actions, each env's uniformly:
    every legal action of env 0 drawn over 400 draws, each count within
    4.5 sigma of the mean."""
    env, state, ts = midgame("default", 16, 4)
    mask = ts.action_mask.numpy()
    sampler = WordsSampler(1000, 16, "cpu")
    draws = 400
    hits = np.zeros_like(mask, dtype=np.int64)
    for _ in range(draws):
        a = sampler(env, state.board, state.queue).numpy()
        assert mask[np.arange(16), a].all(), "illegal sample"
        hits[np.arange(16), a] += 1
    assert sampler.counter == draws
    legal0 = np.flatnonzero(mask[0])
    exp = draws / len(legal0)
    sigma = (draws * (1 / len(legal0)) * (1 - 1 / len(legal0))) ** 0.5
    assert (hits[0, legal0] > 0).all()
    assert np.abs(hits[0, legal0] - exp).max() < 4.5 * sigma + 1


def test_words_sampler_is_a_function_of_seed_and_counter():
    env, state, _ = midgame("tenten", 8, 3)
    a, b = WordsSampler(5, 8, "cpu"), WordsSampler(5, 8, "cpu")
    first = [a(env, state.board, state.queue) for _ in range(3)]
    assert all(torch.equal(x, b(env, state.board, state.queue)) for x in first)
    assert not all(torch.equal(first[0], x) for x in first[1:])


def test_words_rollout_is_legal_and_deterministic():
    env = make_env(PRESETS["default"](), device="cpu")
    runs = [rollout(env, 32, 40, 1, seed=3, sampler="words") for _ in range(2)]
    assert runs[0]["reward"] == runs[1]["reward"] and runs[0]["episodes"] > 0
    assert torch.equal(runs[0]["state"].board, runs[1]["state"].board)
    # legal actions only: the cell reward of a legal placement, never the
    # illegal penalty; the mean return is that of uniform-legal play
    assert 60 < runs[0]["episode_return"] / runs[0]["episodes"] < 100
    with pytest.raises(ValueError, match="sampler"):
        rollout(env, 4, 1, 1, seed=0, sampler="gumbel")


# ------------------------------------------------------------------- card ----


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_words_kernel_on_the_card(cuda_device, preset):
    """The words kernel the wrapper picks (the tall one on big) against its
    plain version and against the mask kernel's bools packed to words, at a
    ragged N, on mid-game boards."""
    cfg = PRESETS[preset]()
    env = make_env(cfg, device=cuda_device)
    n = 4099
    state, ts = env.init(0, n)
    sampler = UniformLegalSampler(1, n, env.device)
    for _ in range(15):
        state, ts = env.step(state, sampler(ts.action_mask))
    mk = env.packed_mask_kernel
    counter = "words_launches" if mk.words_kind == "rows" else f"words_{mk.words_kind}_launches"
    before = getattr(mk, counter)
    got = legal_words(env, state.board, state.queue)
    torch.cuda.synchronize()
    assert getattr(mk, counter) == before + 1
    assert torch.equal(got, mk.plain_words(state.board, state.queue))
    assert torch.equal(got, pack_bool_mask(mk(state.board, state.queue), cfg.height,
                                           cfg.width, cfg.queue_size))
    cpu = make_env(cfg, device="cpu")
    words_cpu = legal_words(cpu, state.board.cpu(), state.queue.cpu())
    assert torch.equal(got.cpu(), words_cpu)
    u = uniform_from_bits(torch.arange(n, device=env.device) * 1048573 % (1 << 32))
    assert torch.equal(sample_uniform_legal(got, u, cfg.width).cpu(),
                       sample_uniform_legal(words_cpu, u.cpu(), cfg.width))
