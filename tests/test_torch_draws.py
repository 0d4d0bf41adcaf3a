"""The draw kernels of the port (``blockpuzzle_tpu_torch/kernels/draws.py``,
``csrc/draws.cu`` on ``csrc/hash32.cuh``): the deal (B9), the argmax
uniform-legal draw (B2) and the words rank-select (B2w).

The CUDA kernels cannot run here, so numpy ``uint32`` emulations of their
arithmetic as the sources write it (wrapping 32-bit multiplies, ``__umulhi``,
the lanes hashed from the stream's seed, B2's rows read a 32-bit word at a
time, straight or staged in shared memory with their edge words masked,
B2w's segment of lanes an env: its spans, the scan of their popcounts, the
float32 product and the one lane's rank-select) are held bit-equal to the wrappers'
plain versions on every preset, at N in {1, 33, 1000}, at counters 0, 1,
2**31 - 1, 2**31 and 2**32 - 1 (ints and int32 tensors, wrapped negative
where they pass 2**31 - 1), with keys from seeds at and above 2**32, tags
0, 1 and 2 and widths 1, 2S and A; B2 also on masks that start off a
16-byte boundary, on forced ties (across its words, its lanes' spans and
its rows' shared edge words) and empty rows, B2w on empty masks and on
crafted rows of up to 1030 words at every segment width.  Against
JAX: B2's select, given injected bits, equals the root ``bench.py``'s
``jnp.argmax(jnp.where(mask, bits | 1, 0))``; B2w, given the uniform
``jax.random.uniform`` draws, equals
``blockpuzzle_tpu.env.words.sample_uniform_legal``.  Everything compared is
an integer and must be bit-equal.

JAX is imported inside the tests that use it, so the ``gpu`` tests run on
a machine without it: ``python -m pytest --noconftest -m gpu
tests/test_torch_draws.py``.
"""

import inspect

import numpy as np
import pytest
import torch

from blockpuzzle_tpu_torch import PRESETS, make_env, rules
from blockpuzzle_tpu_torch.env import rng
from blockpuzzle_tpu_torch.kernels import (
    DealKernel,
    UniformLegalKernel,
    WordsSelectKernel,
    _build,
)
from blockpuzzle_tpu_torch.kernels.draws import (
    MAX_SPAN,
    select_lanes,
    select_shape,
    uniform_from_bits,
    uniform_legal,
)
from blockpuzzle_tpu_torch.sampler import UniformLegalSampler, WordsSampler, policy_kernels

ALL_PRESETS = ["default", "tenten", "woodoku", "big"]
SIZES = [1, 33, 1000]
COUNTERS = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
SEEDS = [2**32, 2**32 + 12345, 2**63 + 5]
U32 = np.uint32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU has only the plain versions)")
    return torch.device("cuda")


# ------------------------------------------------- the kernels, in numpy ----


def mix32(x: np.ndarray) -> np.ndarray:
    """``hash32.cuh`` ``mix32`` on uint32 arrays (multiplies wrap)."""
    x = np.array(x, dtype=np.uint32, ndmin=1)
    x ^= x >> U32(16)
    x *= U32(0x21F0AAAD)
    x ^= x >> U32(15)
    x *= U32(0xD35A2D97)
    return x ^ (x >> U32(15))


def stream_hash(key: np.ndarray, counter: np.ndarray) -> np.ndarray:
    """``stream_hash``: the int64 key's low word, its high word and the
    counter, each XORed in before a mix."""
    k = np.asarray(key, dtype=np.int64).view(np.uint64)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    h = mix32(lo ^ U32(0x243F6A88))
    h = mix32(h ^ hi)
    return mix32(h ^ counter)


def lane_bits(h: np.ndarray, tag: int, lane: np.ndarray) -> np.ndarray:
    return mix32(h ^ ((U32(tag) << U32(16)) | lane.astype(np.uint32)))


def mix32_tail(x: np.ndarray) -> np.ndarray:
    """``mix32_tail``: ``mix32`` after its first xorshift."""
    x = np.array(x, dtype=np.uint32, ndmin=1)
    x *= U32(0x21F0AAAD)
    x ^= x >> U32(15)
    x *= U32(0xD35A2D97)
    return x ^ (x >> U32(15))


def lane_seed(h: np.ndarray, tag: int) -> np.ndarray:
    """``lane_seed``: the first xorshift of ``h ^ (tag << 16)``, which every
    lane < 2**16 shares."""
    x = np.asarray(h, dtype=np.uint32) ^ (U32(tag) << U32(16))
    return x ^ (x >> U32(16))


def seeded_bits(seed: np.ndarray, lane: np.ndarray) -> np.ndarray:
    """``seeded_bits``: the kernels' form of ``lane_bits``."""
    return mix32_tail(seed ^ np.asarray(lane).astype(np.uint32))


def counters_u32(counter, n: int) -> np.ndarray:
    """The kernels' ``uint32_t`` counter of each env: an int32 tensor's
    bits, or one Python int mod 2**32."""
    if isinstance(counter, torch.Tensor):
        return counter.numpy().view(np.uint32)
    return np.full(n, counter % 2**32, dtype=np.uint32)


def emulate_deal(key, counter, tag: int, width: int, num_pieces: int) -> np.ndarray:
    """``deal_kernel``: thread e folds env e's key and counter once, takes
    the stream's seed, and stores ``__umulhi(bits, P)`` of its lanes 0 ..
    width - 1 at out[e, :] (through shared memory at widths 3 to 16: the
    same places)."""
    n = key.shape[0]
    seed = lane_seed(stream_hash(key.numpy(), counters_u32(counter, n)), tag)
    bits = seeded_bits(seed[:, None], np.arange(width)[None, :])
    hi = (bits.astype(np.uint64) * np.uint64(num_pieces)) >> np.uint64(32)
    return hi.astype(np.int32).reshape(n, width)


# draws.cu: envs a block of the argmax draw at most, static shared memory
ARGMAX_ENVS, STATIC_SMEM = 64, 48 * 1024


def argmax_envs(actions: int) -> int:
    """``argmax_envs``: 64, halved while the block's rows and 32 bytes of
    slack pass 48 KB."""
    envs = ARGMAX_ENVS
    while envs > 1 and envs * actions + 32 > STATIC_SMEM:
        envs //= 2
    return envs


def argmax_lanes(actions: int) -> int:
    """``argmax_lanes``: the threads an env of the argmax draw, one at A <=
    128, else two where rows are staged by their width, else four."""
    return 1 if actions <= 128 else 2 if actions % 4 else 4


def emulate_row_argmax(mask: np.ndarray, bits: np.ndarray, offset: int = 0,
                       lanes=None) -> np.ndarray:
    """``uniform_legal_kernel``'s select on (N, A) bools and u32 draws, the
    mask ``offset`` bytes past a 16-byte boundary, ``lanes`` threads an env
    (``argmax_lanes`` unless given).  Word rows (A % 4 == 0, offset % 4 ==
    0) are read straight from device memory, whole words of the row each;
    other rows are staged: blocks of ``argmax_envs(A)`` envs stage their
    rows' bytes at byte d = (offset + env0 * A) % 16 of a buffer of junk
    (shared memory is not cleared); env t of a block has its row at byte d
    + t * A, in words w0 .. w0 + nw - 1 of the buffer, and the bytes of its
    first and last words outside the row are masked.  Lane q of an env
    takes words s0 = q * nw // lanes .. s1 - 1 of its row.  Each word's
    largest value of ``legal ? bits | 1 : 0`` goes into a strict maximum,
    which keeps the first word holding it; the lane's action is that
    word's first byte with that value (0 where the lane has no legal
    action).  The lanes' (value, action) pairs then meet in xor rounds,
    larger value first, then lower action."""
    n, a = mask.shape
    word_rows = a % 4 == 0 and offset % 4 == 0
    lanes = argmax_lanes(a) if lanes is None else lanes
    per = argmax_envs(a)
    junk = np.random.default_rng(a + offset)
    e = np.arange(n)
    t = e % per
    d = (offset + (e - t) * a) % 16
    start = d + t * a
    end = start + a
    w0, nw = start >> 2, ((end + 3) >> 2) - (start >> 2)
    # each block's staged span, in a region of its own
    region = -(-(per * a + 48) // 16) * 16
    buf = junk.integers(0, 256, (-(-n // per)) * region, dtype=np.uint8)
    for b, env0 in enumerate(range(0, n, per)):
        rows = mask[env0:env0 + per].astype(np.uint8).reshape(-1)
        buf[b * region + d[env0]:b * region + d[env0] + rows.size] = rows
    words = buf.view("<u4")
    base = (e // per) * (region // 4) + w0
    v = np.where(mask, bits.astype(np.uint32) | U32(1), U32(0)).astype(np.uint32)
    head = (np.uint64(0xFFFFFFFF) << (8 * (start & 3)).astype(np.uint64)).astype(np.uint32)
    tail = np.where(end & 3, (1 << (8 * (end & 3))) - 1, 0xFFFFFFFF).astype(np.uint32)

    def word_values(k, live=True):
        """Row word k's four values (bytes outside the row cleared)."""
        w = words[base + k]
        if not word_rows:
            w = np.where(k == 0, w & head, w)
            w = np.where(k == nw - 1, w & tail, w)
        act = 4 * k[:, None] + np.arange(4) - (start & 3)[:, None]
        legal = np.asarray(live)[..., None] & (
            ((w[:, None] >> (U32(8) * np.arange(4, dtype=np.uint32))) & U32(0xFF)) != 0)
        return np.where(legal, v[e[:, None], np.clip(act, 0, a - 1)], U32(0))

    best = np.zeros((n, lanes), np.uint32)
    idx = np.zeros((n, lanes), np.int64)
    for q in range(lanes):
        s0, s1 = q * nw // lanes, (q + 1) * nw // lanes
        size = s1 - s0
        word = np.zeros(n, np.int64)
        for step in range(int(size.max(initial=0))):
            live = step < size
            k = np.where(live, s0 + step, s0)
            m = word_values(k, live).max(axis=1)   # the word's largest value
            take = m > best[:, q]
            best[:, q] = np.where(take, m, best[:, q])
            word = np.where(take, k, word)
        # the first action of that word holding the maximum; 0 where none
        first = (word_values(word) == best[:, q:q + 1]).argmax(axis=1)
        idx[:, q] = np.where(best[:, q] > 0, 4 * word + first - (start & 3), 0)
    off = lanes // 2
    while off:
        ov, oi = best[:, np.arange(lanes) ^ off], idx[:, np.arange(lanes) ^ off]
        take = (ov > best) | ((ov == best) & (oi < idx))
        best, idx = np.where(take, ov, best), np.where(take, oi, idx)
        off //= 2
    return idx[:, 0]


def emulate_uniform_legal(key, counter: int, mask: torch.Tensor, offset: int = 0) -> np.ndarray:
    n, a = mask.shape
    seed = lane_seed(stream_hash(key.numpy(), counters_u32(counter, n)), rng.TAG_POLICY)
    bits = seeded_bits(seed[:, None], np.arange(a)[None, :])
    return emulate_row_argmax(mask.numpy(), bits, offset)


def emulate_select(words: np.ndarray, u: np.ndarray, width: int, lanes=None,
                   aligned: bool = True) -> np.ndarray:
    """``words_select_kernel``'s segment of L threads an env (``lanes``,
    ``select_lanes`` unless given), every env at once, given its float32
    uniform: lane q holds the words [q * span, (q + 1) * span) of the row,
    K at a time, read as pairs where 16-byte loads serve (``aligned``: the
    row on a 16-byte boundary when S*H is even); each lane's popcount, the
    inclusive scan of ``__shfl_up_sync`` rounds (a lane below the offset
    keeps its own), the total in the last lane, r = min(trunc(u *
    float(total)), total - 1) broadcast from there (-1 where the total is 0:
    lane 0 stores action 0), and the one lane whose span holds rank r finds
    its word among its K registers (where the span passes ``MAX_SPAN``,
    after reading its span again K words at a time up to them) and runs the
    5-step rank-select."""
    n, nw = words.shape
    lanes = select_lanes(nw, aligned) if lanes is None else lanes
    vec, span, k_regs = select_shape(nw, lanes, aligned)
    w32 = (words.astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    popc = np.bitwise_count(w32).astype(np.int64)                  # (N, S*H)
    q = np.arange(lanes)
    begin = np.minimum(q * span, nw)
    end = np.minimum(begin + span, nw)
    if vec:                                   # every pair read whole
        assert (begin % 2 == 0).all() and (end % 2 == 0).all()
    count = np.stack([popc[:, b:e].sum(axis=1) for b, e in zip(begin, end)], axis=1)
    incl = count.copy()                                           # (N, L)
    d = 1
    while d < lanes:
        up = np.concatenate([incl[:, :d], incl[:, :-d]], axis=1)  # lane q - d's; own below d
        incl = np.where(q >= d, incl + up, incl)
        d *= 2
    total = incl[:, -1]
    prod = (u.astype(np.float32) * total.astype(np.float32)).astype(np.float32)
    r = np.where(total > 0, np.minimum(prod.astype(np.int64), total - 1), -1)
    out = np.full(n, -1, np.int64)                                # -1: never written
    out[r < 0] = 0                                                # lane 0's store
    for e in np.flatnonzero(r >= 0):
        rem_all = r[e] - (incl[e] - count[e])
        holders = np.flatnonzero((rem_all >= 0) & (rem_all < count[e]))
        assert len(holders) == 1                                  # one store an env
        h = holders[0]
        rem, c0 = int(rem_all[h]), int(begin[h])
        if span > k_regs:                                         # its span read again
            while True:
                c = int(popc[e, c0:min(c0 + k_regs, end[h])].sum())
                if rem < c:
                    break
                rem, c0 = rem - c, c0 + k_regs
        regs = [int(w32[e, c0 + j]) if c0 + j < end[h] else 0 for j in range(k_regs)]
        acc, pick, prev = 0, None, 0
        for j, x in enumerate(regs):
            c = x.bit_count()
            if acc <= rem < acc + c:
                pick, prev = j, acc
            acc += c
        word, rem, pos = regs[pick], rem - prev, 0
        for half in (16, 8, 4, 2, 1):
            c = (word & (((1 << half) - 1) << pos)).bit_count()
            if rem >= c:
                rem, pos = rem - c, pos + half
        out[e] = (c0 + pick) * width + pos
    assert (out >= 0).all()
    return out


def emulate_words_select(key, counter: int, words: torch.Tensor, width: int, lanes=None,
                         aligned: bool = True) -> np.ndarray:
    n = key.shape[0]
    bits = lane_bits(stream_hash(key.numpy(), counters_u32(counter, n)), rng.TAG_POLICY,
                     np.zeros(n, np.int64))
    u = (bits >> U32(9)).astype(np.float32) * np.float32(2.0 ** -23)
    return emulate_select(words.numpy(), u, width, lanes, aligned)


# ------------------------------------------------------------ inputs ----


def keys(n: int, seed: int) -> torch.Tensor:
    return rng.stream_keys(seed, n, "cpu")


def counter_forms(n: int):
    """Each of ``COUNTERS`` as an int and as an (N,) int32 tensor (its
    uint32 bits: 2**31 and up wrap negative), and a tensor of mixed
    counters."""
    for c in COUNTERS:
        yield c
        yield torch.full((n,), c, dtype=torch.int64).to(torch.int32)
    mixed = np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint64)
    yield torch.as_tensor(mixed.astype(np.uint32).view(np.int32))


def legal_masks(n: int, a: int, seed: int) -> torch.Tensor:
    """(N, A) masks of mixed density, every 7th row empty."""
    g = np.random.default_rng(seed)
    mask = g.random((n, a)) < g.random((n, 1))
    mask[::7] = False
    return torch.as_tensor(mask)


def legal_row_words(cfg, n: int, seed: int) -> torch.Tensor:
    """(N, S*H) int64 row words of W bits each, of mixed density, every
    5th row empty."""
    g = np.random.default_rng(seed)
    sh = cfg.queue_size * cfg.height
    words = g.integers(0, 1 << cfg.width, (n, sh))
    words &= -(g.random((n, sh)) < g.random((n, 1))).astype(np.int64)
    words[::5] = 0
    return torch.as_tensor(words, dtype=torch.int64)


def test_counter_forms_wrap_negative():
    forms = list(counter_forms(3))
    wrapped = forms[COUNTERS.index(2**31) * 2 + 1]
    assert wrapped.dtype == torch.int32 and int(wrapped[0]) == -(2**31)
    assert int(forms[COUNTERS.index(2**32 - 1) * 2 + 1][0]) == -1


# ------------------------------------------- emulations == plain versions ----


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_deal_emulation_matches_plain(preset, n):
    cfg = PRESETS[preset]()
    num_pieces = rules.tables_for(cfg).num_pieces
    kernel = DealKernel(num_pieces, "cpu")
    s, a = cfg.queue_size, cfg.num_actions()
    for seed in SEEDS:
        key = keys(n, seed)
        assert bool(((key >> 32) != 0).all())  # the high word takes part
        for counter in counter_forms(n):
            for tag in (rng.TAG_STEP, rng.TAG_RESET, rng.TAG_POLICY):
                for width in (1, 2 * s) + ((a,) if tag == rng.TAG_POLICY else ()):
                    got = kernel(key, counter, tag, width)
                    assert got.dtype == torch.int32 and got.shape == (n, width)
                    assert got.is_contiguous()
                    want = emulate_deal(key, counter, tag, width, num_pieces)
                    np.testing.assert_array_equal(got.numpy(), want, (seed, tag, width))
    assert kernel.launches == 0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_uniform_legal_emulation_matches_plain(preset, n):
    cfg = PRESETS[preset]()
    kernel = UniformLegalKernel("cpu")
    mask = legal_masks(n, cfg.num_actions(), n)
    for seed in SEEDS:
        key = keys(n, seed)
        for counter in COUNTERS:
            got = kernel(key, counter, mask)
            np.testing.assert_array_equal(got.numpy(),
                                          emulate_uniform_legal(key, counter, mask))
            assert bool(mask[torch.arange(n), got][mask.any(dim=1)].all())
            assert not bool(got[~mask.any(dim=1)].any())
    assert kernel.launches == 0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_words_select_emulation_matches_plain(preset, n):
    cfg = PRESETS[preset]()
    kernel = WordsSelectKernel("cpu")
    words = legal_row_words(cfg, n, n)
    for seed in SEEDS:
        key = keys(n, seed)
        for counter in COUNTERS:
            got = kernel(key, counter, words, cfg.width)
            np.testing.assert_array_equal(
                got.numpy(), emulate_words_select(key, counter, words, cfg.width))
    assert kernel.launches == 0


@pytest.mark.parametrize("actions", [1, 31, 100, 243, 300, 768])
def test_row_argmax_breaks_ties_to_the_lowest_index(actions):
    """Draws from {0, ..., 3} (so ``bits | 1`` is 1 or 3: ties in every
    row, within and across words and lanes), all-equal draws, and empty
    rows, on masks at offsets 0, 1 and 6 from a 16-byte boundary (and at 2
    and 4 threads an env): the emulated row select equals the plain
    ``uniform_legal``."""
    g = np.random.default_rng(actions)
    n = 500
    mask = g.random((n, actions)) < g.random((n, 1))
    mask[::9] = False
    for offset, lanes in ((0, None), (1, None), (6, None), (0, 2), (1, 4)):
        for bits in (g.integers(0, 4, (n, actions)), np.full((n, actions), 7),
                     g.integers(0, 2**32, (n, actions))):
            want = uniform_legal(torch.as_tensor(mask),
                                 torch.as_tensor(bits, dtype=torch.int64))
            np.testing.assert_array_equal(
                emulate_row_argmax(mask, bits, offset, lanes=lanes), want.numpy())
        same = np.full((n, actions), 7)
        first = np.where(mask.any(axis=1), mask.argmax(axis=1), 0)
        np.testing.assert_array_equal(emulate_row_argmax(mask, same, offset, lanes=lanes),
                                      first)


@pytest.mark.parametrize("actions", [8, 64, 100, 243, 768, 1536])
@pytest.mark.parametrize("offset", [0, 1, 3, 4])
def test_row_argmax_ties_across_its_spans(actions, offset):
    """Two legal actions share the row's largest draw, one on each side of
    a boundary of the kernel's spans: the words of two lanes of one env, a
    word edge inside a lane's words, and the row's first and last word
    (shared with its neighbours where rows do not start on a word).  The
    lower action wins, as in the plain ``uniform_legal``, at 1, 2 and 4
    threads an env."""
    n = 128                       # every lane of a warp, at least twice
    g = np.random.default_rng(actions * 16 + offset)
    nw = -(-actions // 4)
    for lanes in (1, 2, 4):
        pairs = []
        for e in range(n):
            q = e % lanes
            cut = 4 * (1 + e % max(nw - 1, 1))      # a word edge inside the row
            split = 4 * ((q + 1) * nw // lanes)     # lane q's last word, then lane q + 1's
            lo, hi = min(cut - 1, actions - 1), min(cut, actions - 1)
            edge = (min(max(split - 1, 0), actions - 1), min(split, actions - 1))
            pairs.append([(0, actions - 1), (lo, hi), (0, hi), (lo, actions - 1), edge,
                          (min(3, actions - 1), min(4, actions - 1))][e % 6])
        bits = g.integers(0, 2**31, (n, actions))
        mask = g.random((n, actions)) < 0.5
        for e, (i, j) in enumerate(pairs):
            bits[e, [i, j]] = 2**32 - 1
            mask[e, [i, j]] = True
        want = uniform_legal(torch.as_tensor(mask), torch.as_tensor(bits, dtype=torch.int64))
        assert [int(x) for x in want] == [i for i, _ in pairs]
        np.testing.assert_array_equal(emulate_row_argmax(mask, bits, offset, lanes=lanes),
                                      want.numpy())


def test_seeded_bits_are_lane_bits():
    """``hash32.cuh``'s seeded form, the stream's first xorshift done once,
    gives ``lane_bits`` for every lane below 2**16."""
    g = np.random.default_rng(9)
    h = np.concatenate([g.integers(0, 2**32, 200), [0, 2**32 - 1, 0xFFFF0000, 0xFFFF]])
    h = h.astype(np.uint32)[:, None]
    lanes = np.concatenate([np.arange(64), g.integers(0, 2**16, 64), [2**16 - 1]])[None, :]
    for tag in (rng.TAG_STEP, rng.TAG_RESET, rng.TAG_POLICY, 2**16 - 1):
        np.testing.assert_array_equal(seeded_bits(lane_seed(h, tag), lanes),
                                      lane_bits(h, tag, lanes))


@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_uniform_legal_emulation_off_alignment(preset):
    """The emulated kernel on masks that start 1, 2, 4 and 13 bytes past a
    16-byte boundary (a view such as ``big[1:]`` of a larger mask) equals
    the plain version: rows then share words with their neighbours, or sit
    at another offset in the staged span."""
    cfg = PRESETS[preset]()
    kernel = UniformLegalKernel("cpu")
    n = 131
    mask = legal_masks(n, cfg.num_actions(), 3)
    key = keys(n, 2**32 + 7)
    for offset in (1, 2, 4, 13):
        for counter in (0, 2**32 - 1):
            np.testing.assert_array_equal(
                emulate_uniform_legal(key, counter, mask, offset),
                kernel(key, counter, mask).numpy())


def test_uniform_legal_empty_rows_give_action_zero():
    key = keys(40, 2**32)
    mask = torch.zeros((40, 100), dtype=torch.bool)
    assert not UniformLegalKernel("cpu")(key, 3, mask).any()
    assert not emulate_uniform_legal(key, 3, mask).any()


# rows of S*H words beyond the presets' (33x9; 36x9 with a hand of three;
# 130x8; 512x8; and 1030 words, whose spans pass the registers at a warp
# an env) with each board's width
LONG_ROWS = {33: 9, 108: 9, 130: 8, 512: 8, 1030: 8}


def crafted_row_words(n: int, nwords: int, width: int, seed: int) -> torch.Tensor:
    """(N, S*H) int64 row words of W bits: mixed density, every 5th row
    empty, every 5th from the second full (every bit of every word), every
    5th from the third one bit in its last word, every 5th from the fourth
    one bit in its first."""
    g = np.random.default_rng(seed)
    words = g.integers(0, 1 << width, (n, nwords))
    words &= -(g.random((n, nwords)) < g.random((n, 1))).astype(np.int64)
    words[::5] = 0
    words[1::5] = (1 << width) - 1
    words[2::5] = 0
    words[2::5, -1] = 1 << (width - 1)
    words[3::5] = 0
    words[3::5, 0] = 1
    return torch.as_tensor(words, dtype=torch.int64)


def test_select_lanes_and_spans():
    """The host's pick of B2w's segment and span: about 8 words a lane where
    they load as 16-byte pairs, 12 where one at a time (2 lanes on the
    default preset's 10 words, 4 on tenten's 30, woodoku's 27 and 33x9's 33,
    8 on big's 48), at most a warp; 16-byte loads only on an even S*H at an
    aligned base, every span then even; spans past 32 words walked."""
    assert [select_lanes(k) for k in (1, 2, 8, 10, 16, 27, 30, 33, 48, 108, 130, 512)] == [
        1, 1, 1, 2, 2, 4, 4, 4, 8, 16, 32, 32]
    assert [select_lanes(k, aligned=False) for k in (10, 12, 13, 48, 130)] == [
        1, 1, 2, 4, 16]
    assert select_shape(10, 2) == (True, 6, 8)
    assert select_shape(10, 2, aligned=False) == (False, 5, 8)
    assert select_shape(27, 4) == (False, 7, 8)
    assert select_shape(33, 4) == (False, 9, 16)
    assert select_shape(48, 8) == (True, 6, 8)
    assert select_shape(108, 16) == (True, 8, 8)
    assert select_shape(130, 32) == (True, 6, 8)
    assert select_shape(130, 32, aligned=False) == (False, 5, 8)
    assert select_shape(512, 32) == (True, 16, 16)
    assert select_shape(1030, 32) == (True, 34, 32)
    assert select_shape(10, 1) == (True, 10, 16)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("nwords", list(LONG_ROWS))
def test_words_select_segments_match_plain(nwords, lanes):
    """B2w's emulated segment at every width the host can pick, on rows of
    33 to 1030 words (crafted: empty rows, full rows, one bit at either
    end), read as 16-byte pairs and as single words (a row off a 16-byte
    boundary), equals the plain version at counters 0, 2**31 and 2**32 -
    1."""
    width, n = LONG_ROWS[nwords], 97
    kernel = WordsSelectKernel("cpu")
    words = crafted_row_words(n, nwords, width, nwords + lanes)
    key = keys(n, 2**32 + nwords)
    for counter in (0, 2**31, 2**32 - 1):
        want = kernel(key, counter, words, width).numpy()
        for aligned in (True, False):
            np.testing.assert_array_equal(
                emulate_words_select(key, counter, words, width, lanes, aligned), want)
    assert (want[::5] == 0).all() and (want[2::5] == nwords * width - 1).all()
    assert (want[3::5] == 0).all() and kernel.launches == 0


@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_words_select_crafted_rows_at_every_width(preset):
    """On each preset's S*H: empty rows give action 0, a full row's action
    is the rank's bit of it, a lone bit is always drawn, at every segment
    width and both load widths."""
    cfg = PRESETS[preset]()
    n, nwords = 64, cfg.queue_size * cfg.height
    words = crafted_row_words(n, nwords, cfg.width, 5)
    key = keys(n, 2**32 + 9)
    want = WordsSelectKernel("cpu")(key, 3, words, cfg.width).numpy()
    for lanes in (1, 2, 4, 8, 16, 32):
        for aligned in (True, False):
            np.testing.assert_array_equal(
                emulate_words_select(key, 3, words, cfg.width, lanes, aligned), want)


def test_words_select_empty_masks_give_action_zero():
    key = keys(40, 2**32)
    words = torch.zeros((40, 30), dtype=torch.int64)
    assert not WordsSelectKernel("cpu")(key, 3, words, 10).any()
    assert not emulate_words_select(key, 3, words, 10).any()
    # a single legal bit anywhere is always the action
    words[torch.arange(40), torch.arange(40) % 30] = 1 << 9
    want = (torch.arange(40) % 30) * 10 + 9
    assert torch.equal(WordsSelectKernel("cpu")(key, 5, words, 10), want)
    np.testing.assert_array_equal(emulate_words_select(key, 5, words, 10), want.numpy())


# -------------------------------------------------------- against JAX ----


@pytest.mark.parametrize("actions", [100, 243, 300, 768])
def test_row_argmax_matches_jax_bench_select(actions):
    """Given the same u32 bits (with forced ties), the emulated B2 select
    equals the root ``bench.py``'s ``jnp.argmax(jnp.where(mask, bits | 1,
    0), axis=1)``, at an aligned mask and one a byte past the boundary."""
    import jax.numpy as jnp

    g = np.random.default_rng(actions + 1)
    n = 300
    mask = g.random((n, actions)) < g.random((n, 1))
    mask[::11] = False
    for bits in (g.integers(0, 2**32, (n, actions)), g.integers(0, 4, (n, actions))):
        bits = bits.astype(np.uint32)
        want = jnp.argmax(jnp.where(jnp.asarray(mask), jnp.asarray(bits) | 1, 0), axis=1)
        for offset in (0, 1):
            np.testing.assert_array_equal(emulate_row_argmax(mask, bits, offset),
                                          np.asarray(want))


@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_words_select_matches_jax_sample_uniform_legal(preset):
    """Given the uniform ``jax.random.uniform(key, (n,))`` draws, the
    emulated B2w select equals JAX's ``sample_uniform_legal`` with that
    key, and so does the plain version fed the same uniform."""
    import jax
    import jax.numpy as jnp

    from blockpuzzle_tpu.env import words as jwords

    from blockpuzzle_tpu_torch.env.words import sample_uniform_legal

    cfg = PRESETS[preset]()
    n = 257
    words = legal_row_words(cfg, n, 3)
    words_j = jnp.asarray(words.numpy().astype(np.uint32))
    for k in range(4):
        key = jax.random.key(100 + k)
        u = np.asarray(jax.random.uniform(key, (n,)))
        want = np.asarray(jwords.sample_uniform_legal(words_j, key, cfg.width))
        np.testing.assert_array_equal(emulate_select(words.numpy(), u, cfg.width), want)
        np.testing.assert_array_equal(
            sample_uniform_legal(words, torch.as_tensor(u.copy()), cfg.width).numpy(), want)


@pytest.mark.parametrize("nwords", [33, 108, 130, 512])
def test_words_select_long_rows_match_jax_sample_uniform_legal(nwords):
    """On rows of 33, 108 (36x9 with a hand of three), 130 and 512 words,
    given ``jax.random.uniform`` draws, the emulated B2w segment (the
    host's width) equals JAX's ``sample_uniform_legal``."""
    import jax
    import jax.numpy as jnp

    from blockpuzzle_tpu.env import words as jwords

    width, n = LONG_ROWS[nwords], 131
    words = crafted_row_words(n, nwords, width, 7)
    words_j = jnp.asarray(words.numpy().astype(np.uint32))
    sample_j = jax.jit(jwords.sample_uniform_legal, static_argnums=2)
    for k in range(3):
        key = jax.random.key(200 + k)
        u = np.asarray(jax.random.uniform(key, (n,)))
        want = np.asarray(sample_j(words_j, key, width))
        np.testing.assert_array_equal(emulate_select(words.numpy(), u, width), want)


def test_uniform_from_bits_matches_the_kernel_uniform():
    bits = np.array([0, 1, 511, 512, 2**31, 2**32 - 1, 0xDEADBEEF], np.uint32)
    want = (bits >> U32(9)).astype(np.float32) * np.float32(2.0 ** -23)
    got = uniform_from_bits(torch.as_tensor(bits.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


# ----------------------------------------------------------- wrappers ----


WRAPPERS = {DealKernel: (20,), UniformLegalKernel: (), WordsSelectKernel: ()}


@pytest.mark.parametrize("wrapper", list(WRAPPERS), ids=lambda w: w.__name__)
def test_draw_wrappers_default_to_the_card(wrapper, monkeypatch):
    """Built without a device, a wrapper asks ``_build.resolve_device`` for
    CUDA: where there is no card it raises, and never runs the plain
    version on the CPU."""
    args = WRAPPERS[wrapper]
    assert inspect.signature(wrapper).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert wrapper(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wrapper(*args)
    asked = []
    monkeypatch.setattr(_build, "resolve_device",
                        lambda device: asked.append(device) or torch.device("cpu"))
    wrapper(*args)
    assert asked == ["cuda"]


def test_draw_wrappers_route_cpu_tensors_to_their_plain_versions(monkeypatch):
    """On the CPU each wrapper returns its plain version's result and
    launches nothing; the library is never loaded."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("library loaded"))
    n, key = 17, keys(17, 2**32)
    counter = torch.arange(n, dtype=torch.int32) - 5
    deal = DealKernel(19, "cpu")
    assert torch.equal(deal(key, counter, rng.TAG_STEP, 2),
                       rng.deal(key, counter, rng.TAG_STEP, 2, 19))
    assert torch.equal(deal(key, 0, rng.TAG_RESET, 3), rng.deal(key, 0, rng.TAG_RESET, 3, 19))
    mask = legal_masks(n, 100, 1)
    ul = UniformLegalKernel("cpu")
    assert torch.equal(ul(key, 4, mask),
                       uniform_legal(mask, rng.bits(key, 4, rng.TAG_POLICY, 100)))
    cfg = PRESETS["tenten"]()
    words = legal_row_words(cfg, n, 2)
    ws = WordsSelectKernel("cpu")
    assert torch.equal(ws(key, 4, words, cfg.width), ws.plain(key, 4, words, cfg.width))
    assert (deal.launches, ul.launches, ws.launches) == (0, 0, 0)


def test_draw_wrappers_refuse_what_the_kernels_do_not_take():
    key = keys(4, 1)
    deal, ul, ws = DealKernel(19, "cpu"), UniformLegalKernel("cpu"), WordsSelectKernel("cpu")
    with pytest.raises(ValueError, match="int32"):
        deal(key, torch.zeros(4, dtype=torch.int64), 0, 2)
    with pytest.raises(ValueError, match="int32"):
        deal(key, torch.zeros(3, dtype=torch.int32), 0, 2)
    with pytest.raises(ValueError, match="out of range"):
        deal(key, 0, 1 << 16, 2)
    with pytest.raises(ValueError, match="key"):
        deal(key.to(torch.int32), 0, 0, 2)
    with pytest.raises(ValueError, match="Python int"):
        ul(key, torch.zeros(4, dtype=torch.int32), torch.ones((4, 9), dtype=torch.bool))
    with pytest.raises(ValueError, match="bool"):
        ul(key, 0, torch.ones((4, 9), dtype=torch.uint8))
    with pytest.raises(ValueError, match="int64"):
        ws(key, 0, torch.ones((4, 9), dtype=torch.int32), 10)
    with pytest.raises(ValueError, match="width"):
        ws(key, 0, torch.ones((4, 9), dtype=torch.int64), 33)


class Recorder:
    """A kernel wrapper that records each call's arguments and result."""

    def __init__(self, kernel):
        self.kernel, self.calls = kernel, []

    def __call__(self, *args):
        out = self.kernel(*args)
        self.calls.append((args, out))
        return out


@pytest.mark.parametrize("state_impl", ["packed", "u8"])
def test_every_engine_deal_goes_through_the_deal_kernel(state_impl):
    """``init``, the step (live deals, and the parity mode's auto-reset
    deal), ``reset`` and ``partial_reset`` each deal once through the
    engine's ``deal_kernel``, with ``rng.deal``'s arguments."""
    env = make_env(PRESETS["tenten"](), device="cpu", state_impl=state_impl)
    assert isinstance(env.deal_kernel, DealKernel) and env.deal_kernel.device == env.device
    rec = env.deal_kernel = Recorder(env.deal_kernel)
    state, ts = env.init(2**32 + 3, 8)
    sampler = UniformLegalSampler(1, 8, "cpu")
    state, ts = env.step(state, sampler(ts.action_mask))
    state, ts = env.step(state, sampler(ts.action_mask),
                         deal_override=np.zeros((8, 3), np.int32))
    state, ts = env.reset(state)
    state, ts = env.partial_reset(state, torch.arange(8) % 2 == 0)
    tags = [(args[2], args[3]) for args, _ in rec.calls]
    assert tags == [(rng.TAG_RESET, 3), (rng.TAG_STEP, 6), (rng.TAG_RESET, 3),
                    (rng.TAG_RESET, 3), (rng.TAG_RESET, 3)]
    for (key, counter, tag, width), out in rec.calls:
        assert torch.equal(out, rng.deal(key, counter, tag, width, env.num_pieces))
    assert rec.calls[0][0][1] == 0  # init deals at one counter for all


def test_samplers_draw_through_their_shared_kernels():
    """Both samplers on a device share that device's draw wrappers; each
    call is one call of its kernel at the sampler's counter, which then
    advances by one (``WordsSampler.select`` as its ``__call__``)."""
    env = make_env(PRESETS["default"](), device="cpu")
    ul, ws = UniformLegalSampler(3, 16, "cpu"), WordsSampler(3, 16, "cpu")
    assert (ul.kernel, ws.kernel) == policy_kernels(torch.device("cpu"))
    assert UniformLegalSampler(4, 2, "cpu").kernel is ul.kernel
    ul.kernel, ws.kernel = Recorder(ul.kernel), Recorder(ws.kernel)
    state, ts = env.init(0, 16)
    a = ul(ts.action_mask)
    b = ws(env, state.board, state.queue)
    c = ws.select(env.packed_mask_kernel.words(state.board, state.queue), env.cfg.width)
    assert [args[1] for args, _ in ul.kernel.calls] == [0]
    assert [args[1] for args, _ in ws.kernel.calls] == [0, 1]
    assert (ul.counter, ws.counter) == (1, 2)
    assert torch.equal(a, ul.kernel.calls[0][1]) and torch.equal(b, ws.kernel.calls[0][1])
    assert torch.equal(c, ws.kernel.calls[1][1])
    for acts in (a, b, c):
        assert bool(ts.action_mask[torch.arange(16), acts].all())


# ------------------------------------------------------------------- card ----


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_draw_kernels_on_the_card(cuda_device, preset):
    """Each draw kernel against its plain version at a ragged N, one
    launch a call."""
    cfg = PRESETS[preset]()
    n, s = 4099, cfg.queue_size
    key = rng.stream_keys(2**32 + 1, n, cuda_device)
    counter = torch.arange(n, dtype=torch.int32, device=cuda_device) * 977 - 2**20
    deal = DealKernel(rules.tables_for(cfg).num_pieces, cuda_device)
    # widths 2S and S, 6 (the step's at S = 3), 16 and 17 (the widest
    # staged in shared memory and the narrowest stored directly) and A
    draws = ((counter, rng.TAG_STEP, 2 * s), (0, rng.TAG_RESET, s),
             (counter, rng.TAG_STEP, 6), (7, rng.TAG_RESET, 16), (7, rng.TAG_RESET, 17),
             (2**32 - 1, rng.TAG_POLICY, cfg.num_actions()))
    for c, tag, width in draws:
        assert torch.equal(deal(key, c, tag, width), deal.plain(key, c, tag, width))
    ul, ws = UniformLegalKernel(cuda_device), WordsSelectKernel(cuda_device)
    mask = legal_masks(n, cfg.num_actions(), 5).to(cuda_device)
    words = legal_row_words(cfg, n, 5).to(cuda_device)
    for c in COUNTERS:
        assert torch.equal(ul(key, c, mask), ul.plain(key, c, mask))
        assert torch.equal(ws(key, c, words, cfg.width), ws.plain(key, c, words, cfg.width))
    torch.cuda.synchronize()
    assert (deal.launches, ul.launches, ws.launches) == (len(draws), len(COUNTERS),
                                                          len(COUNTERS))


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_uniform_legal_on_masks_off_alignment_on_the_card(cuda_device, preset):
    """B2 on mask views that do not start on a 16-byte boundary: rows 1 ..
    N of an (N + 1, A) mask (A bytes in: off the boundary but for A = 768),
    and an (N, A) view one byte into a flat buffer, each equal to the plain
    version at N = 4099."""
    cfg = PRESETS[preset]()
    n, a = 4099, cfg.num_actions()
    key = rng.stream_keys(2**32 + 3, n, cuda_device)
    mask = legal_masks(n, a, 9).to(cuda_device)
    big = torch.zeros((n + 1, a), dtype=torch.bool, device=cuda_device)
    big[1:] = mask
    flat = torch.zeros(n * a + 1, dtype=torch.bool, device=cuda_device)
    flat[1:] = mask.view(-1)
    ul = UniformLegalKernel(cuda_device)
    assert flat[1:].data_ptr() % 16 != 0
    for view in (big[1:], flat[1:].view(n, a)):
        assert view.is_contiguous()
        for c in (0, 2**31, 2**32 - 1):
            assert torch.equal(ul(key, c, view), ul.plain(key, c, mask))
    torch.cuda.synchronize()
    assert ul.launches == 6


@pytest.mark.gpu
def test_main_path_draws_make_no_call_into_the_torch_hash(cuda_device, monkeypatch):
    """On the card the step, both samplers and ``packsel`` draw only
    through their kernels: ``rng.mix32`` is never called once the streams'
    keys exist."""
    from blockpuzzle_tpu_torch import bench

    env = make_env(PRESETS["default"](), device=cuda_device)
    state, ts = env.init(0, 64)
    policies = [bench.make_policy(env, name, 64) for name in bench.SAMPLERS]
    monkeypatch.setattr(rng, "mix32", lambda x: pytest.fail("torch hash called"))
    for policy in policies:
        state, ts = env.step(state, policy(state, ts.action_mask))
    state, ts = env.reset(state)
    env.partial_reset(state, torch.ones(64, dtype=torch.bool, device=cuda_device))
    torch.cuda.synchronize()
