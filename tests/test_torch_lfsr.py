"""The port's LFSR (`repro_torch.core.lfsr`) against the JAX package's, bit
for bit, over the shapes and step counts of tests/test_lfsr.py — including
words with bit 31 set, which torch cannot shift as uint32 (the port carries
int32 bit patterns and shifts them widened to int64)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lfsr as JL  # noqa: E402
from repro.testing.hypothesis_fallback import given, settings, st  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import lfsr as TL  # noqa: E402


def _t(a):
    return convert.words_from_numpy(np.asarray(a, np.uint32), device="cpu")


def _n(t):
    return convert.words_to_numpy(t)


HIGH_BIT_WORDS = np.array([0x80000000, 0xFFFFFFFF, 0xDEADBEEF, 0x80000001,
                           0xC0FFEE00, 0x00000001, 0x7FFFFFFF], np.uint32)


@given(st.lists(st.integers(1, 2**32 - 1), min_size=1, max_size=32),
       st.integers(1, 64))
@settings(max_examples=30, deadline=None)
def test_steps_match_jax_and_numpy(seeds, n):
    s = np.array(seeds, np.uint32)
    want = np.asarray(JL.steps(jnp.asarray(s), n))
    np.testing.assert_array_equal(_n(TL.steps(_t(s), n)), want)
    np.testing.assert_array_equal(TL.np_steps(s, n), want)


@pytest.mark.parametrize("n", [1, 3, 8, 64])
def test_high_bit_words(n):
    """Words with bit 31 set (negative as int32) clock as uint32 do."""
    want = np.asarray(JL.steps(jnp.asarray(HIGH_BIT_WORDS), n))
    np.testing.assert_array_equal(_n(TL.steps(_t(HIGH_BIT_WORDS), n)), want)
    np.testing.assert_array_equal(_n(TL.step(_t(HIGH_BIT_WORDS))),
                                  np.asarray(JL.step(jnp.asarray(
                                      HIGH_BIT_WORDS))))


@pytest.mark.parametrize("steps_per_draw", [1, 3, 5])
def test_draw_matches(steps_per_draw):
    s = np.asarray(JL.seeds(7, 96)).reshape(3, 32)
    js, jr = JL.draw(jnp.asarray(s), steps_per_draw)
    ts, tr = TL.draw(_t(s), steps_per_draw)
    np.testing.assert_array_equal(_n(ts), np.asarray(js))
    np.testing.assert_array_equal(_n(tr), np.asarray(jr))


@given(st.integers(1, 2**32 - 1), st.integers(1, 31))
@settings(max_examples=30, deadline=None)
def test_truncate_keeps_msbs(seed, bits):
    s = np.array([seed], np.uint32)
    got = int(_n(TL.truncate(_t(s), bits))[0])
    assert got == int(np.asarray(JL.truncate(jnp.asarray(s), bits))[0])
    assert got == seed >> (32 - bits)


def test_truncate_zero_bits():
    assert int(TL.truncate(_t(HIGH_BIT_WORDS), 0).abs().sum()) == 0


@pytest.mark.parametrize("key,n", [(0, 1), (42, 4096), (2**32 - 1, 100),
                                   (123456789, 7)])
def test_seeds_match(key, n):
    want = np.asarray(JL.seeds(key, n))
    got = _n(TL.seeds(key, n, device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert (got != 0).all()


@given(st.lists(st.integers(1, 2**32 - 1), min_size=1, max_size=8),
       st.integers(1, 200))
@settings(max_examples=20, deadline=None)
def test_leap_equals_iterated_steps(seeds, t):
    s = np.array(seeds, np.uint32)
    want = np.asarray(JL.leap(jnp.asarray(s), t))
    np.testing.assert_array_equal(_n(TL.leap(_t(s), t)), want)
    np.testing.assert_array_equal(_n(TL.steps(_t(s), t)), want)


@pytest.mark.parametrize("t", [1, 2, 3, 5, 13, 31])
def test_leap_feedback_masks_match(t):
    assert TL.leap_feedback_masks(t) == JL.leap_feedback_masks(t)
    assert TL._leap_matrix(t) == JL._leap_matrix(t)


def test_leap_feedback_masks_range_checked():
    for bad in (0, 32, -1):
        with pytest.raises(ValueError):
            TL.leap_feedback_masks(bad)


def test_word_views_round_trip():
    """i32/u32 carry every uint32 value through int64 and back."""
    w = np.concatenate([HIGH_BIT_WORDS, np.asarray(JL.seeds(3, 64))])
    t = _t(w)
    np.testing.assert_array_equal(TL.u32(t).numpy(), w.astype(np.int64))
    np.testing.assert_array_equal(_n(TL.i32(TL.u32(t))), w)
