"""The port's participation schedule and its numpy Threefry against JAX,
bit for bit: ``repro_torch.prng`` against ``jax.random`` (jax 0.9 runs
with ``jax_threefry_partitionable=True``, whose counter layout the port
follows), and ``ParticipationSchedule``'s cohorts, masks and arrival
uniforms against the reference's.  The weighted draw takes ``log(u)/w``
in float32 on both sides (numpy's ``log`` against XLA's); the cohort is
what must agree, and it does, draw for draw."""
import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core.participation import ParticipationSchedule as JSchedule

from repro_torch import prng
from repro_torch.core.participation import ParticipationSchedule


def _uniform_bits(seed, r, n):
    want = np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.key(seed), r), (n,)))
    got = prng.uniform(prng.fold_in(prng.key(seed), r), n)
    assert got.dtype == np.float32 and got.shape == (n,)
    return got.view(np.uint32), want.view(np.uint32)


def test_partitionable_threefry_is_what_jax_runs():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1, -3])
@pytest.mark.parametrize("r", [0, 1, 2, 1000, (1 << 20) + 5])
@pytest.mark.parametrize("n", [1, 4, 5, 16, 1001])
def test_uniforms_match_jax_bit_for_bit(seed, r, n):
    got, want = _uniform_bits(seed, r, n)
    np.testing.assert_array_equal(got, want)


@settings(deadline=None, max_examples=25)
@given(seed=st.integers(-2 ** 31, 2 ** 31 - 1), r=st.integers(0, 2 ** 32 - 1),
       n=st.integers(1, 300))
def test_uniforms_match_jax_property(seed, r, n):
    got, want = _uniform_bits(seed, r, n)
    np.testing.assert_array_equal(got, want)


def test_keys_bits_and_fold_in_match_jax():
    for seed in (0, 5, -1):
        k = jax.random.key(seed)
        np.testing.assert_array_equal(prng.key(seed), np.asarray(jax.random.key_data(k)))
        for d in (0, 3, 2 ** 32 - 1):
            np.testing.assert_array_equal(
                prng.fold_in(prng.key(seed), d),
                np.asarray(jax.random.key_data(jax.random.fold_in(k, d))))
        np.testing.assert_array_equal(
            prng.random_bits(prng.key(seed), 33),
            np.asarray(jax.random.bits(k, (33,), np.uint32)))


@pytest.mark.parametrize("weights", [None, (1.0, 2.0, 0.5, 4.0, 1.5, 3.0, 0.25, 1.0)])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_cohort_and_mask_match_the_reference(seed, weights):
    n = 8 if weights else 20
    t, j = ParticipationSchedule(seed, weights), JSchedule(seed, weights)
    for r in range(6):
        for m in (1, 3, n // 2, n):
            np.testing.assert_array_equal(t.cohort(r, n, m), j.cohort(r, n, m))
        for grid in ((1, n), (2, n // 2)):
            m = n // 2
            got = t.mask(r, grid, m)
            np.testing.assert_array_equal(got, np.asarray(j.mask(r, grid, m)))
            assert got.shape == grid and got.sum() == m
            np.testing.assert_array_equal(np.flatnonzero(got), t.cohort(r, n, m))


def test_unweighted_scores_are_the_reference_bits():
    t, j = ParticipationSchedule(4), JSchedule(4)
    for r in range(5):
        np.testing.assert_array_equal(t._scores(r, 13).view(np.uint32),
                                      np.asarray(j._scores(r, 13)).view(np.uint32))


def test_arrival_uniforms_match_the_reference():
    t, j = ParticipationSchedule(9), JSchedule(9)
    for index, salt in ((0, 0), (3, 1), (17, 2)):
        np.testing.assert_array_equal(t.arrival_uniforms(index, 11, salt).view(np.uint32),
                                      np.asarray(j.arrival_uniforms(index, 11, salt))
                                      .view(np.uint32))


def test_validate_refuses_what_the_reference_refuses():
    for bad, n in (((1.0, -1.0), None), ((1.0, float("nan")), None), ((), None),
                   ((1.0, 2.0), 3)):
        with pytest.raises(ValueError):
            ParticipationSchedule(weights=bad).validate(n)
        with pytest.raises(ValueError):
            JSchedule(weights=bad).validate(n)
    with pytest.raises(ValueError, match="cohort size"):
        ParticipationSchedule().cohort(0, 4, 5)
