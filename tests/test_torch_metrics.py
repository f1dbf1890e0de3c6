"""The port's edit-distance scoring against the JAX package's on the CPU:
equal integers on seeded random ragged ids, empty sequences included,
and equal error rates (exact float equality: the same sums in the same
order)."""

import numpy as np
import pytest

from seq2seq_attention_asr_tpu.decode import metrics as jmetrics
from seq2seq_attention_asr_tpu_torch.decode import metrics


def _ragged(rng, n, vmax, lmax):
    return [rng.randint(0, vmax, size=rng.randint(0, lmax + 1)) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edit_distance_matches_jax(seed):
    rng = np.random.RandomState(seed)
    a, b = _ragged(rng, 60, 6, 14), _ragged(rng, 60, 6, 14)
    a += [np.zeros(0, np.int64), np.array([3]), np.zeros(0, np.int64)]
    b += [np.array([1, 2]), np.zeros(0, np.int64), np.zeros(0, np.int64)]
    for x, y in zip(a, b):
        assert metrics.edit_distance_np(x, y) == jmetrics.edit_distance_np(x, y)


def _padded(rows, width):
    out = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out, np.array([len(r) for r in rows])


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_edit_distance_and_error_rate_match_jax(seed):
    rng = np.random.RandomState(seed)
    a, b = _ragged(rng, 20, 40, 30), _ragged(rng, 20, 40, 30)
    a[3], b[5] = np.zeros(0, np.int64), np.zeros(0, np.int64)
    pa, la = _padded(a, 32)
    pb, lb = _padded(b, 31)
    got = metrics.batch_edit_distance(pa, la, pb, lb)
    want = jmetrics.batch_edit_distance(pa, la, pb, lb)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert metrics.error_rate(pa, la, pb, lb) == jmetrics.error_rate(pa, la, pb, lb)
    assert metrics.error_rate(a, None, b) == jmetrics.error_rate(a, None, b)
