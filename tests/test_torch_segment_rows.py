"""Port parity: ops/segment_rows (K3's plain version and the reductions over
it) against the JAX package — the interpret-mode Pallas blocked cumsum and
jnp.cumsum. Tolerances: 1e-5 (f32 sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.ops import segment_rows as jsr
from geosplatting_tpu_torch import _kernels
from geosplatting_tpu_torch.ops import segment_rows as sr

from .torch_parity import n, one_torch_thread, t  # noqa: F401


@pytest.mark.parametrize("m,c", [(7, 3), (1000, 17), (512, 1), (2048, 10)])
def test_cumsum_plain_matches_blocked_cumsum(m, c):
    x = np.random.default_rng(m).normal(size=(m, c)).astype(np.float32)
    got = sr.cumsum_rows(t(x))  # CPU tensor: K3's plain version
    np.testing.assert_allclose(n(got), np.asarray(jsr.blocked_cumsum(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(got), np.asarray(jnp.cumsum(jnp.asarray(x), 0)),
                               rtol=1e-5, atol=1e-5)


def test_contiguous_segment_sum_matches_jax():
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(50, 4)).astype(np.float32)
    counts = np.array([3, 0, 10, 7, 30, 5], np.int32)  # last run overruns M
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    want = jsr.contiguous_segment_sum(*(jnp.asarray(a) for a in (vals, starts, counts)))
    got = sr.contiguous_segment_sum(t(vals), t(starts, torch.int64), t(counts, torch.int64))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dense_index_add_matches_jax():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 17, size=200)
    vals = rng.normal(size=(200, 3)).astype(np.float32)
    want = jsr.dense_index_add(17, jnp.asarray(idx, jnp.int32), jnp.asarray(vals))
    got = sr.dense_index_add(17, t(idx, torch.int64), t(vals))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gather_rows_backward_matches_jax():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(12, 5)).astype(np.float32)
    idx = np.array([[0, 3, 3], [11, 7, 3]])
    w = rng.normal(size=(2, 3, 5)).astype(np.float32)
    g_j = jax.grad(lambda tb: jnp.sum(jsr.gather_rows(12, tb, jnp.asarray(idx)) * w))(
        jnp.asarray(table))
    tb = t(table).requires_grad_()
    (sr.gather_rows(tb, t(idx, torch.int64)) * t(w)).sum().backward()
    np.testing.assert_allclose(n(tb.grad), np.asarray(g_j), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    before = dict(_kernels.launches)
    sr.cumsum_rows(torch.ones((5000, 10)))
    assert dict(_kernels.launches) == before
