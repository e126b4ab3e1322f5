"""The IWS evaluator's statistics, port against JAX on the same numpy
inputs: ardae_tpu_torch.core.stats (logprob_gaussian, covmat, mvn_logprob)
and core.losses (iwae_bound, reduce_batch). fp32; rtol 1e-5, atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ardae_tpu.core import losses as jl
from ardae_tpu.core import stats as js
from ardae_tpu_torch.core import losses as tl
from ardae_tpu_torch.core import stats as ts
from torch_parity import close, rand, t

RTOL, ATOL = 1e-5, 1e-6


def _spd_chol(seed, d, batch=()):
    """Lower Cholesky factors of well-conditioned covariances."""
    a = rand(seed, *batch, d, 2 * d)
    cov = a @ np.swapaxes(a, -1, -2) / (2 * d) + 0.1 * np.eye(d, dtype=np.float32)
    return np.linalg.cholesky(cov.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("form", ["arrays", "floats"])
def test_logprob_gaussian(form):
    z = rand(1, 5, 7)
    if form == "arrays":
        m, lv = rand(2, 5, 7), rand(3, 5, 7, scale=0.5)
        close(ts.logprob_gaussian(t(m), t(lv), t(z)),
              js.logprob_gaussian(m, lv, z), RTOL, ATOL)
    else:
        close(ts.logprob_gaussian(0.0, 0.0, t(z)),
              js.logprob_gaussian(0.0, 0.0, z), RTOL, ATOL)


@pytest.mark.parametrize("shape", [(64, 8), (3, 50, 32)])
def test_covmat(shape):
    m = rand(4, *shape, scale=2.0) + 1.5
    want = js.covmat(m) if len(shape) == 2 else jax.vmap(js.covmat)(m)
    close(ts.covmat(t(m)), want, RTOL, ATOL)


def test_mvn_logprob_plain():
    d = 6
    chol, mu, z = _spd_chol(5, d), rand(6, d), rand(7, 4, 9, d)
    close(ts.mvn_logprob(t(z), t(mu), t(chol)), js.mvn_logprob(z, mu, chol),
          RTOL, ATOL)


def test_mvn_logprob_batched_is_the_vmapped_twin():
    """The evaluator's form: per-item mu and chol, one call for the batch."""
    b, s, d = 3, 11, 8
    chol, mu, z = _spd_chol(8, d, (b,)), rand(9, b, d), rand(10, b, s, d)
    want = jax.vmap(js.mvn_logprob)(z, mu, chol)
    got = ts.mvn_logprob(t(z), t(mu), t(chol))
    assert got.shape == (b, s)
    close(got, want, RTOL, ATOL)


@pytest.mark.parametrize("dim", [1, -1])
def test_iwae_bound(dim):
    logw = rand(11, 4, 33, scale=30.0) - 500.0
    close(tl.iwae_bound(t(logw), dim=dim), jl.iwae_bound(jnp.asarray(logw), axis=dim),
          RTOL, ATOL)


def test_iwae_bound_detaches_the_shift():
    """The max shift carries no gradient: d bound / d logw is the softmax
    weights scaled by mean/(mean + eps), as in the JAX twin."""
    logw = rand(12, 2, 9, scale=3.0)
    x = t(logw).requires_grad_(True)
    tl.iwae_bound(x, dim=1).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jl.iwae_bound(a, axis=1)))(jnp.asarray(logw))
    close(x.grad, want, RTOL, ATOL)


@pytest.mark.parametrize("reduce", ["mean", "per_item", "sum"])
def test_reduce_batch(reduce):
    v = rand(13, 6)
    if reduce == "sum":
        with pytest.raises(ValueError):
            tl.reduce_batch(t(v), reduce)
        return
    close(tl.reduce_batch(t(v), reduce), jl.reduce_batch(jnp.asarray(v), reduce),
          RTOL, ATOL)
    assert tl.reduce_batch(t(v), reduce).shape == (() if reduce == "mean" else (6,))


def test_covmat_is_exact_fp32_product():
    """covmat's product is one fp32 matmul: against fp64 on the CPU, the
    error stays at fp32 rounding (no reduced-precision path)."""
    m = rand(14, 256, 32)
    want = np.cov(m.astype(np.float64), rowvar=False)
    got = ts.covmat(torch.from_numpy(m)).double().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
