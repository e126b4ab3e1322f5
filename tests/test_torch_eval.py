"""The IWS evaluator, port against JAX: cov_gaussian_iws_from_draws and
logprob_iws per item for a tiny resconvct-res (z 8, h 16, ssz 32) and a
tiny mnist-conv (z 32, ssz 64), and evaluate_iws_ivae over a 37-item split
at batch 16 (a 5-item tail) with dynamic binarization. Flax params cross
through convert.py; every draw is made by jax.random from the keys the JAX
code splits (api.py:173, common.py:183-186) and injected into the port.

Tolerances: per item rtol 1e-5, atol 1e-3 nats (the decoder's logits agree
to ~1e-5 relative and the bound sums 784 pixel terms); the split's mean
within 1e-5 relative."""

import functools

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.cli.common import evaluate_iws_ivae as j_evaluate
from ardae_tpu.models.ivae import api as japi
from ardae_tpu.models.ivae.conv import ConvIPVAE as JConv
from ardae_tpu.models.ivae.resconv import ResConvIPVAE as JRes
from ardae_tpu_torch.cli.common import evaluate_iws_ivae as t_evaluate
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.ivae import api as tapi
from ardae_tpu_torch.models.ivae.conv import ConvIPVAE as TConv
from ardae_tpu_torch.models.ivae.resconv import ResConvIPVAE as TRes
from torch_parity import close, init, loaded, t

RTOL, ATOL, NOISE = 1e-5, 1e-3, 10
LINES = {"resconvct-res": (8, 32), "mnist-conv": (32, 64)}  # (z, ssz)


@functools.cache
def _build(name):
    """(flax module, params, the port's module with them); built once."""
    z = LINES[name][0]
    x0 = _synthetic_mnist(2, seed=5)[0]
    if name == "mnist-conv":
        jm, tm = JConv(z_dim=z, noise_dim=NOISE), TConv(z_dim=z, noise_dim=NOISE)
    else:
        jm = JRes(z_dim=z, noise_dim=NOISE, h_dim=16, num_hidden_layers=1,
                  nonlinearity="elu", do_center=True, enc_type="res-wn-mlp")
        tm = TRes(z_dim=z, noise_dim=NOISE, h_dim=16, num_hidden_layers=1,
                  nonlinearity="elu", do_center=True)
    p = init(jm, x0, np.zeros((2, NOISE), np.float32), seed=3)
    return jm, p, loaded(tm, p).eval()


@pytest.fixture(scope="module", params=list(LINES))
def line(request):
    return (request.param,) + _build(request.param)


def _binary(n, seed):
    return (_synthetic_mnist(n, seed=seed)[0] > 0.5).astype(np.float32)


def _iws_draws(jm, key, bsz, ssz, zdim):
    """The draws logprob_iws makes from ``key`` (api.py:173)."""
    k_enc, k_new = jax.random.split(key)
    return (t(japi.make_eps(jm, k_enc, bsz, ssz)),
            t(jax.random.normal(k_new, (bsz, ssz, zdim))))


def test_logprob_iws_per_item(line):
    name, jm, p, tm = line
    zdim, ssz = LINES[name]
    x, key = _binary(3, 6), jax.random.PRNGKey(7)
    want = japi.logprob_iws(jm, p, key, x, ssz, reduce="per_item")
    eps, new_eps = _iws_draws(jm, key, 3, ssz, zdim)
    with torch.no_grad():
        got = tapi.logprob_iws(tm, t(x), ssz, reduce="per_item", eps=eps,
                               new_eps=new_eps)
    assert got.shape == (3,) and bool(torch.isfinite(got).all())
    close(got, want, RTOL, ATOL)
    close(tapi.logprob_iws(tm, t(x), ssz, eps=eps, new_eps=new_eps).detach(),
          np.mean(np.asarray(want)), RTOL, ATOL)


def test_cov_gaussian_iws_from_draws_per_item(line):
    name, jm, p, tm = line
    zdim, ssz = LINES[name]
    x, key = _binary(3, 8), jax.random.PRNGKey(9)
    z = japi.sample_latents(jm, p, jax.random.PRNGKey(10), x, ssz)
    want = japi.cov_gaussian_iws_from_draws(jm, p, x, z, key, jitter=1e-5)
    with torch.no_grad():
        got = tapi.cov_gaussian_iws_from_draws(
            tm, t(x), t(z), jitter=1e-5,
            eps=t(jax.random.normal(key, (3, ssz, zdim))))
    close(got, want, RTOL, ATOL)


def _replayed_eval_draws(jm, key, n, batch, ssz, zdim):
    """Each batch's draws as JAX's evaluate_iws_ivae makes them
    (common.py:180-187) on its zero-padded batch, cut to the real rows."""
    draws = []
    for start in range(0, n, batch):
        nv = min(batch, n - start)
        key, sub = jax.random.split(key)
        key, kb = jax.random.split(key)
        eps, new_eps = _iws_draws(jm, sub, batch, ssz, zdim)
        draws.append({"bin": t(jax.random.uniform(kb, (batch, 784)))[:nv],
                      "eps": eps[:nv * ssz], "new_eps": new_eps[:nv]})
    return draws


def test_evaluate_iws_ivae_matches_jax_with_a_short_tail():
    """The slice as a whole: 37 items at batch 16, binarized per batch."""
    jm, p, tm = _build("resconvct-res")
    zdim, ssz = LINES["resconvct-res"]
    data, key = _synthetic_mnist(37, seed=11)[0], jax.random.PRNGKey(12)
    want = j_evaluate(jm, p, data, ssz, key, binarize=True, batch=16)
    got = t_evaluate(tm, data, ssz, binarize=True, batch=16,
                     draws=_replayed_eval_draws(jm, key, 37, 16, ssz, zdim))
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("case", ["all draws equal", "ssz < z_dim"])
def test_collapsed_posterior_gives_a_finite_bound(case):
    """A collapsed or rank-deficient sample covariance: the relative floor
    keeps the Cholesky defined and the bound finite (the reference's
    MultivariateNormal fails there)."""
    _, _, tm = _build("resconvct-res")
    x = torch.from_numpy(_binary(2, 13))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        if case == "all draws equal":
            z = torch.randn(2, 1, 8, generator=g).expand(2, 16, 8).contiguous()
            lp = tapi.cov_gaussian_iws_from_draws(tm, x, z, generator=g)
        else:
            lp = tapi.logprob_iws(tm, x, 3, reduce="per_item", generator=g)
    assert lp.shape == (2,) and bool(torch.isfinite(lp).all()), lp


def test_tail_batch_counts_every_item():
    """11 items at batch 4 (a 3-item tail) and at batch 11, each item with
    the same draws: the item-weighted means agree."""
    _, _, tm = _build("resconvct-res")
    data = _synthetic_mnist(11, seed=14)[0]
    g = torch.Generator().manual_seed(1)
    ssz = 16
    per_item = [{"bin": torch.rand(1, 784, generator=g),
                 "eps": torch.randn(ssz, NOISE, generator=g),
                 "new_eps": torch.randn(1, ssz, 8, generator=g)} for _ in range(11)]

    def grouped(batch):
        return [{k: torch.cat([d[k] for d in per_item[s:s + batch]])
                 for k in per_item[0]} for s in range(0, 11, batch)]

    lp4 = t_evaluate(tm, data, ssz, binarize=True, batch=4, draws=grouped(4))
    lp11 = t_evaluate(tm, data, ssz, binarize=True, batch=11, draws=grouped(11))
    lp1 = t_evaluate(tm, data, ssz, binarize=True, batch=1, draws=grouped(1))
    assert np.isfinite(lp4)
    assert abs(lp4 - lp11) <= 1e-5 * abs(lp11) and abs(lp1 - lp11) <= 1e-5 * abs(lp11)


def test_default_batch_and_generator_draws():
    """batch=None groups max(1, min(128, 2**25 // (iws * 784))) items; the
    generator's draws give a finite, seed-determined mean."""
    _, _, tm = _build("resconvct-res")
    data = _synthetic_mnist(5, seed=15)[0]
    runs = [t_evaluate(tm, data, 16, torch.Generator().manual_seed(s),
                       binarize=True) for s in (2, 2, 3)]
    assert all(np.isfinite(runs)) and runs[0] == runs[1] != runs[2]
