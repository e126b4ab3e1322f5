"""The resconv implicit VAE of the flagship line, port against JAX, on real
28x28 inputs (the MNIST surrogate), with the encoder noise drawn by
jax.random and injected into the port. fp32; rtol 1e-4 / atol 1e-5: ten
conv layers and two bilinear upsamplings deep, XLA's and PyTorch's CPU
convolutions sum in different orders."""

import jax
import numpy as np
import pytest

from ardae_tpu.models.ivae import api as japi
from ardae_tpu.models.ivae.resconv import ResConvIPVAE as JIPVAE
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.ivae import api as tapi
from ardae_tpu_torch.models.ivae.resconv import ResConvIPVAE as TIPVAE
from torch_parity import close, init, loaded, t

RTOL, ATOL = 1e-4, 1e-5
Z, NOISE, H = 8, 10, 32


@pytest.fixture(scope="module")
def pair():
    x = _synthetic_mnist(3, seed=5)[0]
    jm = JIPVAE(z_dim=Z, noise_dim=NOISE, h_dim=H, num_hidden_layers=1,
                nonlinearity="elu", do_center=True, enc_type="res-wn-mlp")
    p = init(jm, x, np.zeros((3, NOISE), np.float32))
    tm = loaded(TIPVAE(z_dim=Z, noise_dim=NOISE, h_dim=H, num_hidden_layers=1,
                       nonlinearity="elu", do_center=True), p)
    return jm, p, tm, x


def test_trunk(pair):
    jm, p, tm, x = pair
    close(tm.trunk(t(x)), jm.apply(p, x, method=lambda m, a: m.trunk(a)), RTOL, ATOL)


def test_decoder(pair):
    jm, p, tm, _ = pair
    z = np.random.default_rng(1).normal(size=(5, Z)).astype(np.float32)
    (want,) = jm.apply(p, z, method=jm.decode_params)
    (got,) = tm.decode_params(t(z))
    assert got.shape == (5, 784)
    close(got, want, RTOL, ATOL)


def test_sample_z_injected_eps(pair):
    jm, p, tm, x = pair
    key = jax.random.PRNGKey(3)
    want = japi.sample_latents(jm, p, key, x, 4)
    eps = japi.make_eps(jm, key, 3, 4)  # the draw sample_latents makes
    got = tapi.sample_latents(tm, t(x), 4, eps=t(eps))
    assert got.shape == (3, 4, Z)
    close(got, want, RTOL, ATOL)


def test_encode_det(pair):
    jm, p, tm, x = pair
    close(tapi.encode_det(tm, t(x)), japi.encode_det(jm, p, x), RTOL, ATOL)


def test_ivae_loss_injected_eps(pair):
    jm, p, tm, x = pair
    key = jax.random.PRNGKey(4)
    want, wterms = japi.ivae_loss(jm, p, key, x, 2, beta=0.7)
    eps = japi.make_eps(jm, key, 3, 2)
    got, terms = tapi.ivae_loss(tm, t(x), 2, beta=0.7, eps=t(eps))
    close(got, want, RTOL, ATOL)
    for k in ("recon", "prior", "z"):
        close(terms[k], wterms[k], RTOL, ATOL, msg=k)
