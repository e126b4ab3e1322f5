"""The resconv implicit VAE of the flagship line, port against JAX, on real
28x28 inputs (the MNIST surrogate), with the encoder noise drawn by
jax.random and injected into the port; and the four other fc heads (mlp,
res-mlp, res-wn-mlp-lin, res-mlp-lin; h 32, one and two layers) through
sample_z, encode_det and ivae_loss. fp32; rtol 1e-4 / atol 1e-5: ten
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


HEADS = [("mlp", 1), ("res-mlp", 1), ("res-wn-mlp-lin", 1), ("res-mlp-lin", 1),
         ("mlp", 2), ("res-wn-mlp-lin", 2)]


@pytest.fixture(scope="module", params=HEADS, ids=[f"{h}-{n}" for h, n in HEADS])
def head_pair(request):
    enc_type, layers = request.param
    x = _synthetic_mnist(3, seed=5)[0]
    kw = dict(z_dim=Z, noise_dim=NOISE, h_dim=H, num_hidden_layers=layers,
              nonlinearity="elu", do_center=layers == 2, enc_type=enc_type)
    jm = JIPVAE(**kw)
    p = init(jm, x, np.zeros((3, NOISE), np.float32))
    return jm, p, loaded(TIPVAE(**kw), p), x


def test_sample_z_of_each_head(head_pair):
    jm, p, tm, x = head_pair
    key = jax.random.PRNGKey(3)
    want = japi.sample_latents(jm, p, key, x, 4)
    got = tapi.sample_latents(tm, t(x), 4, eps=t(japi.make_eps(jm, key, 3, 4)))
    assert got.shape == (3, 4, Z)
    close(got, want, RTOL, ATOL)
    close(tapi.encode_det(tm, t(x)), japi.encode_det(jm, p, x), RTOL, ATOL)


def test_ivae_loss_of_each_head(head_pair):
    jm, p, tm, x = head_pair
    key = jax.random.PRNGKey(4)
    want, wterms = japi.ivae_loss(jm, p, key, x, 2, beta=0.7)
    got, terms = tapi.ivae_loss(tm, t(x), 2, beta=0.7,
                                eps=t(japi.make_eps(jm, key, 3, 2)))
    close(got, want, RTOL, ATOL)
    close(terms["z"], wterms["z"], RTOL, ATOL)


def test_lin_head_at_one_layer_is_one_res_block_then_a_linear():
    """At --model-n-layers 1 fc_res has no hidden block: one ResLinear
    (c+n -> h) with the output nonlinearity, then fc_lin (h -> z)."""
    tm = TIPVAE(z_dim=Z, noise_dim=NOISE, h_dim=H, enc_type="res-mlp-lin")
    assert len(tm.fc_res.layers) == 0 and tm.fc_res.use_nonlinearity_output
    assert tm.fc_res.fc.dot_0h.weight.shape == (H, 512 + NOISE)
    assert tm.fc_lin.weight.shape == (Z, H)
