"""The conv implicit VAE of the implicit-conv line (mnist-conv), port against
JAX: Conv2d and ConvTranspose2d (default and xavier init), the conv trunk,
the deconv decoder and the whole ConvIPVAE on 28x28 inputs (the MNIST
surrogate), with the encoder noise drawn by jax.random and injected. Weights
cross through convert.py (their round trips are cases of
tests/test_torch_convert.py); the transposed-conv layout (no spatial flip)
is settled here. fp32; atol 1e-5 with rtol 1e-5 for the larger logits: XLA's
and PyTorch's CPU convolutions sum in different orders."""

import math

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.models.ivae import api as japi
from ardae_tpu.models.ivae.conv import ConvIPVAE as JIPVAE
from ardae_tpu.nn import conv as jconv
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.ivae import api as tapi
from ardae_tpu_torch.models.ivae.conv import ConvIPVAE as TIPVAE
from ardae_tpu_torch.models.registry import build_ivae_model
from ardae_tpu_torch.nn import conv as tconv
from torch_parity import close, init, loaded, rand, t

RTOL, ATOL = 1e-5, 1e-5
Z, NOISE = 8, 10


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


@pytest.mark.parametrize("xavier", [False, True])
def test_conv2d(xavier):
    jm = jconv.Conv2d(6, 5, 2, 2, xavier=xavier)
    x = rand(0, 2, 9, 9, 3)
    p = init(jm, x)
    tm = loaded(tconv.Conv2d(3, 6, 5, 2, 2, xavier=xavier), p)
    close(tm(t(_nchw(x))), _nchw(jm.apply(p, x)), RTOL, ATOL)


@pytest.mark.parametrize("xavier", [False, True])
def test_conv_transpose2d_layout_has_no_flip(xavier):
    """HWIO -> (in, out, k, k) with no spatial flip computes the JAX layer;
    the same kernel flipped does not."""
    jm = jconv.ConvTranspose2d(5, 5, 2, 2, xavier=xavier)
    x = rand(1, 2, 4, 4, 3)
    p = init(jm, x)
    want = _nchw(jm.apply(p, x))
    assert want.shape == (2, 5, 7, 7)
    tm = loaded(tconv.ConvTranspose2d(3, 5, 5, 2, 2, xavier=xavier), p)
    close(tm(t(_nchw(x))), want, RTOL, ATOL)
    with torch.no_grad():
        tm.weight.copy_(torch.flip(tm.weight, dims=(2, 3)))
    assert not np.allclose(tm(t(_nchw(x))).detach().numpy(), want, atol=1e-3)


@pytest.mark.parametrize("xavier", [False, True])
def test_init_bounds_follow_jax_fan_convention(xavier):
    """Each port layer draws inside the bound the JAX twin uses for the same
    layer (torch's fan convention, transposed convs included); xavier
    biases are zero."""
    k = 5
    for jm, tm, x in [
        (jconv.Conv2d(6, k, 2, 2, xavier=xavier),
         tconv.Conv2d(3, 6, k, 2, 2, xavier=xavier), rand(0, 1, 9, 9, 3)),
        (jconv.ConvTranspose2d(4, k, 2, 2, xavier=xavier),
         tconv.ConvTranspose2d(3, 4, k, 2, 2, xavier=xavier), rand(0, 1, 4, 4, 3)),
    ]:
        jp = jax.tree_util.tree_map(np.asarray, init(jm, x))["params"]
        tm.init_params(torch.Generator().manual_seed(0))
        in_ch, out_ch = jp["kernel"].shape[2], jp["kernel"].shape[3]
        if isinstance(tm, tconv.ConvTranspose2d):
            fan_in, fan_out = out_ch * k * k, in_ch * k * k
        else:
            fan_in, fan_out = in_ch * k * k, out_ch * k * k
        bound = (math.sqrt(6.0 / (fan_in + fan_out)) if xavier
                 else 1.0 / math.sqrt(fan_in))
        for w in (jp["kernel"], tm.weight.detach().numpy()):
            assert np.abs(w).max() <= bound
            assert np.abs(w).max() > 0.8 * bound
        if xavier:
            assert not tm.bias.detach().abs().max() and not np.abs(jp["bias"]).max()


@pytest.fixture(scope="module")
def pair():
    x = _synthetic_mnist(3, seed=5)[0]
    jm = JIPVAE(z_dim=Z, noise_dim=NOISE)
    p = init(jm, x, np.zeros((3, NOISE), np.float32))
    tm = loaded(TIPVAE(z_dim=Z, noise_dim=NOISE), p)
    return jm, p, tm, x


def test_trunk(pair):
    jm, p, tm, x = pair
    want = jm.apply(p, x, method=lambda m, a: m.trunk(a))
    got = tm.trunk(t(x))
    assert got.shape == (3, 32 * 4 * 4)
    # the port flattens NCHW, the JAX trunk NHWC
    nhwc = got.detach().reshape(3, 32, 4, 4).permute(0, 2, 3, 1).reshape(3, -1)
    close(nhwc, want, RTOL, ATOL)


def test_decoder_sizes(pair):
    """4 -> 7 -> pad 8 -> 15 -> 29 -> crop 28."""
    _, _, tm, _ = pair
    sizes = []
    dec = tm.decode
    hooks = [m.register_forward_hook(
        lambda m, i, o: sizes.append((i[0].shape[-1], o.shape[-1])))
        for m in (dec.deconv1, dec.deconv2, dec.reparam_logit)]
    try:
        (logit,) = tm.decode_params(torch.zeros(2, Z))
    finally:
        for h in hooks:
            h.remove()
    assert sizes == [(4, 7), (8, 15), (15, 29)]
    assert logit.shape == (2, 28 * 28)


def test_decoder(pair):
    jm, p, tm, _ = pair
    z = rand(1, 5, Z)
    (want,) = jm.apply(p, z, method=jm.decode_params)
    (got,) = tm.decode_params(t(z))
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


def test_registry_builds_xavier_model():
    m = build_ivae_model("mnist-conv", nchannels=1, nheight=28, z_dim=32,
                         h_dim=0, n_dim=100, n_layers=0, nonlin="softplus", seed=0,
                         device="cpu")
    assert isinstance(m, TIPVAE)
    assert m.fc4_eps.bias is None
    assert all(float(b.detach().abs().max()) == 0.0
               for n, b in m.named_parameters() if n.endswith("bias"))
    bound = math.sqrt(6.0 / (512 + 800))
    assert 0.8 * bound < float(m.fc4_inp.weight.detach().abs().max()) <= bound
    z = tapi.encode_det(m, torch.rand(2, 784))
    assert z.shape == (2, 1, 32) and bool(torch.isfinite(z).all())
