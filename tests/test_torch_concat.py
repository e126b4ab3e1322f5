"""The MLP-concat family of the port against its JAX twins: the implicit
VAEs ``mnist-concat`` (MNISTIPVAE, Bernoulli) and ``mlp-concat`` (ToyIPVAE,
Gaussian likelihood) and the ``toy`` baseline (ToyVAE, Gaussian
likelihood), at small widths. Flax params cross through convert.py; every
draw is made by jax.random from the keys the JAX code splits and injected.

Checks, each model a case of one parametrised test: the forward (sampler
and decoder), the training loss with its terms and every parameter
gradient, the IWS bound (IWAE for ToyVAE) per item, generate and
reconstruct, the converter's round trip, and the init law of the port's
own draws against JAX's (moments of every tensor of a wide model, not bit
for bit). Tolerances: forward and loss rel 1e-5 (atol 1e-6 on values near
0), gradients rel-norm 1e-4, bounds per item atol 1e-4 nats. The JAX side
runs jitted.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.models.ivae import api as jiapi
from ardae_tpu.models.ivae.mnist import MNISTIPVAE as JMnist
from ardae_tpu.models.ivae.toy import ToyIPVAE as JToy
from ardae_tpu.models.vae import api as jvapi
from ardae_tpu.models.vae.toy import ToyVAE as JToyVAE
from ardae_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.ivae import api as tiapi
from ardae_tpu_torch.models.ivae.mnist import MNISTIPVAE as TMnist
from ardae_tpu_torch.models.ivae.toy import ToyIPVAE as TToy
from ardae_tpu_torch.models.registry import build_ivae_model, build_vae_model
from ardae_tpu_torch.models.vae import api as tvapi
from ardae_tpu_torch.models.vae.toy import ToyVAE as TToyVAE
from torch_parity import close, loaded, rand, t

BS, NZ = 4, 3
IMPLICIT = {
    # name: (flax module, the port's, x width, noise, z)
    "mnist-concat": (JMnist(noise_dim=6, h_dim=16, z_dim=4, num_hidden_layers=1),
                     TMnist(noise_dim=6, h_dim=16, z_dim=4, num_hidden_layers=1),
                     784, 6, 4),
    "mlp-concat": (JToy(input_dim=2, noise_dim=3, h_dim=16, z_dim=2,
                        nonlinearity="relu", num_hidden_layers=2),
                   TToy(input_dim=2, noise_dim=3, h_dim=16, z_dim=2,
                        nonlinearity="relu", num_hidden_layers=2),
                   2, 3, 2),
}
NAMES = list(IMPLICIT) + ["toy"]


def _x(name, n, seed):
    if name == "mnist-concat":
        return (_synthetic_mnist(n, seed=seed)[0] > 0.5).astype(np.float32)
    return rand(seed, n, 2, scale=3.0)


@functools.cache
def build(name):
    """(flax module, params, the port's module with them); built once."""
    if name == "toy":
        jm = JToyVAE(input_dim=2, h_dim=16, z_dim=2, num_hidden_layers=2)
        tm = TToyVAE(input_dim=2, h_dim=16, z_dim=2, num_hidden_layers=2)
        p = jax.jit(jm.init)(jax.random.PRNGKey(3), _x(name, 2, 5))
    else:
        jm, tm, _, noise, _ = IMPLICIT[name]
        p = jax.jit(jm.init)(jax.random.PRNGKey(3), _x(name, 2, 5),
                             np.zeros((2, noise), np.float32))
    return jm, p, loaded(tm, p)


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@pytest.mark.parametrize("name", NAMES)
def test_forward(name):
    jm, p, tm = build(name)
    x = _x(name, BS, 6)
    z = rand(7, 5, 4 if name == "mnist-concat" else 2)
    if name == "toy":
        want_q, want_x = jax.jit(lambda p, x, z: (
            jm.apply(p, x, method=jm.encode_params),
            jm.apply(p, z, method=jm.decode_params)))(p, x, z)
        with torch.no_grad():
            got_q, got_x = tm.encode_params(t(x)), tm.decode_params(t(z))
    else:
        eps = rand(8, BS * NZ, IMPLICIT[name][3])
        want_q, want_x = jax.jit(lambda p, x, e, z: (
            (jm.apply(p, x, e, method=jm.sample_z),),
            jm.apply(p, z, method=jm.decode_params)))(p, x, eps, z)
        with torch.no_grad():
            got_q, got_x = (tm.sample_z(t(x), t(eps)),), tm.decode_params(t(z))
        assert got_q[0].shape == (BS, NZ, IMPLICIT[name][4])
    for g, w in zip(got_q + tuple(got_x), want_q + tuple(want_x)):
        close(g, w, 1e-5, 1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients(name):
    """ivae_loss (beta 0.7, nz 3) or vae_loss (beta 0.7): loss, terms and
    every parameter gradient."""
    jm, p, tm = build(name)
    x, key = _x(name, BS, 9), jax.random.PRNGKey(10)
    if name == "toy":
        jfn = lambda q: jvapi.vae_loss(jm, q, key, x, beta=0.7)
        eps = t(jax.random.normal(key, (BS, 2)))
        terms_k = ("recon", "kld", "z")
    else:
        jfn = lambda q: jiapi.ivae_loss(jm, q, key, x, NZ, beta=0.7)
        eps = t(jiapi.make_eps(jm, key, BS, NZ))
        terms_k = ("recon", "prior", "z")
    (want, wterms), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(p)
    tm.zero_grad(set_to_none=True)
    if name == "toy":
        got, terms = tvapi.vae_loss(tm, t(x), beta=0.7, eps=eps)
    else:
        got, terms = tiapi.ivae_loss(tm, t(x), NZ, beta=0.7, eps=eps)
    got.backward()
    close(got, want, 1e-5, 0.0)
    for k in terms_k:
        close(terms[k], wterms[k], 1e-5, 1e-6, msg=k)
    want_g = flax_to_state_dict(jgrads, tm)
    for k, prm in tm.named_parameters():
        assert _rel_norm(prm.grad, want_g[k]) <= 1e-4, k


@pytest.mark.parametrize("name", NAMES)
def test_bound_per_item(name):
    """logprob_iws (the covariance-Gaussian pseudo-posterior; Gaussian
    likelihood for mlp-concat) or ToyVAE's logprob_iwae, per item."""
    jm, p, tm = build(name)
    x, key, ssz = _x(name, 3, 11), jax.random.PRNGKey(12), 16
    if name == "toy":
        want = jax.jit(lambda p, x: jvapi.logprob_iwae(
            jm, p, key, x, ssz, reduce="per_item"))(p, x)
        with torch.no_grad():
            got = tvapi.logprob_iwae(tm, t(x), ssz, reduce="per_item",
                                     eps=t(jax.random.normal(key, (3, ssz, 2))))
    else:
        zdim = IMPLICIT[name][4]
        want = jax.jit(lambda p, x: jiapi.logprob_iws(
            jm, p, key, x, ssz, reduce="per_item"))(p, x)
        k_enc, k_new = jax.random.split(key)
        with torch.no_grad():
            got = tiapi.logprob_iws(
                tm, t(x), ssz, reduce="per_item",
                eps=t(jiapi.make_eps(jm, k_enc, 3, ssz)),
                new_eps=t(jax.random.normal(k_new, (3, ssz, zdim))))
    assert got.shape == (3,) and bool(torch.isfinite(got).all())
    close(got, want, 1e-5, 1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_generate_and_reconstruct(name):
    """The JAX draws (z from kz, the decoder sample from kx: uniforms for a
    Bernoulli likelihood, normals for a Gaussian one) injected."""
    jm, p, tm = build(name)
    api_j, api_t = (jvapi, tvapi) if name == "toy" else (jiapi, tiapi)
    x, key, n = _x(name, BS, 13), jax.random.PRNGKey(14), 5
    zdim = IMPLICIT[name][4] if name in IMPLICIT else 2
    bern = name == "mnist-concat"

    def dec_noise(k, shape):
        return t(jax.random.uniform(k, shape) if bern else jax.random.normal(k, shape))

    kz, kx = jax.random.split(key)
    # one JAX compile for both
    want, rwant = jax.jit(lambda p, x: (api_j.generate(jm, p, key, n),
                                        api_j.reconstruct(jm, p, key, x)))(p, x)
    with torch.no_grad():
        got = api_t.generate(tm, n, eps=t(jax.random.normal(kz, (n, zdim))),
                             u=dec_noise(kx, want[1].shape))
    k_enc, k_dec = jax.random.split(key)
    if name == "toy":
        enc = t(jax.random.normal(k_enc, (BS, zdim)))
    else:
        enc = t(jiapi.make_eps(jm, k_enc, BS, 1))
    with torch.no_grad():
        rgot = api_t.reconstruct(tm, t(x), eps=enc, u=dec_noise(k_dec, rwant[1].shape))
    for g, w in zip(got + rgot, want + rwant):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, 1e-5, 1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_convert_round_trip(name):
    _, p, tm = build(name)
    back = state_dict_to_flax(tm.state_dict(), tm)["params"]
    flat = jax.tree_util.tree_leaves_with_path(p["params"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


WIDE = dict(nchannels=1, nheight=16, z_dim=24, h_dim=256, n_dim=32, n_layers=2,
            nonlin="softplus")


def _wide_jax(name):
    x = np.zeros((2, 256), np.float32)
    if name == "mnist-concat":
        jm = JMnist(input_dim=256, noise_dim=32, h_dim=256, z_dim=24,
                    num_hidden_layers=2)
    elif name == "mlp-concat":
        jm = JToy(input_dim=256, noise_dim=32, h_dim=256, z_dim=24,
                  nonlinearity="softplus", num_hidden_layers=2)
    else:
        jm = JToyVAE(input_dim=256, h_dim=256, z_dim=24, num_hidden_layers=2)
        return jm.init(jax.random.PRNGKey(0), x)
    return jm.init(jax.random.PRNGKey(0), x, np.zeros((2, 32), np.float32))


@pytest.mark.parametrize("name", NAMES)
def test_init_law_matches_jax(name):
    """Each tensor of the registry's model (drawn from the port's generator)
    against the same tensor of a JAX init at the same widths: zero where JAX
    is zero; else the same spread (std within 5 % + 2 / sqrt(size): the
    N(0, 1) output kernels, the xavier decoder, the torch-default rest)
    around 0."""
    build_fn = build_vae_model if name == "toy" else build_ivae_model
    tm = build_fn(name, **WIDE, seed=1, device="cpu")
    want = flax_to_state_dict(_wide_jax(name), tm)
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if not bool(w.any()):
            assert not bool(g.any()), k
            continue
        tol = 0.05 + 2.0 / g.numel() ** 0.5
        assert abs(float(g.std()) / float(w.std()) - 1.0) < tol, k
        assert abs(float(g.mean())) < 5 * float(w.std()) / g.numel() ** 0.5, k


def test_registry_builds_the_concat_encoder():
    """mlp-concat is the concat toy encoder (the JAX registry's
    enc_type="concat"): the noise enters every layer of fc, whose output
    has no activation."""
    from ardae_tpu_torch.nn.mlp import ContextConcatMLP

    tm = build_ivae_model("mlp-concat", z_dim=2, h_dim=8, n_dim=3, n_layers=2,
                          nonlin="relu", device="cpu")
    fc = tm.encode.fc
    assert isinstance(tm, TToy) and isinstance(fc, ContextConcatMLP)
    assert [layer.weight.shape[1] for layer in fc.layers] == [8 + 3, 8 + 3]
    assert fc.fc.weight.shape[1] == 8 + 3
    inp, eps = torch.randn(4, 8), torch.randn(4, 3)
    h = inp
    for layer in fc.layers:
        h = fc.afun(layer(torch.cat([h, eps], 1)))
    assert torch.equal(fc(inp, eps), fc.fc(torch.cat([h, eps], 1)))
