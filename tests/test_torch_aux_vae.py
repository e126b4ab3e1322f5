"""The hierarchical-aux baseline VAEs of the port against their JAX twins
(ardae_tpu/models/vae/aux.py): auxtoy (ToyAuxVAE, Gaussian likelihood),
auxmnist (MNISTAuxVAE), auxconv (MNISTConvAuxVAE, three conv towers) and
auxresconv (MNISTResConvAuxVAE, spm4 heads), at small widths (z0 6, z 4, h
16, resconv c_dim 32), each built as the JAX registry builds it
(do_xavier=False). Flax params cross through convert.py; every draw is made
by jax.random from the keys the JAX code splits and injected. The port's
calls go through models/vae/api.py, which hands the aux family to
aux_vae_loss / aux_logprob_iwae, as the JAX drivers pick them.

Checks, each model a case of one parametrised test: aux_vae_loss per item
(beta 0.7) and its terms, the mean's gradient of every parameter,
aux_logprob_iwae per item (IWAE-8), generate and reconstruct, the
converter's round trip (the aux conv towers' partial NHWC permutation
included), and the init law of the port's own draws against JAX's.
Tolerances: losses rel 1e-5, gradients rel-norm 1e-4, bounds per item atol
1e-4 nats, samples rel 1e-5. The JAX side runs jitted, one compile a model
for the loss, bound and samples, one for each wide init.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.models.vae import api as jvapi
from ardae_tpu.models.vae import aux as jaux
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.registry import build_vae_model
from ardae_tpu_torch.models.vae import api as tvapi
from ardae_tpu_torch.models.vae import aux as taux
from torch_parity import check_init_law, check_round_trip, close, loaded, rand, t

BS, NOISE, Z, H, SSZ, NGEN = 4, 6, 4, 16, 8, 5
_MLP = dict(noise_dim=NOISE, h_dim=H, z_dim=Z, num_hidden_layers=2)
MODELS = {
    "auxtoy": (jaux.ToyAuxVAE(input_dim=2, **_MLP),
               taux.ToyAuxVAE(input_dim=2, **_MLP)),
    "auxmnist": (jaux.MNISTAuxVAE(do_xavier=False, **_MLP), taux.MNISTAuxVAE(**_MLP)),
    "auxconv": (jaux.MNISTConvAuxVAE(z0_dim=NOISE, z_dim=Z, do_xavier=False),
                taux.MNISTConvAuxVAE(z0_dim=NOISE, z_dim=Z)),
    "auxresconv": (jaux.MNISTResConvAuxVAE(z0_dim=NOISE, z_dim=Z, c_dim=32),
                   taux.MNISTResConvAuxVAE(z0_dim=NOISE, z_dim=Z, c_dim=32)),
}
NAMES = list(MODELS)
KEYS = dict(loss=jax.random.PRNGKey(10), iwae=jax.random.PRNGKey(11),
            sample=jax.random.PRNGKey(12))


def _x(name, n, seed):
    if name == "auxtoy":
        return rand(seed, n, 2, scale=3.0)
    return (_synthetic_mnist(n, seed=seed)[0] > 0.5).astype(np.float32)


@functools.cache
def build(name):
    """(flax module, params, the port's module with them); built once."""
    jm, tm = MODELS[name]
    p = jax.jit(jm.init)(jax.random.PRNGKey(3), _x(name, 2, 5))
    return jm, p, loaded(tm, p)


@functools.cache
def jax_side(name):
    """From one compile: aux_vae_loss per item with its terms, the mean's
    value and gradients, aux_logprob_iwae per item, generate and
    reconstruct."""
    jm, p, _ = build(name)

    def jfn(p, x):
        per_item = jaux.aux_vae_loss(jm, p, KEYS["loss"], x, beta=0.7,
                                     reduce="per_item")
        mean = jax.value_and_grad(lambda q: jaux.aux_vae_loss(
            jm, q, KEYS["loss"], x, beta=0.7)[0])(p)
        iwae = jaux.aux_logprob_iwae(jm, p, KEYS["iwae"], x, SSZ, reduce="per_item")
        return (per_item, mean, iwae, jvapi.generate(jm, p, KEYS["sample"], NGEN),
                jvapi.reconstruct(jm, p, KEYS["sample"], x))

    return jax.jit(jfn)(p, _x(name, BS, 6))


def _split_normals(key, rows):
    k0, k1 = jax.random.split(key)
    return (t(jax.random.normal(k0, (rows, NOISE))),
            t(jax.random.normal(k1, (rows, Z))))


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@pytest.mark.parametrize("name", NAMES)
def test_loss_per_item_and_terms(name):
    _, _, tm = build(name)
    (want, wterms) = jax_side(name)[0]
    with torch.no_grad():
        got, terms = tvapi.vae_loss(tm, t(_x(name, BS, 6)), beta=0.7,
                                    reduce="per_item",
                                    eps=_split_normals(KEYS["loss"], BS))
    assert got.shape == (BS,)
    close(got, want, 1e-5, 1e-6)
    for k in ("recon", "kld", "z"):
        close(terms[k], wterms[k], 1e-5, 1e-6, msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_loss_gradients(name):
    _, _, tm = build(name)
    want, jgrads = jax_side(name)[1]
    tm.zero_grad(set_to_none=True)
    got, _ = tvapi.vae_loss(tm, t(_x(name, BS, 6)), beta=0.7,
                            eps=_split_normals(KEYS["loss"], BS))
    got.backward()
    close(got, want, 1e-5, 0.0)
    want_g = flax_to_state_dict(jgrads, tm)
    for k, prm in tm.named_parameters():
        assert _rel_norm(prm.grad, want_g[k]) <= 1e-4, k


@pytest.mark.parametrize("name", NAMES)
def test_logprob_iwae_per_item(name):
    _, _, tm = build(name)
    with torch.no_grad():
        got = tvapi.logprob_iwae(tm, t(_x(name, BS, 6)), SSZ, reduce="per_item",
                                 eps=_split_normals(KEYS["iwae"], BS * SSZ))
    assert got.shape == (BS,) and bool(torch.isfinite(got).all())
    close(got, jax_side(name)[2], 1e-5, 1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_generate_and_reconstruct(name):
    """generate (z from kz, the decoder sample from kx) and reconstruct (z0,
    z from the two halves of k_enc, the decoder sample from k_dec): uniforms
    for a Bernoulli likelihood, normals for a Gaussian one."""
    _, _, tm = build(name)
    want, rwant = jax_side(name)[3:]
    bern = name != "auxtoy"

    def dec_noise(k, shape):
        return t(jax.random.uniform(k, shape) if bern else jax.random.normal(k, shape))

    kz, kx = jax.random.split(KEYS["sample"])
    k_enc, k_dec = jax.random.split(KEYS["sample"])
    with torch.no_grad():
        got = tvapi.generate(tm, NGEN, eps=t(jax.random.normal(kz, (NGEN, Z))),
                             u=dec_noise(kx, want[1].shape))
        rgot = tvapi.reconstruct(tm, t(_x(name, BS, 6)),
                                 eps=_split_normals(k_enc, BS),
                                 u=dec_noise(k_dec, rwant[1].shape))
    for g, w in zip(got + rgot, want + rwant):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, 1e-5, 1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_convert_round_trip(name):
    _, p, tm = build(name)
    check_round_trip(p, tm)


WIDE = dict(z_dim=24, h_dim=256, n_dim=32, n_layers=2, nonlin="softplus")


def _wide_jax(name):
    x = np.zeros((2, 256 if name == "auxtoy" else 784), np.float32)
    mlp = dict(noise_dim=32, h_dim=256, z_dim=24, num_hidden_layers=2)
    jm = {"auxtoy": lambda: jaux.ToyAuxVAE(input_dim=256, **mlp),
          "auxmnist": lambda: jaux.MNISTAuxVAE(do_xavier=False, **mlp),
          "auxconv": lambda: jaux.MNISTConvAuxVAE(z0_dim=32, z_dim=24,
                                                  do_xavier=False),
          "auxresconv": lambda: jaux.MNISTResConvAuxVAE(z0_dim=32, z_dim=24)}[name]()
    return jax.jit(jm.init)(jax.random.PRNGKey(0), x)


@pytest.mark.parametrize("name", NAMES)
def test_init_law_matches_jax(name):
    """Each tensor of the registry's model (drawn from the port's generator)
    against the same tensor of a JAX init at the same widths: equal where
    JAX's is constant (zero biases, the weight-normalised layers' unit
    scales); else the same spread (std within 5 % + 2 / sqrt(size): the
    xavier MNIST decoder, the N(0, 1) toy decoder mean, the torch-default
    rest) around 0. auxtoy takes 256-wide data, so that its decoder's
    tensors are wide enough to show a spread."""
    tm = build_vae_model(name, nchannels=1, nheight=16 if name == "auxtoy" else 28,
                         **WIDE, seed=1, device="cpu")
    want = flax_to_state_dict(_wide_jax(name), tm)
    check_init_law(tm.state_dict(), want)
