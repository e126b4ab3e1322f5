"""The thirteen toy-encoder fusions of the port against their JAX twins:
ToyIPVAE(enc_type=...) for each name of ENC_TYPES, at small widths where
every context layer has unequal in / out / context widths (noise 5, h 12,
z 3), so a row normalisation over the wrong axis fails. Flax params cross
through convert.py; every draw is made by jax.random and injected.

Each name is a case of each parametrised test: sample_z, then the IVAE
loss (beta 0.7, nz 3) with every parameter gradient; the converter's round
trip; and the init law of the port's own draws against a JAX init of the
same widths (moments of every tensor, the N(0, 1) output layers among
them). Tolerances: forward and loss rel 1e-5 (atol 1e-6 near 0),
gradients rel-norm 1e-4.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.models.ivae import api as jiapi
from ardae_tpu.models.ivae.toy import ENC_TYPES as J_ENC_TYPES
from ardae_tpu.models.ivae.toy import ToyIPVAE as JToy
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.models.ivae import api as tiapi
from ardae_tpu_torch.models.ivae.toy import ENC_TYPES, ToyIPVAE as TToy
from ardae_tpu_torch.nn.initializers import init_module
from torch_parity import check_init_law, check_round_trip, close, loaded, rand, t

BS, NZ = 4, 3
SMALL = dict(input_dim=2, noise_dim=5, h_dim=12, z_dim=3, nonlinearity="softplus",
             num_hidden_layers=2)
WIDE = dict(input_dim=64, noise_dim=32, h_dim=256, z_dim=24, nonlinearity="relu",
            num_hidden_layers=2)


def _init(jm, widths, seed):
    return jm.init(jax.random.PRNGKey(seed), np.zeros((2, widths["input_dim"]), np.float32),
                   np.zeros((2, widths["noise_dim"]), np.float32))


@functools.cache
def build(enc_type):
    jm = JToy(**SMALL, enc_type=enc_type)
    p = _init(jm, SMALL, 3)
    return jm, p, loaded(TToy(**SMALL, enc_type=enc_type), p)


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def test_enc_types_are_the_twins():
    assert ENC_TYPES == J_ENC_TYPES and len(ENC_TYPES) == 13
    with pytest.raises(ValueError, match="unknown toy encoder"):
        TToy(**SMALL, enc_type="concatenate")


@pytest.mark.parametrize("enc_type", ENC_TYPES)
def test_sample_z_and_loss_gradients(enc_type):
    jm, p, tm = build(enc_type)
    x, eps = rand(6, BS, 2, scale=3.0), rand(7, BS * NZ, SMALL["noise_dim"])
    want = jm.apply(p, x, eps, method=jm.sample_z)
    with torch.no_grad():
        got = tm.sample_z(t(x), t(eps))
    assert got.shape == (BS, NZ, SMALL["z_dim"])
    close(got, want, 1e-5, 1e-6)

    key = jax.random.PRNGKey(10)
    jfn = lambda q: jiapi.ivae_loss(jm, q, key, x, NZ, beta=0.7)
    (want, wterms), jgrads = jax.value_and_grad(jfn, has_aux=True)(p)
    tm.zero_grad(set_to_none=True)
    got, terms = tiapi.ivae_loss(tm, t(x), NZ, beta=0.7,
                                 eps=t(jiapi.make_eps(jm, key, BS, NZ)))
    got.backward()
    close(got, want, 1e-5, 0.0)
    for k in ("recon", "prior", "z"):
        close(terms[k], wterms[k], 1e-5, 1e-6, msg=k)
    want_g = flax_to_state_dict(jgrads, tm)
    assert want_g.keys() == dict(tm.named_parameters()).keys()
    for k, prm in tm.named_parameters():
        assert _rel_norm(prm.grad, want_g[k]) <= 1e-4, k


@pytest.mark.parametrize("enc_type", ENC_TYPES)
def test_convert_round_trip(enc_type):
    _, p, tm = build(enc_type)
    check_round_trip(p, tm)


@pytest.mark.parametrize("enc_type", ENC_TYPES)
def test_init_law_matches_jax(enc_type):
    """The port's own init (init_mode "gaussian", as every registry entry)
    against a JAX init of the same widths, tensor by tensor: the N(0, 1)
    output layers (direction, path1, path2, the cbias and fc kernels), the
    N(0, 0.005^2) context scales, the unit WN scales and the torch-default
    rest."""
    tm = TToy(**WIDE, enc_type=enc_type)
    init_module(tm, torch.Generator().manual_seed(1))
    want = flax_to_state_dict(_init(JToy(**WIDE, enc_type=enc_type), WIDE, 0), tm)
    check_init_law(tm.state_dict(), want)
