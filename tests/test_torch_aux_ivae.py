"""The hierarchical ("aux") implicit VAEs of the port against their JAX twins
(ardae_tpu/models/ivae/aux.py): auxmlp (ToyAuxIPVAE, Gaussian likelihood),
auxmnist (MNISTAuxIPVAE), auxconv (MNISTConvAuxIPVAE) and auxresconvct with
and without -clip (MNISTResConvAuxIPVAE), at small widths (noise 6, z 4, h
16, resconv c_dim 32). Flax params cross through convert.py; every draw is
made by jax.random from the keys the JAX code splits and injected.

Checks, each model a case of one parametrised test: sample_z, encode_det
(noise-free: equal on repeat and to sample_z at noise scale 0) and the
hidden1a features; the hidden1a width of the registry's model against
context_dim_for; ivae_loss with its terms and every parameter gradient; the
IWS bound with jitter 1e-5 per item; the converter's round trip; and the
init law of the port's own draws against JAX's (moments of every tensor,
not bit for bit). Tolerances: forward and loss rel 1e-5 (atol 1e-6 near 0),
gradients rel-norm 1e-4, bounds per item atol 1e-4 nats. The JAX side runs
jitted, one compile a model for the forward, loss and bound (a resconv
compile costs 5-15 s on the CPU) and one for each wide init.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.models.ivae import api as jiapi
from ardae_tpu.models.ivae import aux as jaux
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.ivae import api as tiapi
from ardae_tpu_torch.models.ivae import aux as taux
from ardae_tpu_torch.models.registry import build_ivae_model, context_dim_for
from torch_parity import check_init_law, check_round_trip, close, loaded, rand, t

BS, NZ, NOISE, Z, H = 4, 3, 6, 4, 16
_MLP = dict(noise_dim=NOISE, h_dim=H, z_dim=Z, num_hidden_layers=2)
MODELS = {
    # name: (flax module, the port's)
    "auxmlp": (jaux.ToyAuxIPVAE(input_dim=2, nonlinearity="relu", **_MLP),
               taux.ToyAuxIPVAE(input_dim=2, nonlinearity="relu", **_MLP)),
    "auxmnist": (jaux.MNISTAuxIPVAE(**_MLP), taux.MNISTAuxIPVAE(**_MLP)),
    "auxconv": (jaux.MNISTConvAuxIPVAE(z0_dim=NOISE, z_dim=Z),
                taux.MNISTConvAuxIPVAE(z0_dim=NOISE, z_dim=Z)),
    "auxresconvct": (
        jaux.MNISTResConvAuxIPVAE(z0_dim=NOISE, z_dim=Z, c_dim=32, do_center=True),
        taux.MNISTResConvAuxIPVAE(z0_dim=NOISE, z_dim=Z, c_dim=32, do_center=True)),
    "auxresconvct-clip": (
        jaux.MNISTResConvAuxIPVAE(z0_dim=NOISE, z_dim=Z, c_dim=32, do_center=True,
                                  clipped=True),
        taux.MNISTResConvAuxIPVAE(z0_dim=NOISE, z_dim=Z, c_dim=32, do_center=True,
                                  clipped=True)),
}
NAMES = list(MODELS)


def _x(name, n, seed):
    if name == "auxmlp":
        return rand(seed, n, 2, scale=3.0)
    return (_synthetic_mnist(n, seed=seed)[0] > 0.5).astype(np.float32)


def _pair(n, seed):
    return rand(seed, n, NOISE), rand(seed + 1, n, Z)


@functools.cache
def build(name):
    """(flax module, params, the port's module with them); built once."""
    jm, tm = MODELS[name]
    p = jax.jit(jm.init)(jax.random.PRNGKey(3), _x(name, 2, 5), _pair(2, 4))
    return jm, p, loaded(tm, p)


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _inputs(name):
    """The inputs of every JAX-side check: x (BS items), the nz-3 and nz-1
    noise pairs, decoder z, the loss key, x3 and the IWS key."""
    return dict(x=_x(name, BS, 6), eps=_pair(BS * NZ, 7), eps1=_pair(BS, 9),
                z=rand(11, 5, Z), key=jax.random.PRNGKey(13), x3=_x(name, 3, 14),
                key3=jax.random.PRNGKey(15))


@functools.cache
def jax_side(name):
    """Every JAX-side value the checks below compare with, from one
    compile: the forward tuple, ivae_loss with terms and gradients, the
    IWS-16 bound with jitter 1e-5."""
    jm, p, _ = build(name)
    a = _inputs(name)

    def jfn(p, x, eps, eps1, z, x3):
        fwd = (jm.apply(p, x, eps, method=jm.sample_z),
               jm.apply(p, x, eps, 0.5, method=jm.sample_z),
               jiapi.encode_det(jm, p, x),
               jiapi.encode_hidden_feats(jm, p, x),
               jm.apply(p, x, eps1, method=jm.hidden_feats),
               *jm.apply(p, z, method=jm.decode_params))
        loss = jax.value_and_grad(lambda q: jiapi.ivae_loss(
            jm, q, a["key"], x, NZ, beta=0.7), has_aux=True)(p)
        iws = jiapi.logprob_iws(jm, p, a["key3"], x3, 16, jitter=1e-5,
                                reduce="per_item")
        return fwd, loss, iws

    return jax.jit(jfn)(p, a["x"], a["eps"], a["eps1"], a["z"], a["x3"])


@pytest.mark.parametrize("name", NAMES)
def test_sample_encode_and_hidden_feats(name):
    """sample_z at nz 3 (unit noise and noise 0.5), encode_det, the hidden1a
    features and the decoder."""
    _, _, tm = build(name)
    a, want = _inputs(name), jax_side(name)[0]
    tx, te, te1 = t(a["x"]), tuple(map(t, a["eps"])), tuple(map(t, a["eps1"]))
    with torch.no_grad():
        det = tiapi.encode_det(tm, tx)
        got = (tm.sample_z(tx, te), tm.sample_z(tx, te, 0.5), det,
               tiapi.encode_hidden_feats(tm, tx), tm.hidden_feats(tx, te1),
               *tm.decode_params(t(a["z"])))
        assert torch.equal(det, tiapi.encode_det(tm, tx))
        # noise scale 0 is noise-free but for the -clip z0 std floor of 1
        free = torch.equal(det, tm.sample_z(tx, te1, 0.0))
        assert free is (name != "auxresconvct-clip")
    assert got[0].shape == (BS, NZ, Z) and det.shape == (BS, 1, Z)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape), i
        close(g, w, 1e-5, 1e-6, msg=str(i))


@pytest.mark.parametrize("name", NAMES)
def test_hidden_width_is_context_dim_for(name):
    """The registry's model at the published shapes (noise 100, z 32, h
    300): its hidden1a features are as wide as context_dim_for says (2h,
    1,600 or 450), at nz 1."""
    toy = name == "auxmlp"
    dims = dict(nchannels=2 if toy else 1, nheight=1 if toy else 28, z_dim=32,
                h_dim=300)
    tm = build_ivae_model(name, **dims, n_dim=100, n_layers=2,
                          nonlin="softplus", device="cpu")
    width = context_dim_for("hidden1a", model_name=name, **dims)
    assert width == {"auxmlp": 600, "auxmnist": 600, "auxconv": 1600}.get(name, 450)
    with torch.no_grad():
        h = tiapi.encode_hidden_feats(tm, torch.zeros(3, 2 if toy else 784))
    assert tuple(h.shape) == (3, width)


def test_hidden_feats_refuse_a_flat_model():
    tm = build_ivae_model("mnist-concat", nchannels=1, nheight=28, z_dim=4,
                          h_dim=8, n_dim=6, n_layers=1, device="cpu")
    with pytest.raises(NotImplementedError, match="aux model"):
        tiapi.encode_hidden_feats(tm, torch.zeros(2, 784))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients(name):
    """ivae_loss (beta 0.7, nz 3): loss, terms and every parameter
    gradient."""
    jm, _, tm = build(name)
    a = _inputs(name)
    (want, wterms), jgrads = jax_side(name)[1]
    eps = tuple(map(t, jiapi.make_eps(jm, a["key"], BS, NZ)))
    tm.zero_grad(set_to_none=True)
    got, terms = tiapi.ivae_loss(tm, t(a["x"]), NZ, beta=0.7, eps=eps)
    got.backward()
    close(got, want, 1e-5, 0.0)
    for k in ("recon", "prior", "z"):
        close(terms[k], wterms[k], 1e-5, 1e-6, msg=k)
    want_g = flax_to_state_dict(jgrads, tm)
    for k, prm in tm.named_parameters():
        assert _rel_norm(prm.grad, want_g[k]) <= 1e-4, k


@pytest.mark.parametrize("name", NAMES)
def test_logprob_iws_with_jitter(name):
    """logprob_iws per item with the aux jitter 1e-5, the draws of the JAX
    keys injected; cov_gaussian_iws_from_draws on the same draws."""
    jm, _, tm = build(name)
    a, ssz = _inputs(name), 16
    k_enc, k_new = jax.random.split(a["key3"])
    eps = tuple(map(t, jiapi.make_eps(jm, k_enc, 3, ssz)))
    new_eps = t(jax.random.normal(k_new, (3, ssz, Z)))
    x3 = t(a["x3"])
    with torch.no_grad():
        got = tiapi.logprob_iws(tm, x3, ssz, jitter=1e-5, reduce="per_item",
                                eps=eps, new_eps=new_eps)
        z = tiapi.sample_latents(tm, x3, ssz, eps=eps)
        again = tiapi.cov_gaussian_iws_from_draws(tm, x3, z, 1e-5, eps=new_eps)
    assert got.shape == (3,) and bool(torch.isfinite(got).all())
    close(got, jax_side(name)[2], 1e-5, 1e-4)
    assert torch.equal(again, got)


@pytest.mark.parametrize("name", NAMES)
def test_convert_round_trip(name):
    _, p, tm = build(name)
    check_round_trip(p, tm)


WIDE = dict(z_dim=24, h_dim=256, n_dim=32, n_layers=2, nonlin="softplus")


@functools.cache
def _wide_jax(name):
    x = np.zeros((2, 256 if name == "auxmlp" else 784), np.float32)
    mlp = dict(noise_dim=32, h_dim=256, z_dim=24, num_hidden_layers=2,
               nonlinearity="softplus")
    jm = {"auxmlp": lambda: jaux.ToyAuxIPVAE(input_dim=256, **mlp),
          "auxmnist": lambda: jaux.MNISTAuxIPVAE(**mlp),
          "auxconv": lambda: jaux.MNISTConvAuxIPVAE(z0_dim=32, z_dim=24),
          "auxresconvct": lambda: jaux.MNISTResConvAuxIPVAE(
              z0_dim=32, z_dim=24, c_dim=450, do_center=True)}[name]()
    eps = (np.zeros((2, 32), np.float32), np.zeros((2, 24), np.float32))
    return jax.jit(jm.init)(jax.random.PRNGKey(0), x, eps)


@pytest.mark.parametrize("name", NAMES)
def test_init_law_matches_jax(name):
    """Each tensor of the registry's model (drawn from the port's generator)
    against the same tensor of a JAX init at the same widths (the -clip
    variant has the unclipped one's parameters): equal where JAX's is
    constant (zero biases, the weight-normalised layers' unit scales); else the same spread (std within 5 % + 2 / sqrt(size): xavier where
    JAX is xavier, the N(0, 1) toy decoder mean, the torch-default rest)
    around 0. auxmlp takes 256-wide data, so that its decoder's
    tensors are wide enough to show a spread."""
    tm = build_ivae_model(name, nchannels=1, nheight=16 if name == "auxmlp" else 28,
                          **WIDE, seed=1, device="cpu")
    want = flax_to_state_dict(_wide_jax(name.replace("-clip", "")), tm)
    check_init_law(tm.state_dict(), want)
