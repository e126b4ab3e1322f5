"""The baseline VAEs of the parity tests (tests/test_torch_vae*.py): each
case is a flax module and the port's module at the same widths (mnist h 16;
conv and resconv have fixed widths; z 4), built once with the flax params
loaded into the port through convert.py; and the checks each case goes
through, port against JAX with every draw made by jax.random and injected
(bs 4).

The JAX side runs jitted, each check in one compile, but for the IWAE bound.
Tolerances: loss and terms rel 1e-5; every parameter gradient rel-norm
1e-4; logprob_iwae per item |diff| <= 1e-4 nats.
"""

import functools

import jax
import numpy as np
import torch

from ardae_tpu.models.vae import api as japi
from ardae_tpu.models.vae.conv import MNISTConvVAE as JConv
from ardae_tpu.models.vae.mnist import MNISTVAE as JMnist
from ardae_tpu.models.vae.resconv import MNISTResConvVAE as JResConv
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.vae import api as tapi
from ardae_tpu_torch.models.vae.conv import MNISTConvVAE as TConv
from ardae_tpu_torch.models.vae.mnist import MNISTVAE as TMnist
from ardae_tpu_torch.models.vae.resconv import MNISTResConvVAE as TResConv
from torch_parity import close, loaded, rand, t

Z, BS = 4, 4
MODELS = {
    "mnist": lambda: (JMnist(h_dim=16, z_dim=Z, num_hidden_layers=2),
                      TMnist(h_dim=16, z_dim=Z, num_hidden_layers=2)),
    "conv": lambda: (JConv(z_dim=Z), TConv(z_dim=Z)),
    "resconv": lambda: (JResConv(z_dim=Z, do_center=False),
                        TResConv(z_dim=Z, do_center=False)),
    "resconvct": lambda: (JResConv(z_dim=Z, do_center=True),
                          TResConv(z_dim=Z, do_center=True)),
}


@functools.cache
def build(name):
    """(flax module, params, the port's module with them); built once. The
    JAX side runs jitted here: op by op, the conv models' init and gradient
    take ~10x longer on the CPU."""
    jm, tm = MODELS[name]()
    if name == "resconvct":  # resconv's parameters: the centring has none
        p = build("resconv")[1]
    else:
        p = jax.jit(jm.init)(jax.random.PRNGKey(3), _synthetic_mnist(2, seed=5)[0])
    return jm, p, loaded(tm, p)


def fresh(name, params):
    """A new port module of case ``name`` holding ``params``."""
    return loaded(MODELS[name]()[1], params)


def binary(n, seed):
    return (_synthetic_mnist(n, seed=seed)[0] > 0.5).astype(np.float32)


def check_encode_and_decode_params(name):
    jm, p, tm = build(name)
    x, z = binary(BS, 6), rand(7, 5, Z)
    # one JAX compile for both methods
    (wmu, wlv), (want,) = jax.jit(lambda p, x, z: (
        jm.apply(p, x, method=jm.encode_params),
        jm.apply(p, z, method=jm.decode_params)))(p, x, z)
    with torch.no_grad():
        mu, lv = tm.encode_params(t(x))
        (got,) = tm.decode_params(t(z))
    close(mu, wmu, 1e-4, 1e-5)
    close(lv, wlv, 1e-4, 1e-5)
    assert got.shape == (5, 784)
    close(got, want, 1e-4, 1e-5)


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def check_vae_loss_and_gradients(name):
    jm, p, tm = build(name)
    x, key = binary(BS, 8), jax.random.PRNGKey(9)

    def jloss(params):
        # the per-item loss at beta 1 rides along as aux: one JAX compile
        loss, terms = japi.vae_loss(jm, params, key, x, beta=0.7)
        return loss, (terms, japi.vae_loss(jm, params, key, x, reduce="per_item")[0])

    (want, (wterms, per_item)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(p)
    eps = t(jax.random.normal(key, (BS, Z)))  # the draw sample_gaussian makes
    tm.zero_grad(set_to_none=True)
    got, terms = tapi.vae_loss(tm, t(x), beta=0.7, eps=eps)
    got.backward()
    close(got, want, 1e-5, 0.0)
    for k in ("recon", "kld"):
        close(terms[k], wterms[k], 1e-5, 1e-6, msg=k)
    close(terms["z"], wterms["z"], 1e-4, 1e-5)
    want_g = flax_to_state_dict(jgrads, tm)
    for k, prm in tm.named_parameters():
        err = _rel_norm(prm.grad, want_g[k])
        assert err <= 1e-4, (k, err)
    close(tapi.vae_loss(tm, t(x), reduce="per_item", eps=eps)[0].detach(),
          per_item, 1e-5, 0.0)


def check_logprob_iwae_per_item(name):
    jm, p, tm = build(name)
    x, key, ssz = binary(3, 10), jax.random.PRNGKey(11), 16
    # op by op, as the JAX package's own tests run it: XLA's fusion of the
    # jitted bound sums the 784 pixel terms in another order
    want = japi.logprob_iwae(jm, p, key, x, ssz, reduce="per_item")
    with torch.no_grad():
        got = tapi.logprob_iwae(tm, t(x), ssz, reduce="per_item",
                                eps=t(jax.random.normal(key, (3, ssz, Z))))
    assert got.shape == (3,) and bool(torch.isfinite(got).all())
    close(got, want, 0.0, 1e-4)
