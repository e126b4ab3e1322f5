"""The non-Gaussian DSM noise of the port against its JAX twin: Laplace
noise (core/rng.py ``sample_laplace``: its moments, and JAX's draw from the
same uniforms), ``cdae_loss`` with Laplace and uniform noise in both cdae
styles (x_bar = x + sigma*eps, or x + 2 sigma u - sigma with the loss
target u), ``dae_loss`` with Laplace noise (tests/test_torch_examples.py
holds the unconditional constructors and the uniform refusal),
``cdae_update`` with ``StepConfig(noise_type=...)`` against JAX's
``cdae_update`` (mnist-concat at a small width, ctx lt0, with and without
--use-kernels), and the two kernel wrappers' plain versions, which the
card replaces by the kernels, with each noise. Every draw is made by
jax.random from the keys the JAX code splits and injected; flax params
cross through convert.py. Tolerances: losses rel 1e-5, gradients rel-norm
1e-4 (tests/test_torch_cardae.py's bounds); the step's metrics rel 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ardae_tpu.core.rng import sample_laplace as j_laplace
from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.models.cdae import MLPResCARDAE as JRes
from ardae_tpu.models.cdae import cardae as jcd
from ardae_tpu.models.ivae.mnist import MNISTIPVAE as JMNIST
from ardae_tpu.train import optim as jopt
from ardae_tpu.train import step as jstep
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.core.rng import sample_laplace
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.cdae import cardae as tcd
from ardae_tpu_torch.models.ivae.mnist import MNISTIPVAE as TMNIST
from ardae_tpu_torch.ops.fused_dsm import FusedDSMFunction, fused_cdae_dsm_loss
from ardae_tpu_torch.ops.fused_dsm_grad import (
    FusedDSMGradFunction,
    fused_cdae_dsm_grad_loss,
)
from ardae_tpu_torch.train import step as tstep
from torch_parity import close, init, loaded, rand, t

Z, C, H, L = 4, 6, 16, 3
STYLES = {"res": (JRes, tcd.MLPResCARDAE), "grad": (JGrad, tcd.MLPGradCARDAE)}
NOISES = ("laplace", "uniform")


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def test_sample_laplace_moments():
    """tests/test_core.py:149: mean 0, variance 2 of the unit Laplace."""
    s = sample_laplace((200_000,), generator=torch.Generator().manual_seed(2))
    assert abs(float(s.mean())) < 0.02
    assert abs(float(s.var()) - 2.0) < 0.1
    assert float(s.abs().max()) < 20.0


def test_sample_laplace_matches_jax_on_its_uniforms():
    """JAX's uniforms on [eps - 1, 1) injected give JAX's noise, loc and
    scale too."""
    key = jax.random.PRNGKey(3)
    eps = float(jnp.finfo(jnp.float32).eps)
    u = jax.random.uniform(key, (4, 50), minval=eps - 1.0, maxval=1.0)
    close(sample_laplace((4, 50), u=t(u), loc=0.5, scale=2.0),
          j_laplace(key, (4, 50), loc=0.5, scale=2.0), 1e-6, 1e-6)


def _jax_noise(noise_type, key, shape):
    """The draw cdae_loss / dae_loss makes from ``key`` (JAX
    cardae.py:212-223, :274-281)."""
    if noise_type == "laplace":
        return j_laplace(key, shape)
    if noise_type == "uniform":
        return jax.random.uniform(key, shape)
    return jax.random.normal(key, shape)


def _pair(style, nonlin="tanh"):
    jcls, tcls = STYLES[style]
    jm = jcls(input_dim=Z, context_dim=C, h_dim=H, num_hidden_layers=L,
              nonlinearity=nonlin)
    p = init(jm, np.zeros((4, Z), np.float32), np.zeros((4, C), np.float32),
             np.zeros((4, 1), np.float32), seed=3)
    return jm, p, loaded(tcls(Z, C, H, L, nonlin), p)


def _check_grads(tm, jgrads):
    want = flax_to_state_dict(jgrads, tm)
    for k, prm in tm.named_parameters():
        if prm.grad is None:   # the grad style's energy-head bias
            assert not want[k].any(), k
        else:
            assert _rel_norm(prm.grad, want[k]) <= 1e-4, k


def _inputs():
    return rand(4, 3, 7, Z), rand(5, 3, C), np.abs(rand(6, 3, 7, 1, scale=0.5))


@pytest.mark.parametrize("noise_type", NOISES)
@pytest.mark.parametrize("style", ["res", "grad"])
def test_cdae_loss_matches_jax(style, noise_type):
    jm, p, tm = _pair(style)
    latent, ctx, std = _inputs()
    key = jax.random.PRNGKey(9)
    jl, jg = jax.value_and_grad(lambda q: jcd.cdae_loss(
        jm, q, key, latent, ctx, std, noise_type))(p)
    eps = t(_jax_noise(noise_type, key, (21, Z)))
    loss = tcd.cdae_loss(tm, t(latent), t(ctx), t(std), eps=eps,
                         noise_type=noise_type)
    loss.backward()
    close(loss, jl, 1e-5, 0.0)
    _check_grads(tm, jg)


@pytest.mark.parametrize("noise_type", NOISES)
def test_kernel_wrappers_plain_path(noise_type):
    """On CPU tensors each fused wrapper runs its plain version with
    prepare_inputs' x_bar and eps: the loss and every gradient of
    cdae_loss with the same noise, and JAX's; no launch is counted."""
    latent, ctx, std = _inputs()
    key = jax.random.PRNGKey(10)
    eps = t(_jax_noise(noise_type, key, (21, Z)))
    counts = dict(FusedDSMFunction.launches), dict(FusedDSMGradFunction.launches)
    for style, wrapper in (("res", fused_cdae_dsm_loss),
                           ("grad", fused_cdae_dsm_grad_loss)):
        jm, p, tm = _pair(style, "softplus")
        jl, jg = jax.value_and_grad(lambda q: jcd.cdae_loss(
            jm, q, key, latent, ctx, std, noise_type))(p)
        loss = wrapper(tm, t(latent), t(ctx), t(std), eps=eps, noise_type=noise_type)
        loss.backward()
        close(loss, jl, 1e-5, 0.0, msg=style)
        _check_grads(tm, jg)
    assert (FusedDSMFunction.launches, FusedDSMGradFunction.launches) == counts


def test_cdae_loss_noise_draws_from_a_generator():
    """Without an injected eps the loss draws its noise from the generator:
    the same seed, the same loss; each noise a different one; an unknown
    noise raises."""
    _, _, tm = _pair("res")
    latent, ctx, std = (t(a) for a in _inputs())
    out = {}
    for nt in ("gaussian",) + NOISES:
        a, b = (float(tcd.cdae_loss(tm, latent, ctx, std, noise_type=nt,
                                    generator=torch.Generator().manual_seed(1)
                                    ).detach())
                for _ in range(2))
        assert a == b and np.isfinite(a)
        out[nt] = a
    assert len(set(out.values())) == 3
    with pytest.raises(NotImplementedError):
        tcd.cdae_loss(tm, latent, ctx, std, generator=torch.Generator(),
                      noise_type="cauchy")


def test_dae_loss_laplace_matches_jax():
    """The unconditional loss of a res-style ARDAE with Laplace noise."""
    jm = jcd.MLPResARDAE(3, h_dim=10, num_hidden_layers=2, nonlinearity="softplus")
    p = jm.init(jax.random.PRNGKey(0), np.zeros((1, 3), np.float32), None,
                np.zeros((1, 1), np.float32))
    tm = loaded(tcd.MLPResARDAE(3, h_dim=10, num_hidden_layers=2,
                                nonlinearity="softplus"), p)
    x, std = rand(2, 12, 3), rand(3, 12, 1)
    key = jax.random.PRNGKey(4)
    want, jg = jax.value_and_grad(lambda q: jcd.dae_loss(jm, q, key, x, std,
                                                         "laplace"))(p)
    got = tcd.dae_loss(tm, t(x), t(std), eps=t(j_laplace(key, x.shape)),
                       noise_type="laplace")
    got.backward()
    close(got, want, 1e-5, 0.0)
    _check_grads(tm, jg)


# ----------------------------- cdae_update ---------------------------------

BS, NZ, NOISE, ZM = 4, 8, 6, 8


def _recording(tx):
    """An optax transform whose state also keeps the last gradients."""
    def init_fn(q):
        return tx.init(q), jax.tree.map(jnp.zeros_like, q)

    def update_fn(g, s, q=None):
        u, s0 = tx.update(g, s[0], q)
        return u, (s0, g)
    return optax.GradientTransformation(init_fn, update_fn)


class _Recording:
    """The port's twin: keeps the gradients handed to ``step``."""

    def __init__(self, opt, module):
        self.opt, self.module, self.last = opt, module, None

    def zero_grad(self, set_to_none=True):
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        self.last = {k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                     for k, p in self.module.named_parameters()}
        self.opt.step()


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("style,noise_type",
                         [("res", "laplace"), ("grad", "uniform"),
                          ("grad", "laplace"), ("res", "uniform")])
def test_cdae_update_matches_jax(style, noise_type, use_kernels):
    """One phase-A update of mnist-concat's cdae (lt0 context, std-scale
    100) with the noise: the metrics and the gradient handed to RMSprop.
    Under --use-kernels the CPU runs the wrapper's plain version, as JAX
    runs cdae_loss (it never dispatches a fused kernel for such noise)."""
    from ardae_tpu_torch.train import optim as topt

    kw = dict(noise_dim=NOISE, h_dim=16, z_dim=ZM, num_hidden_layers=1)
    jm, tm = JMNIST(**kw), TMNIST(**kw)
    x = (_synthetic_mnist(BS, seed=4)[0] > 0.5).astype(np.float32)
    pm = init(jm, x, np.zeros((BS, NOISE), np.float32), seed=1)
    jcls, tcls = STYLES[style]
    jd = jcls(input_dim=ZM, context_dim=ZM, h_dim=16, num_hidden_layers=2,
              nonlinearity="softplus")
    pd = init(jd, np.zeros((4, ZM), np.float32), np.zeros((4, ZM), np.float32),
              np.zeros((4, 1), np.float32), seed=2)
    tm, td = loaded(tm, pm), loaded(tcls(ZM, ZM, 16, 2, "softplus"), pd)
    cfg = dict(std_scale=100.0, delta=0.1, train_nz_cdae=NZ, ctx_type="lt0",
               noise_type=noise_type)
    opt_d = _recording(jopt.build_optimizer("rmsprop", 1e-4, momentum=0.9))
    key = jax.random.PRNGKey(5)
    _, (_, jgrads), jmet = jstep.cdae_update(
        jm, jd, opt_d, jstep.StepConfig(**cfg), pm, pd, opt_d.init(pd), key, x)
    k_lat, k_std, k_noise = jax.random.split(key, 3)
    draws = {"latent_eps": t(jax.random.normal(k_lat, (BS * NZ, NOISE))),
             "std": t(jax.random.normal(k_std, (BS, NZ, 1))),
             "dsm_eps": t(_jax_noise(noise_type, k_noise, (BS * NZ, ZM)))}
    tod = _Recording(topt.build_optimizer("rmsprop", td.parameters(), 1e-4,
                                          momentum=0.9), td)
    tmet = tstep.cdae_update(tm, td, tod, tstep.StepConfig(**cfg,
                                                           use_kernels=use_kernels),
                             t(x), None, draws)
    for k, v in jmet.items():
        close(tmet[k], v, 1e-4, 1e-6, msg=k)
    want = flax_to_state_dict(jgrads, td)
    for k, g in tod.last.items():
        assert _rel_norm(g, want[k]) <= 1e-4, k
