"""The hierarchical-aux slice's training steps, port against JAX: one phase-A
``cdae_update`` and one phase-B ``model_update`` with the ``hidden1a``
context (ardae_tpu/train/step.py cdae_update / model_update) for
auxresconvct + mlp-res (c_dim 32, std-scale 100) and auxmnist + mlp-grad (h
16, so a 32-wide context; std-scale 10000 as its line, and 100), and one
step of the aux baseline (auxmnist) against JAX's aux_vae_loss and
optimizer; plus
compute_context's hidden1a branch. Small widths: z 8, noise 10, cdae h 32
with 2 layers, bs 4, nz_cdae 8.

Phase A runs with --use-kernels: on CPU tensors the fused op of the cdae's
style runs its plain version, and the JAX step runs cdae_loss. Every draw
is made by jax.random from the keys the JAX functions split (cdae_update:
k_lat, k_std, k_noise; the aux sampler splits k_lat into eps0, eps;
model_update: k_fwd; aux_vae_loss: k0, k1) and injected. The optimizers are
wrapped on both sides to record the gradients they are handed.

Tolerances: the loss and metrics rel 1e-5; every gradient ||port - JAX|| /
||JAX|| <= 1e-4 (1e-3 for phase A at std-scale 10000, below); parameters
after one update: each element within 0.25 x the largest move one update
can make where the gradient's sign is set
(|g| > 2e-3 x its tensor's largest), 2 x that move elsewhere (Adam's and
RMSprop's first step is ~lr x sign(g), which flips where g is within the
two frameworks' rounding).
"""

import jax
import numpy as np
import pytest
import torch

from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.models.cdae import MLPResCARDAE as JRes
from ardae_tpu.models.ivae import aux as jaux
from ardae_tpu.models.vae import aux as jvaux
from ardae_tpu.train import optim as jopt
from ardae_tpu.train import step as jstep
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE as TGrad
from ardae_tpu_torch.models.cdae.cardae import MLPResCARDAE as TRes
from ardae_tpu_torch.models.ivae import api as tiapi
from ardae_tpu_torch.models.ivae import aux as taux
from ardae_tpu_torch.models.registry import build_ivae_model
from ardae_tpu_torch.models.vae import aux as tvaux
from ardae_tpu_torch.ops.fused_dsm import FusedDSMFunction
from ardae_tpu_torch.ops.fused_dsm_grad import FusedDSMGradFunction
from ardae_tpu_torch.train import optim as topt
from ardae_tpu_torch.train.state import create_train_state
from ardae_tpu_torch.train.step import StepConfig, cdae_update, compute_context, model_update
from ardae_tpu_torch.train.vae_step import VAEStepConfig, vae_step
from test_torch_step import _recording, _Recording
from torch_parity import close, init, loaded, t

Z, NOISE, H_D, L_D, BS, NZ, D_LR, M_LR = 8, 10, 32, 2, 4, 8, 1e-4, 1e-3
LINES = {
    # name: (flax model, port model, cdae style, std-scale, optimizer momentum)
    "auxresconvct": (
        jaux.MNISTResConvAuxIPVAE(z0_dim=NOISE, z_dim=Z, c_dim=32, do_center=True),
        taux.MNISTResConvAuxIPVAE(z0_dim=NOISE, z_dim=Z, c_dim=32, do_center=True),
        "res", 100.0, 0.9),
    "auxmnist": (
        jaux.MNISTAuxIPVAE(noise_dim=NOISE, h_dim=16, z_dim=Z, num_hidden_layers=2),
        taux.MNISTAuxIPVAE(noise_dim=NOISE, h_dim=16, z_dim=Z, num_hidden_layers=2),
        "grad", 10000.0, 0.5),
}
CTX = 32  # hidden1a: auxresconvct's c_dim, 2 x auxmnist's h


def _x(n, seed):
    return (_synthetic_mnist(n, seed=seed)[0] > 0.5).astype(np.float32)


def _build(name):
    """Both sides of one line: JAX modules, params and recording
    optimizers (RMSprop on the cdae, Adam on the model), the port's with
    the same parameters."""
    jm, tm, style, ssc, mom = LINES[name]
    jd_cls, td_cls = (JRes, TRes) if style == "res" else (JGrad, TGrad)
    jd = jd_cls(input_dim=Z, context_dim=CTX, h_dim=H_D, num_hidden_layers=L_D,
                nonlinearity="softplus")
    pair = (np.zeros((BS, NOISE), np.float32), np.zeros((BS, Z), np.float32))
    pm = init(jm, _x(BS, 3), pair, seed=1)
    pd = init(jd, np.zeros((4, Z), np.float32), np.zeros((4, CTX), np.float32),
              np.zeros((4, 1), np.float32), seed=2)
    j_opts = (_recording(jopt.build_optimizer("adam", M_LR, beta1=mom)),
              _recording(jopt.build_optimizer("rmsprop", D_LR, momentum=mom)))
    tm = loaded(tm, pm)
    td = loaded(td_cls(Z, CTX, H_D, L_D, "softplus"), pd)
    t_opts = (_Recording(topt.build_optimizer("adam", tm.parameters(), M_LR,
                                              beta1=mom), tm),
              _Recording(topt.build_optimizer("rmsprop", td.parameters(), D_LR,
                                              momentum=mom), td))
    cfg = dict(std_scale=ssc, delta=0.1, num_cdae_updates=1, train_nz_cdae=NZ,
               train_nz_model=1, ctx_type="hidden1a")
    return (jm, jd, pm, pd, j_opts), (tm, td, t_opts), cfg


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _compare_update(jparams, jgrads, recorded, module, before, move,
                    grad_rel=1e-4):
    """Every gradient to ``grad_rel`` rel-norm; the parameters after the
    update."""
    want_g = flax_to_state_dict(jgrads, module)
    want_p = flax_to_state_dict(jparams, module)
    for k, v in module.state_dict().items():
        assert _rel_norm(recorded[k], want_g[k]) <= grad_rel, k
        sure = want_g[k].abs() > 2e-3 * float(want_g[k].abs().max())
        close(v[sure], want_p[k][sure], 0.0, 0.25 * move, msg=k)
        close(v, want_p[k], 0.0, 2.0 * move + 1e-7, msg=k)


@pytest.mark.parametrize("name,std_scale,grad_rel", [
    ("auxresconvct", None, 1e-4), ("auxmnist", 100.0, 1e-4),
    ("auxmnist", None, 1e-3)])
def test_cdae_update_with_hidden1a_matches_jax(name, std_scale, grad_rel):
    """At auxresconvct's std-scale 100, and auxmnist at 100 and at its
    line's 10000. There the grad-style loss's first layer sees inputs of
    ~1e3, whose fp32 rounding (~1e-4 absolute in the pre-activations)
    moves the softplus tails' second derivatives by ~1e-4 relative in any
    fp32 implementation: the gradients are held to 1e-3, the bound of the
    implicit-conv step at the same scale (tests/test_torch_step.py;
    measured 2.6e-4)."""
    (jm, jd, pm, pd, (_, opt_d)), (tm, td, (_, tod)), cfg = _build(name)
    if std_scale is not None:
        cfg["std_scale"] = std_scale
    x, key = _x(BS, 4), jax.random.PRNGKey(5)
    jcfg = jstep.StepConfig(**cfg)
    pd2, od2, jmet = jax.jit(lambda pm, pd, o: jstep.cdae_update(
        jm, jd, opt_d, jcfg, pm, pd, o, key, x))(pm, pd, opt_d.init(pd))
    k_lat, k_std, k_noise = jax.random.split(key, 3)
    k0, k1 = jax.random.split(k_lat)
    draws = {"latent_eps": (t(jax.random.normal(k0, (BS * NZ, NOISE))),
                            t(jax.random.normal(k1, (BS * NZ, Z)))),
             "std": t(jax.random.normal(k_std, (BS, NZ, 1))),
             "dsm_eps": t(jax.random.normal(k_noise, (BS * NZ, Z)))}
    fn = FusedDSMFunction if LINES[name][2] == "res" else FusedDSMGradFunction
    launches = dict(fn.launches)
    before = {k: v.clone() for k, v in td.state_dict().items()}
    tmet = cdae_update(tm, td, tod, StepConfig(**cfg, use_kernels=True), t(x),
                       None, draws)
    assert fn.launches == launches  # CPU tensors: the plain version
    for k, v in jmet.items():
        close(tmet[k], v, 1e-5, 0.0, msg=k)
    _compare_update(pd2, od2[1], tod.last, td, before, 10 * D_LR, grad_rel)


@pytest.mark.parametrize("name", list(LINES))
def test_model_update_with_hidden1a_matches_jax(name):
    """Phase B: the score of the cdae at the hidden1a context of the
    current, detached model."""
    (jm, jd, pm, pd, (opt_m, _)), (tm, td, (tom, _)), cfg = _build(name)
    x, key = _x(BS, 6), jax.random.PRNGKey(7)
    jcfg = jstep.StepConfig(**cfg)
    pm2, om2, jmet = jax.jit(lambda pm, pd, o: jstep.model_update(
        jm, jd, opt_m, jcfg, pd, pm, o, key, x, 0.7))(pm, pd, opt_m.init(pm))
    k_fwd, _ = jax.random.split(key)
    k0, k1 = jax.random.split(k_fwd)
    eps = (t(jax.random.normal(k0, (BS, NOISE))), t(jax.random.normal(k1, (BS, Z))))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tmet = model_update(tm, td, tom, StepConfig(**cfg), t(x), 0.7, None,
                        {"eps": eps})
    for k, v in jmet.items():
        close(tmet[k], v, 1e-5, 0.0, msg=k)
    _compare_update(pm2, om2[1], tom.last, tm, before, M_LR)


def test_aux_vae_step_matches_jax():
    """One step of the auxmnist baseline: the loss scaled by 1/784 (the
    driver's), its gradients and the Adam update against JAX's
    aux_vae_loss with the key the JAX driver folds in (cli/vae.py)."""
    jm = jvaux.MNISTAuxVAE(noise_dim=NOISE, h_dim=16, z_dim=Z, num_hidden_layers=2,
                           do_xavier=False)
    p = init(jm, _x(2, 3), seed=1)
    tx = _recording(jopt.build_optimizer("adam", M_LR, beta1=0.5))
    x, key, scale, beta = _x(BS, 8), jax.random.PRNGKey(9), 1.0 / 784, 0.5

    def loss_fn(q):
        loss, terms = jvaux.aux_vae_loss(jm, q, key, x, beta=beta)
        return scale * loss, terms

    (jloss, terms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p)
    updates, ostate = tx.update(grads, tx.init(p), p)
    p2 = jax.tree.map(lambda a, u: a + u, p, updates)

    tm = loaded(tvaux.MNISTAuxVAE(noise_dim=NOISE, h_dim=16, z_dim=Z,
                                  num_hidden_layers=2), p)
    opt = _Recording(topt.build_optimizer("adam", tm.parameters(), M_LR,
                                          beta1=0.5), tm)
    state = create_train_state(tm, opt)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    k0, k1 = jax.random.split(key)
    eps = (t(jax.random.normal(k0, (BS, NOISE))), t(jax.random.normal(k1, (BS, Z))))
    met = vae_step(state, VAEStepConfig(loss_scale=scale), t(x), beta, None, eps)
    close(met["loss"], jloss, 1e-5, 0.0)
    close(met["recon_loss"], terms["recon"], 1e-5, 0.0)
    close(met["kld_loss"], terms["kld"], 1e-5, 1e-6)
    close(met["elbo"], -(terms["recon"] + terms["kld"]), 1e-5, 0.0)
    assert state.step == 1
    _compare_update(p2, ostate[1], opt.last, tm, before, M_LR)


def test_compute_context_hidden1a():
    """compute_context's hidden1a branch is the std-0 features, detached;
    a flat model and an unknown context type raise."""
    tm = build_ivae_model("auxconv", nchannels=1, nheight=28, z_dim=Z, n_dim=NOISE,
                          nonlin="softplus", seed=3, device="cpu")
    x = torch.as_tensor(_x(3, 10))
    ctx = compute_context(tm, x, "hidden1a")
    assert tuple(ctx.shape) == (3, 1600) and not ctx.requires_grad
    assert torch.equal(ctx, tiapi.encode_hidden_feats(tm, x).detach())
    flat = build_ivae_model("mnist-conv", nchannels=1, nheight=28, z_dim=Z,
                            n_dim=NOISE, nonlin="softplus", device="cpu")
    with pytest.raises(NotImplementedError, match="aux model"):
        compute_context(flat, x, "hidden1a")
    with pytest.raises(NotImplementedError, match="hidden2"):
        compute_context(tm, x, "hidden2")
