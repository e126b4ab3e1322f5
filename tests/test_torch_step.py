"""The slices as a whole: the port's joint training step against JAX
build_train_step / build_train_chunk, at a small width of the flagship line
(resconvct-res, model h 32; mlp-res cdae h 32 with 2 layers; bs 4, nz_cdae 8,
2 cdae updates, ctx lt0, std-scale 100, delta 0.1; vendored Adam on the model
and RMSprop(momentum 0.9) on the cdae), and one step of the implicit-conv
line (mnist-conv, z 8, noise 10; mlp-grad cdae h 32 with 2 layers; bs 4,
nz_cdae 8, 1 cdae update, std-scale 10000; Adam(beta1 0.5) and
RMSprop(momentum 0.5)) with --use-kernels, whose phase A on the CPU runs the
grad-style op's plain version while JAX runs cdae_loss.

Every random draw is made by jax.random from the keys train/step.py derives
(fold_in / split at step.py:148, :229, :295-307, :349-358) and injected into
the port. The optimizers are wrapped on both sides to record the gradients
they are handed.

Tolerances: metrics rtol 1e-4; gradients rtol 1e-3 / atol 1e-5 relative to
each gradient's scale (std-scale 100 amplifies the entropy-gradient term);
for the implicit-conv step atol 1e-3 of the scale and a relative norm of
1e-3 per gradient: std-scale 10000 amplifies the two frameworks' fp32
rounding of z - z_det 100 times more (sigma itself differs by 8e-7
relative; measured worst gradient rel-norm 6e-4). There the first update,
~lr*sign(g), flips on elements whose gradient lies within that
disagreement, so its parameters are held elementwise (0.25 x the largest
move) where |g| > 2e-3 x the gradient's scale;
parameters after the update: the update p_after - p_before agrees as a whole
to a relative norm of 1e-2, and each element to 0.25 (one step) or 1.0 (two
steps) x the largest move one update can make (Adam's first step is
~lr*sign(g): m_lr; RMSprop's first step with momentum is ~10*d_lr per
update). Elementwise bounds are not tighter because where |g| is within a
few hundred times Adam's eps the step follows g's last digits, and a second
step can flip with g's sign (measured: one element in 262,144 0.7 of a move
apart after two steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.models.cdae import MLPResCARDAE as JRes
from ardae_tpu.models.ivae.conv import ConvIPVAE as JConvIPVAE
from ardae_tpu.models.ivae.resconv import ResConvIPVAE as JIPVAE
from ardae_tpu.train import optim as jopt
from ardae_tpu.train.state import create_train_state as j_state
from ardae_tpu.train.step import StepConfig as JCfg
from ardae_tpu.train.step import build_train_chunk, build_train_step
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE as TGrad
from ardae_tpu_torch.models.cdae.cardae import MLPResCARDAE as TRes
from ardae_tpu_torch.models.ivae.conv import ConvIPVAE as TConvIPVAE
from ardae_tpu_torch.models.ivae.resconv import ResConvIPVAE as TIPVAE
from ardae_tpu_torch.ops.fused_dsm_grad import FusedDSMGradFunction
from ardae_tpu_torch.train import optim as topt
from ardae_tpu_torch.train.state import create_train_state as t_state
from ardae_tpu_torch.train.step import StepConfig as TCfg
from ardae_tpu_torch.train.step import one_step, train_chunk
from torch_parity import close, init, loaded, t

Z, NOISE, H_M, H_D, L_D, BS, NZ, U = 8, 10, 32, 32, 2, 4, 8, 2
M_LR, D_LR = 1e-3, 1e-4
CFG = dict(std_scale=100.0, delta=0.1, num_cdae_updates=U, train_nz_cdae=NZ,
           train_nz_model=1, ctx_type="lt0")
CONV_CFG = dict(CFG, std_scale=10000.0, num_cdae_updates=1)


def _recording(tx):
    """Wrap an optax transform so its state also keeps the last gradients."""
    def init_fn(p):
        return tx.init(p), jax.tree.map(jnp.zeros_like, p)

    def update_fn(g, s, p=None):
        u, s0 = tx.update(g, s[0], p)
        return u, (s0, g)
    return optax.GradientTransformation(init_fn, update_fn)


class _Recording:
    """The port-side twin: keeps the gradients handed to ``step``."""

    def __init__(self, opt, module):
        self.opt, self.module, self.last = opt, module, None

    def zero_grad(self, set_to_none=True):
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        self.last = {k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                     for k, p in self.module.named_parameters()}
        self.opt.step()


def _build(implicit_conv=False):
    x0 = _synthetic_mnist(BS, seed=3)[0]
    if implicit_conv:
        jm, tm = JConvIPVAE(z_dim=Z, noise_dim=NOISE), TConvIPVAE(z_dim=Z, noise_dim=NOISE)
        jd = JGrad(input_dim=Z, context_dim=Z, h_dim=H_D, num_hidden_layers=L_D,
                   nonlinearity="softplus")
        td, m_lr, mom = TGrad(Z, Z, H_D, L_D, "softplus"), D_LR, 0.5
    else:
        jm = JIPVAE(z_dim=Z, noise_dim=NOISE, h_dim=H_M, num_hidden_layers=1,
                    nonlinearity="elu", do_center=True, enc_type="res-wn-mlp")
        tm = TIPVAE(z_dim=Z, noise_dim=NOISE, h_dim=H_M, num_hidden_layers=1,
                    nonlinearity="elu", do_center=True)
        jd = JRes(input_dim=Z, context_dim=Z, h_dim=H_D, num_hidden_layers=L_D,
                  nonlinearity="softplus")
        td, m_lr, mom = TRes(Z, Z, H_D, L_D, "softplus"), M_LR, 0.9
    pm = init(jm, x0, np.zeros((BS, NOISE), np.float32), seed=1)
    pd = init(jd, np.zeros((4, Z), np.float32), np.zeros((4, Z), np.float32),
              np.zeros((4, 1), np.float32), seed=2)
    opt_m = _recording(jopt.build_optimizer("adam", m_lr, beta1=mom))
    opt_d = _recording(jopt.build_optimizer("rmsprop", D_LR, momentum=mom))
    jstate = j_state(pm, opt_m, pd, opt_d)

    tm, td = loaded(tm, pm), loaded(td, pd)
    tom = _Recording(topt.build_optimizer("adam", tm.parameters(), m_lr, beta1=mom), tm)
    tod = _Recording(topt.build_optimizer("rmsprop", td.parameters(), D_LR,
                                          momentum=mom), td)
    tstate = t_state(tm, tom, td, tod)
    return (jm, jd, opt_m, opt_d, jstate), tstate


def _snapshot(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _step_draws(jm, key, step, updates=U):
    """The draws _one_step makes at ``step`` (step.py:148, :229, :295-307)."""
    k_all = jax.random.fold_in(key, step)
    cdae = []
    for i in range(updates):
        k_lat, k_std, k_noise = jax.random.split(jax.random.fold_in(k_all, i), 3)
        cdae.append({
            "latent_eps": t(jax.random.normal(k_lat, (BS * NZ, NOISE))),
            "std": t(jax.random.normal(k_std, (BS, NZ, 1))),
            "dsm_eps": t(jax.random.normal(k_noise, (BS * NZ, Z))),
        })
    k_fwd, _ = jax.random.split(jax.random.fold_in(k_all, 1000))
    return {"cdae": cdae, "model": {"eps": t(jax.random.normal(k_fwd, (BS, NOISE)))}}


def _compare_params(jparams, module, before, lr_move, frac, msg):
    want = flax_to_state_dict(jparams, module)
    err = ref = 0.0
    for k, v in module.state_dict().items():
        close(v, want[k], 0.0, frac * lr_move, msg=f"{msg} {k}")
        d_port, d_jax = v - before[k], want[k] - before[k]
        err += float(((d_port - d_jax) ** 2).sum())
        ref += float((d_jax ** 2).sum())
    assert err ** 0.5 <= 1e-2 * ref ** 0.5, msg


def _compare_grads(jgrads, recorded, module, msg, atol_frac=1e-5):
    want = flax_to_state_dict(jgrads, module)
    for k, g in recorded.items():
        scale = float(np.abs(want[k].numpy()).max()) + 1e-12
        close(g, want[k], 1e-3, atol_frac * scale, msg=f"{msg} {k}")
        assert float((g - want[k]).norm()) <= 1e-3 * float(want[k].norm()) + 1e-12, k


def _compare_params_where_sign_is_set(jparams, jgrads, module, before, lr_move):
    want = flax_to_state_dict(jparams, module)
    g = flax_to_state_dict(jgrads, module)
    for k, v in module.state_dict().items():
        sure = g[k].abs() > 2e-3 * float(g[k].abs().max())
        close(v[sure], want[k][sure], 0.0, 0.25 * lr_move, msg=k)
        close(v - before[k], want[k] - before[k], 0.0, 2.0 * lr_move + 1e-7, msg=k)


def test_joint_step_matches_jax():
    (jm, jd, opt_m, opt_d, jstate), ts = _build()
    batches = _synthetic_mnist(U * BS + BS, seed=4)[0]
    batches = (batches > 0.5).astype(np.float32)
    cdae_b, model_b = batches[: U * BS].reshape(U, BS, -1), batches[U * BS:]
    key = jax.random.PRNGKey(5)
    before_m, before_d = _snapshot(ts.model), _snapshot(ts.cdae)
    step = build_train_step(jm, jd, opt_m, opt_d, JCfg(**CFG))
    jstate2, jmet = step(jstate, cdae_b, model_b, key, 1.0)
    tmet = one_step(ts, TCfg(**CFG), t(cdae_b), t(model_b), 1.0, None,
                    _step_draws(jm, key, 0))
    for k, v in jmet.items():
        close(tmet[k], v, 1e-4, 1e-6, msg=k)
    _compare_grads(jstate2.opt_cdae[1], ts.opt_cdae.last, ts.cdae, "cdae grad")
    _compare_grads(jstate2.opt_model[1], ts.opt_model.last, ts.model, "model grad")
    _compare_params(jstate2.params_cdae, ts.cdae, before_d, 10 * D_LR * U, 0.25,
                    "cdae")
    _compare_params(jstate2.params_model, ts.model, before_m, M_LR, 0.25, "model")
    assert ts.step == 1


def test_implicit_conv_step_with_kernels_matches_jax():
    """mnist-conv + mlp-grad, --use-kernels (the grad-style op) against the
    JAX step, which runs cdae_loss."""
    (jm, jd, opt_m, opt_d, jstate), ts = _build(implicit_conv=True)
    batches = (_synthetic_mnist(2 * BS, seed=4)[0] > 0.5).astype(np.float32)
    cdae_b, model_b = batches[:BS].reshape(1, BS, -1), batches[BS:]
    key = jax.random.PRNGKey(6)
    before_m, before_d = _snapshot(ts.model), _snapshot(ts.cdae)
    step = build_train_step(jm, jd, opt_m, opt_d, JCfg(**CONV_CFG))
    jstate2, jmet = step(jstate, cdae_b, model_b, key, 1.0)
    launches = dict(FusedDSMGradFunction.launches)
    tmet = one_step(ts, TCfg(**CONV_CFG, use_kernels=True), t(cdae_b), t(model_b),
                    1.0, None, _step_draws(jm, key, 0, updates=1))
    assert FusedDSMGradFunction.launches == launches  # CPU: the plain version
    for k, v in jmet.items():
        close(tmet[k], v, 1e-4, 1e-6, msg=k)
    _compare_grads(jstate2.opt_cdae[1], ts.opt_cdae.last, ts.cdae, "cdae grad",
                   atol_frac=1e-3)
    _compare_grads(jstate2.opt_model[1], ts.opt_model.last, ts.model, "model grad",
                   atol_frac=1e-3)
    _compare_params_where_sign_is_set(jstate2.params_cdae, jstate2.opt_cdae[1],
                                      ts.cdae, before_d, 10 * D_LR)
    _compare_params_where_sign_is_set(jstate2.params_model, jstate2.opt_model[1],
                                      ts.model, before_m, D_LR)
    assert ts.step == 1


def test_chunk_with_binarization_matches_jax():
    """Two scanned steps with on-device gather and Bernoulli binarization."""
    (jm, jd, opt_m, opt_d, jstate), ts = _build()
    data = _synthetic_mnist(24, seed=6)[0]
    rng = np.random.default_rng(7)
    cidx = rng.integers(0, 24, (2, U, BS)).astype(np.int32)
    midx = rng.integers(0, 24, (2, BS)).astype(np.int32)
    key = jax.random.PRNGKey(8)
    before_m, before_d = _snapshot(ts.model), _snapshot(ts.cdae)
    chunk = build_train_chunk(jm, jd, opt_m, opt_d, JCfg(**CFG))
    jstate2, jmet = chunk(jstate, jnp.asarray(data), cidx, midx, key, 1.0,
                          binarize=True)
    draws = []
    for s in range(2):
        k = jax.random.fold_in(key, s)
        kb1, kb2 = jax.random.split(jax.random.fold_in(k, 1_000_003))
        draws.append({"bin_cdae": t(jax.random.uniform(kb1, (U, BS, 784))),
                      "bin_model": t(jax.random.uniform(kb2, (BS, 784))),
                      "step": _step_draws(jm, key, s)})
    tmet = train_chunk(ts, TCfg(**CFG), t(data), cidx, midx, None,
                       lambda step: 1.0, binarize=True, draws=draws)
    for k, v in jmet.items():
        close(tmet[k], v[-1], 1e-4, 1e-6, msg=k)
    _compare_params(jstate2.params_cdae, ts.cdae, before_d, 2 * 10 * D_LR * U,
                    1.0, "cdae")
    _compare_params(jstate2.params_model, ts.model, before_m, 2 * M_LR, 1.0,
                    "model")
    assert ts.step == 2
