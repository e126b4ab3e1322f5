"""bf16 mixed precision of the joint step, against the JAX package's
(ardae_tpu/train/step.py with ``cdae_compute_dtype`` /
``model_compute_dtype`` "bfloat16"): ``_sigma_stats`` (the sampling pass
on bf16 parameters, the statistics in fp32), one phase-A ``cdae_update``
and one phase-B ``model_update`` for the flagship line (resconvct-res +
mlp-res, lt0), the implicit-conv line (mnist-conv + mlp-grad, lt0, a bf16
double backward) and an aux line with the hidden1a context (auxmnist +
mlp-grad), and the ``--use-kernels`` rules: a bf16 phase A refuses the
kernels, naming the JAX step's lines that keep its fused kernel fp32; a
bf16 phase B keeps them. Small widths: z 8, noise 10, model h 16-32, cdae
h 32 with 2 layers, bs 4, nz_cdae 8. Every draw is made by jax.random
from the keys the JAX functions split and injected.

Tolerances (tests/test_torch_bf16.py gives the reasons): losses and
sigma statistics 2e-2 relative; at std-scale 1 the sigma pass's
encodings z and z_det a relative norm of 2e-2, and lsm = z - z_det, which
cancels most of z, to 2e-2 of ||z||; every gradient handed to the
optimizer within 5e-2 of JAX's bf16 one plus twice the distance between
JAX's bf16 and fp32 gradients. The parameters are not compared after the
update: the first Adam / RMSprop step is ~lr x sign(g), which bf16 flips
wherever g is within its rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.models.cdae import MLPResCARDAE as JRes
from ardae_tpu.models.ivae import api as jiapi
from ardae_tpu.models.ivae import aux as jaux
from ardae_tpu.models.ivae.conv import ConvIPVAE as JConv
from ardae_tpu.models.ivae.resconv import ResConvIPVAE as JResConv
from ardae_tpu.train import optim as jopt
from ardae_tpu.train import step as jstep
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE as TGrad
from ardae_tpu_torch.models.cdae.cardae import MLPResCARDAE as TRes
from ardae_tpu_torch.models.ivae import aux as taux
from ardae_tpu_torch.models.ivae.conv import ConvIPVAE as TConv
from ardae_tpu_torch.models.ivae.resconv import ResConvIPVAE as TResConv
from ardae_tpu_torch.ops.fused_dsm import FusedDSMFunction
from ardae_tpu_torch.ops.fused_dsm_grad import FusedDSMGradFunction
from ardae_tpu_torch.train import optim as topt
from ardae_tpu_torch.train.step import StepConfig, _sigma_stats, cdae_update, model_update
from test_torch_step import _recording, _Recording
from torch_parity import init, loaded, t

BF = "bfloat16"
REL, GRAD_REL = 2e-2, 5e-2
Z, NOISE, H_D, L_D, BS, NZ, D_LR, M_LR = 8, 10, 32, 2, 4, 8, 1e-4, 1e-3
LINES = {
    # name: (flax model, port model, cdae style, context, its width,
    #        std-scale of the line, optimizer momentum)
    "flagship": (
        lambda: JResConv(z_dim=Z, noise_dim=NOISE, h_dim=32, num_hidden_layers=1,
                         nonlinearity="elu", do_center=True, enc_type="res-wn-mlp"),
        lambda: TResConv(z_dim=Z, noise_dim=NOISE, h_dim=32, num_hidden_layers=1,
                         nonlinearity="elu", do_center=True),
        "res", "lt0", Z, 100.0, 0.9),
    "implicit-conv": (lambda: JConv(z_dim=Z, noise_dim=NOISE),
                      lambda: TConv(z_dim=Z, noise_dim=NOISE),
                      "grad", "lt0", Z, 10000.0, 0.5),
    "auxmnist": (
        lambda: jaux.MNISTAuxIPVAE(noise_dim=NOISE, h_dim=16, z_dim=Z,
                                   num_hidden_layers=2),
        lambda: taux.MNISTAuxIPVAE(noise_dim=NOISE, h_dim=16, z_dim=Z,
                                   num_hidden_layers=2),
        "grad", "hidden1a", 32, 10000.0, 0.5),
}


def _x(n, seed):
    return (_synthetic_mnist(n, seed=seed)[0] > 0.5).astype(np.float32)


def _noise(jm, n):
    zeros = np.zeros((n, NOISE), np.float32)
    return (zeros, np.zeros((n, Z), np.float32)) if jm.family == "aux" else zeros


@functools.cache
def _jax_params(name):
    jmf, _, style, _, ctx_dim, _, _ = LINES[name]
    jm = jmf()
    jd = (JRes if style == "res" else JGrad)(
        input_dim=Z, context_dim=ctx_dim, h_dim=H_D, num_hidden_layers=L_D,
        nonlinearity="softplus")
    pm = jax.jit(jm.init)(jax.random.PRNGKey(1), _x(2, 3), _noise(jm, 2))
    pd = init(jd, np.zeros((4, Z), np.float32), np.zeros((4, ctx_dim), np.float32),
              np.zeros((4, 1), np.float32), seed=2)
    return jm, jd, pm, pd


def _build(name, std_scale=None, **dtypes):
    """Both sides of a line: JAX modules, params, recording optimizers and
    config dict; the port's modules with the same parameters, recording
    optimizers and StepConfig."""
    _, tmf, style, ctx, ctx_dim, ssc, mom = LINES[name]
    jm, jd, pm, pd = _jax_params(name)
    j_opts = (_recording(jopt.build_optimizer("adam", M_LR, beta1=mom)),
              _recording(jopt.build_optimizer("rmsprop", D_LR, momentum=mom)))
    tm = loaded(tmf(), pm)
    td = loaded((TRes if style == "res" else TGrad)(Z, ctx_dim, H_D, L_D,
                                                    "softplus"), pd)
    t_opts = (_Recording(topt.build_optimizer("adam", tm.parameters(), M_LR,
                                              beta1=mom), tm),
              _Recording(topt.build_optimizer("rmsprop", td.parameters(), D_LR,
                                              momentum=mom), td))
    cfg = dict(std_scale=ssc if std_scale is None else std_scale, delta=0.1,
               num_cdae_updates=1, train_nz_cdae=NZ, train_nz_model=1,
               ctx_type=ctx, **dtypes)
    return (jm, jd, pm, pd, j_opts), (tm, td, t_opts), cfg


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _eps(jm, key, nz):
    """The encoder noise sample_latents draws from ``key`` for BS items."""
    eps = jiapi.make_eps(jm, key, BS, nz)
    return tuple(t(e) for e in eps) if jm.family == "aux" else t(eps)


def _check_recorded(jgrads, jgrads32, recorded, module):
    """The gradients handed to the optimizer: fp32, within the bound of the
    module docstring."""
    want = flax_to_state_dict(jgrads, module)
    want32 = flax_to_state_dict(jgrads32, module)
    for k, prm in module.named_parameters():
        g = recorded[k]
        assert prm.dtype == g.dtype == torch.float32, k
        err = float((g - want[k]).norm())
        bound = (GRAD_REL * float(want[k].norm())
                 + 2.0 * float((want[k] - want32[k]).norm()))
        assert err <= bound, (k, err, bound)


@pytest.mark.parametrize("name", ["flagship", "implicit-conv", "auxmnist"])
def test_sigma_stats_bf16_matches_jax(name):
    """The nz-wide sampling pass on bf16 parameters and input, sigma
    reduced in fp32: at std-scale 1 the std-0 encoding (fp32: JAX's fp32
    zeros promote it), lsm and sigma against JAX's; at the line's own
    scale (100 or 10000) sigma is finite, positive and JAX's."""
    jm, _, pm, _ = _jax_params(name)
    x, key = _x(BS, 4), jax.random.PRNGKey(5)
    tm = loaded(LINES[name][1](), pm)
    for ssc in (1.0, LINES[name][5]):
        cfg = dict(std_scale=ssc, delta=0.1, train_nz_cdae=NZ, ctx_type="lt0")
        lsm, sigma, mean, _, x_c = jax.jit(lambda p: jstep._sigma_stats(
            jm, p, key, jnp.asarray(x), jstep.StepConfig(
                **cfg, cdae_compute_dtype=BF)))(pm)
        assert str(x_c.dtype) == BF and str(mean.dtype) == "float32"
        got = _sigma_stats(tm, t(x), StepConfig(**cfg, cdae_compute_dtype=BF),
                           None, _eps(jm, key, NZ))
        assert got[4].dtype == torch.bfloat16
        assert all(v.dtype == torch.float32 for v in got[:3])
        sig = got[1]
        assert bool(torch.isfinite(sig).all()) and float(sig.min()) > 0.0
        assert _rel_norm(sig, t(sigma)) <= REL, ssc
        if ssc == 1.0:
            # lsm = z - z_det cancels most of z: its error is z's rounding
            latent = t(lsm) + t(mean)
            assert _rel_norm(got[2], t(mean)) <= REL
            assert _rel_norm(got[0] + got[2], latent) <= REL
            assert float((got[0] - t(lsm)).norm()) <= REL * float(latent.norm())


@pytest.mark.parametrize("name", list(LINES))
def test_cdae_update_bf16_matches_jax(name):
    """Phase A with cdae_compute_dtype bf16 (the plain score net; a bf16
    double backward for mlp-grad; the hidden1a context from the sigma
    pass's bf16 parameters) against JAX's cdae_update."""
    (jm, jd, pm, pd, (_, opt_d)), (tm, td, (_, tod)), cfg = _build(
        name, cdae_compute_dtype=BF)
    x, key = _x(BS, 4), jax.random.PRNGKey(5)

    def jrun(cd):
        jcfg = jstep.StepConfig(**dict(cfg, cdae_compute_dtype=cd))
        return jax.jit(lambda pm, pd, o: jstep.cdae_update(
            jm, jd, opt_d, jcfg, pm, pd, o, key, jnp.asarray(x)))(
            pm, pd, opt_d.init(pd))

    (_, od2, jmet), (_, od32, _) = jrun(BF), jrun("float32")
    k_lat, k_std, k_noise = jax.random.split(key, 3)
    draws = {"latent_eps": _eps(jm, k_lat, NZ),
             "std": t(jax.random.normal(k_std, (BS, NZ, 1))),
             "dsm_eps": t(jax.random.normal(k_noise, (BS * NZ, Z)))}
    tmet = cdae_update(tm, td, tod, StepConfig(**cfg), t(x), None, draws)
    for k, v in jmet.items():
        assert tmet[k].dtype == torch.float32, k
        assert abs(float(tmet[k]) / float(v) - 1.0) <= REL, k
    _check_recorded(od2[1], od32[1], tod.last, td)


@pytest.mark.parametrize("name", list(LINES))
def test_model_update_bf16_matches_jax(name):
    """Phase B with model_compute_dtype bf16: the model loss on bf16
    parameters, the detached context and latent mean in bf16 then fp32,
    the cdae's score in fp32, against JAX's model_update."""
    (jm, jd, pm, pd, (opt_m, _)), (tm, td, (tom, _)), cfg = _build(
        name, model_compute_dtype=BF)
    x, key = _x(BS, 6), jax.random.PRNGKey(7)

    def jrun(cd):
        jcfg = jstep.StepConfig(**dict(cfg, model_compute_dtype=cd))
        return jax.jit(lambda pm, pd, o: jstep.model_update(
            jm, jd, opt_m, jcfg, pd, pm, o, key, jnp.asarray(x), 0.7))(
            pm, pd, opt_m.init(pm))

    (_, om2, jmet), (_, om32, _) = jrun(BF), jrun("float32")
    k_fwd, _ = jax.random.split(key)
    tmet = model_update(tm, td, tom, StepConfig(**cfg), t(x), 0.7, None,
                        {"eps": _eps(jm, k_fwd, 1)})
    for k, v in jmet.items():
        assert tmet[k].dtype == torch.float32, k
        assert abs(float(tmet[k]) / float(v) - 1.0) <= REL, k
    _check_recorded(om2[1], om32[1], tom.last, tm)


@pytest.mark.parametrize("name", ["flagship", "implicit-conv"])
def test_use_kernels_refuses_a_bf16_phase_a(name):
    """The fused kernels are fp32 only, and JAX never dispatches its fused
    kernel in a bf16 phase A: the port raises, naming those lines, where
    JAX falls back to XLA; nothing is launched or updated."""
    _, (tm, td, (_, tod)), cfg = _build(name, cdae_compute_dtype=BF)
    before = {k: v.clone() for k, v in td.state_dict().items()}
    with pytest.raises(NotImplementedError,
                       match=r"bf16 phase A.*ardae_tpu/train/step\.py:186-192"):
        cdae_update(tm, td, tod, StepConfig(**cfg, use_kernels=True),
                    t(_x(BS, 4)), torch.Generator().manual_seed(0))
    assert all(torch.equal(v, before[k]) for k, v in td.state_dict().items())


@pytest.mark.parametrize("name", ["flagship", "implicit-conv"])
def test_use_kernels_with_a_bf16_phase_b_runs_phase_a_fused(name):
    """--model-compute-dtype bfloat16 --use-kernels: phase A takes the
    fused op of the cdae's style (on CPU tensors its plain version, no
    launch), phase B runs in bf16; both steps' metrics finite."""
    _, (tm, td, (tom, tod)), cfg = _build(name, model_compute_dtype=BF)
    fn = FusedDSMFunction if LINES[name][2] == "res" else FusedDSMGradFunction
    launches = dict(fn.launches)
    gen = torch.Generator().manual_seed(0)
    scfg = StepConfig(**cfg, use_kernels=True)
    met = cdae_update(tm, td, tod, scfg, t(_x(BS, 4)), gen)
    met.update(model_update(tm, td, tom, scfg, t(_x(BS, 6)), 1.0, gen))
    assert fn.launches == launches
    assert all(bool(torch.isfinite(v)) for v in met.values())
    assert tod.last is not None and tom.last is not None
