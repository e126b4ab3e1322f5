"""The constructor options the port carries under the JAX twins' names and
defaults, each at one value other than its default, against the JAX twin.

One parametrised test a module family: the context linears and bilinears
(nn/linear.py), the MLPs (nn/mlp.py), the toy and MNIST models' init_mode,
the baselines' do_xavier / do_m5bias (models/vae/) and the implicit models'
do_xavier and logvar clips (models/ivae/). Each case is one option at one
value:
  * an option that changes the forward (a norm, a scale, a bias, an output
    activation, a logit shift, a clip, a head split): the flax params cross
    through convert.py (so the parameter sets must match key for key), and
    the outputs on numpy inputs and every parameter gradient of a fixed
    random projection of them must agree with JAX's, rel-norm <= 1e-5 per
    tensor (fp32 on the CPU; sums in another order);
  * an option that changes only the init (init_mode, gaussian_out_init,
    do_xavier, do_m5bias's constant bias): the port's own draws against a
    JAX init of the same widths (torch_parity.check_init_law: constants,
    such as zero or -5 biases, exactly; every other tensor's std within 5 %
    + 2 / sqrt(size) of JAX's, its mean near 0).
A last test builds each family's default model and holds its state_dict's
keys and shapes against the JAX default's, converted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ardae_tpu.models.ivae import aux as jiaux
from ardae_tpu.models.ivae.conv import ConvIPVAE as JConvIPVAE
from ardae_tpu.models.ivae.mnist import MNISTIPVAE as JMnistIPVAE
from ardae_tpu.models.ivae.toy import ToyIPVAE as JToyIPVAE
from ardae_tpu.models.vae import aux as jvaux
from ardae_tpu.models.vae.conv import MNISTConvVAE as JConvVAE
from ardae_tpu.models.vae.mnist import MNISTVAE as JMnistVAE
from ardae_tpu.models.vae.resconv import MNISTResConvVAE as JResConvVAE
from ardae_tpu.models.vae.toy import ToyVAE as JToyVAE
from ardae_tpu.nn import linear as jl
from ardae_tpu.nn import mlp as jmlp
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.ivae import aux as tiaux
from ardae_tpu_torch.models.ivae.conv import ConvIPVAE as TConvIPVAE
from ardae_tpu_torch.models.ivae.mnist import MNISTIPVAE as TMnistIPVAE
from ardae_tpu_torch.models.ivae.toy import ENC_TYPES
from ardae_tpu_torch.models.ivae.toy import ToyIPVAE as TToyIPVAE
from ardae_tpu_torch.models.vae import aux as tvaux
from ardae_tpu_torch.models.vae.conv import MNISTConvVAE as TConvVAE
from ardae_tpu_torch.models.vae.mnist import MNISTVAE as TMnistVAE
from ardae_tpu_torch.models.vae.resconv import MNISTResConvVAE as TResConvVAE
from ardae_tpu_torch.models.vae.toy import ToyVAE as TToyVAE
from ardae_tpu_torch.nn import linear as tl
from ardae_tpu_torch.nn import mlp as tmlp
from ardae_tpu_torch.nn.initializers import init_module
from torch_parity import check_init_law, grads_as_state_dict, loaded, rand, t

REL = 1e-5
KEY = jax.random.PRNGKey(3)
# the forward checks' widths: every layer's in / out / context unequal
IN, CTX, HID, OUT, BS = 6, 5, 8, 7, 4
# the init-law checks' widths: wide enough that each tensor shows its spread
W_IN, W_CTX, W_HID, W_OUT = 48, 40, 128, 64


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _rel_norm(a, b):
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    nb = float(b.norm())
    return float((a - b).norm()) / nb if nb else float(a.norm())


def check_forward(jm, tm, inputs, jcall=None, tcall=None, init_inputs=None,
                  seed=0):
    """JAX's flax params (init on ``init_inputs``, default ``inputs``)
    loaded into ``tm`` through convert.py; outputs of ``jcall`` /
    ``tcall`` (default: the modules' calls) on ``inputs`` and every
    parameter gradient of sum_i <out_i, w_i> (w_i fixed random) within REL,
    rel-norm, of JAX's."""
    jcall = jcall or (lambda q, *a: jm.apply(q, *a))
    tcall = tcall or (lambda *a: tm(*a))
    p = jax.jit(jm.init)(jax.random.PRNGKey(seed), *(init_inputs or inputs))
    loaded(tm, p)
    want = jax.jit(jcall)(p, *inputs)
    ws = [rand(100 + i, *np.shape(a)) for i, a in enumerate(_leaves(want))]

    def projection(q):
        return sum(jnp.sum(a * w) for a, w in zip(_leaves(jcall(q, *inputs)), ws))

    jgrads = jax.jit(jax.grad(projection))(p)
    tm.zero_grad(set_to_none=True)
    got = _leaves(tcall(*[t(a) for a in inputs]))
    assert len(got) == len(ws)
    for i, (a, b) in enumerate(zip(got, _leaves(want))):
        assert tuple(a.shape) == np.shape(b), i
        assert _rel_norm(a.detach(), b) <= REL, (i, _rel_norm(a.detach(), b))
    sum((a * t(w)).sum() for a, w in zip(got, ws)).backward()
    want_g = grads_as_state_dict(jgrads, tm)
    for k, prm in tm.named_parameters():
        g = prm.grad if prm.grad is not None else torch.zeros_like(prm)
        assert _rel_norm(g, want_g[k]) <= REL, (k, _rel_norm(g, want_g[k]))


def check_law(jm, tm, inputs, seed=1):
    """The port's own init of ``tm`` against a JAX init of ``jm``."""
    init_module(tm, torch.Generator().manual_seed(seed))
    p = jax.jit(jm.init)(KEY, *inputs)
    check_init_law(tm.state_dict(), flax_to_state_dict(p, tm))


def _xc(n_in, n_ctx, bs=BS, seed=1):
    return rand(seed, bs, n_in), rand(seed + 1, bs, n_ctx)


# ---- nn/linear.py: every option changes the forward -------------------------

LINEAR = {
    "ContextWeightNormalizedLinear-in_norm": (
        lambda: jl.ContextWeightNormalizedLinear(OUT, in_norm=True),
        lambda: tl.ContextWeightNormalizedLinear(IN, CTX, OUT, in_norm=True)),
    "ContextWeightNormalizedLinear-ctx_norm": (
        lambda: jl.ContextWeightNormalizedLinear(OUT, ctx_norm=False),
        lambda: tl.ContextWeightNormalizedLinear(IN, CTX, OUT, ctx_norm=False)),
    "ContextWeightNormalizedLinear-ctx_scale": (
        lambda: jl.ContextWeightNormalizedLinear(OUT, ctx_scale=0.7),
        lambda: tl.ContextWeightNormalizedLinear(IN, CTX, OUT, ctx_scale=0.7)),
    "ContextSoftPlusWeightNormalizedLinear-in_norm": (
        lambda: jl.ContextSoftPlusWeightNormalizedLinear(OUT, in_norm=True),
        lambda: tl.ContextSoftPlusWeightNormalizedLinear(IN, CTX, OUT, in_norm=True)),
    "ContextSoftPlusWeightNormalizedLinear-ctx_norm": (
        lambda: jl.ContextSoftPlusWeightNormalizedLinear(OUT, ctx_norm=False),
        lambda: tl.ContextSoftPlusWeightNormalizedLinear(IN, CTX, OUT,
                                                         ctx_norm=False)),
    "SimplifiedBilinear-use_bias": (
        lambda: jl.SimplifiedBilinear(OUT, use_bias=False),
        lambda: tl.SimplifiedBilinear(IN, CTX, OUT, use_bias=False)),
    "WeightNormalizedSimplifiedBilinear-use_bias": (
        lambda: jl.WeightNormalizedSimplifiedBilinear(OUT, use_bias=False),
        lambda: tl.WeightNormalizedSimplifiedBilinear(IN, CTX, OUT, use_bias=False)),
    "WeightNormalizedSimplifiedBilinear-in1_norm": (
        lambda: jl.WeightNormalizedSimplifiedBilinear(OUT, in1_norm=True),
        lambda: tl.WeightNormalizedSimplifiedBilinear(IN, CTX, OUT, in1_norm=True)),
    "WeightNormalizedSimplifiedBilinear-in2_norm": (
        lambda: jl.WeightNormalizedSimplifiedBilinear(OUT, in2_norm=False),
        lambda: tl.WeightNormalizedSimplifiedBilinear(IN, CTX, OUT, in2_norm=False)),
    "StackedWeightNormalizedSimplifiedBilinear-use_bias": (
        lambda: jl.StackedWeightNormalizedSimplifiedBilinear(HID, OUT, use_bias=False),
        lambda: tl.StackedWeightNormalizedSimplifiedBilinear(IN, CTX, HID, OUT,
                                                             use_bias=False)),
    "ContextResLinear-use_bias": (
        lambda: jl.ContextResLinear(OUT, use_bias=False),
        lambda: tl.ContextResLinear(IN, CTX, OUT, use_bias=False)),
    "ContextResLinear-norm": (
        lambda: jl.ContextResLinear(OUT, norm=True),
        lambda: tl.ContextResLinear(IN, CTX, OUT, norm=True)),
}


@pytest.mark.parametrize("case", list(LINEAR))
def test_linear_options(case):
    jm, tm = (make() for make in LINEAR[case])
    check_forward(jm, tm, _xc(IN, CTX))


# ---- nn/mlp.py: output activations and norms change the forward, ----------
# ---- gaussian_out_init the init -------------------------------------------

_CONTEXT_LAYER_MLPS = ("ContextScaleMLP", "ContextWNScaleMLP", "ContextSPScaleMLP",
                       "ContextSPWNScaleMLP", "ContextBilinearMLP",
                       "ContextWNBilinearMLP", "ContextSWNBilinearMLP")


def _mlp(cls, kw, wide=False):
    """(flax module, port module, inputs) of nn/mlp.py's ``cls`` with the
    option ``kw``; context MLPs take (x, ctx)."""
    n_in, n_ctx, hid, out = (W_IN, W_CTX, W_HID, W_OUT) if wide else (IN, CTX, HID, OUT)
    common = dict(nonlinearity="softplus", num_hidden_layers=2, **kw)
    jm = getattr(jmlp, cls)(hidden_dim=hid, output_dim=out, **common)
    if cls == "WNMLP":
        return jm, tmlp.WNMLP(n_in, hid, out, **common), (rand(1, BS, n_in),)
    tm = getattr(tmlp, cls)(n_in, n_ctx, hid, out, **common)
    return jm, tm, _xc(n_in, n_ctx)


MLPS = {"WNMLP-use_norm_output": ("WNMLP", {"use_norm_output": True}, "forward"),
        "ContextConcatMLP-use_nonlinearity_output": (
            "ContextConcatMLP", {"use_nonlinearity_output": True}, "forward"),
        "ContextConcatMLP-gaussian_out_init": (
            "ContextConcatMLP", {"gaussian_out_init": True}, "law"),
        "ContextResMLP-use_nonlinearity_output": (
            "ContextResMLP", {"use_nonlinearity_output": True}, "forward"),
        "ContextResMLP-use_norm": ("ContextResMLP", {"use_norm": True}, "forward"),
        "ContextResMLP-use_norm_output": (
            "ContextResMLP", {"use_norm_output": True}, "forward")}
for _cls in _CONTEXT_LAYER_MLPS:
    MLPS[f"{_cls}-use_nonlinearity_output"] = (
        _cls, {"use_nonlinearity_output": True}, "forward")
    MLPS[f"{_cls}-gaussian_out_init"] = (_cls, {"gaussian_out_init": True}, "law")


@pytest.mark.parametrize("case", list(MLPS))
def test_mlp_options(case):
    cls, kw, kind = MLPS[case]
    jm, tm, inputs = _mlp(cls, kw, wide=kind == "law")
    if kind == "forward":
        check_forward(jm, tm, inputs)
    else:
        check_law(jm, tm, inputs)


def test_gaussian_out_init_draws_the_output_layer_from_n01():
    """gaussian_out_init against the default on the port alone: the output
    layer's weight std goes from ~1/sqrt(3 * fan_in) to ~1."""
    stds = {}
    for g in (False, True):
        _, tm, _ = _mlp("ContextConcatMLP", {"gaussian_out_init": g}, wide=True)
        init_module(tm, torch.Generator().manual_seed(0))
        stds[g] = float(tm.fc.weight.detach().std())
    assert abs(stds[True] - 1.0) < 0.05 and stds[False] < 0.1


# ---- toy and MNIST models: init_mode other than "gaussian" ------------------

TOY_WIDE = dict(input_dim=64, noise_dim=32, h_dim=128, z_dim=24,
                nonlinearity="relu", num_hidden_layers=2)


def _toy_ivae(enc_type):
    kw = dict(TOY_WIDE, enc_type=enc_type, init_mode="uniform")
    x, eps = rand(1, 2, 64), rand(2, 2, 32)
    return JToyIPVAE(**kw), TToyIPVAE(**kw), (x, eps)


def _toy_vae():
    kw = dict(input_dim=64, h_dim=128, z_dim=24, num_hidden_layers=2,
              init_mode="uniform")
    return JToyVAE(**kw), TToyVAE(**kw), (rand(1, 2, 64),)


def _toy_aux_vae():
    kw = dict(input_dim=64, noise_dim=32, h_dim=128, z_dim=24, num_hidden_layers=2,
              init_mode="uniform")
    return jvaux.ToyAuxVAE(**kw), tvaux.ToyAuxVAE(**kw), (rand(1, 2, 64),)


def _toy_aux_ivae():
    kw = dict(input_dim=64, noise_dim=32, h_dim=128, z_dim=24, num_hidden_layers=2,
              init_mode="uniform")
    eps = (rand(2, 2, 32), rand(3, 2, 24))
    return jiaux.ToyAuxIPVAE(**kw), tiaux.ToyAuxIPVAE(**kw), (rand(1, 2, 64), eps)


def _mnist_ivae():
    kw = dict(noise_dim=32, h_dim=128, z_dim=24, num_hidden_layers=1,
              init_mode="uniform")
    x = _synthetic_mnist(2, seed=5)[0]
    return JMnistIPVAE(**kw), TMnistIPVAE(**kw), (x, rand(2, 2, 32))


TOY = {**{f"ToyIPVAE-{e}": (lambda e=e: _toy_ivae(e)) for e in ENC_TYPES},
       "ToyVAE": _toy_vae, "ToyAuxVAE": _toy_aux_vae, "ToyAuxIPVAE": _toy_aux_ivae,
       "MNISTIPVAE": _mnist_ivae}


@pytest.mark.parametrize("case", list(TOY))
def test_init_mode(case):
    """Any init_mode but "gaussian" leaves every layer at its default init:
    the N(0, 1) output layers and decoder means become U(+-1/sqrt(fan_in))
    in both packages."""
    check_law(*TOY[case]())


# ---- baselines: do_xavier, do_m5bias ----------------------------------------

Z = 4


def _mnist_x(n=BS, seed=6):
    return (_synthetic_mnist(n, seed=seed)[0] > 0.5).astype(np.float32)


def _vae_io(jm, tm):
    """encode_params and decode_params of a baseline, both packages."""
    x, z = _mnist_x(), rand(7, 3, tm.z_dim)
    jcall = lambda q, x, z: (jm.apply(q, x, method=jm.encode_params),
                             jm.apply(q, z, method=jm.decode_params))
    tcall = lambda x, z: (tm.encode_params(x), tm.decode_params(z))
    return (x, z), jcall, tcall


def _aux_decode_io(jm, tm):
    z = rand(7, 3, Z)
    jcall = lambda q, z: jm.apply(q, z, method=jm.decode_params)
    return (z,), jcall, lambda z: tm.decode_params(z)


def _baseline(jm, tm, kind, io=_vae_io):
    def run():
        if kind in ("forward", "both"):
            inputs, jcall, tcall = io(jm, tm)
            check_forward(jm, tm, inputs, jcall, tcall, (_mnist_x(2, 5),))
        if kind in ("law", "both"):
            check_law(jm, tm, (_mnist_x(2, 5),))
    return run


_MLP_VAE = dict(h_dim=64, z_dim=Z, num_hidden_layers=2)
_AUX_MLP = dict(noise_dim=6, h_dim=64, z_dim=Z, num_hidden_layers=2)
BASELINES = {
    "MNISTVAE-do_xavier": lambda: _baseline(
        JMnistVAE(**_MLP_VAE, do_xavier=True), TMnistVAE(**_MLP_VAE, do_xavier=True),
        "both"),
    "MNISTVAE-do_m5bias": lambda: _baseline(
        JMnistVAE(**_MLP_VAE, do_m5bias=True), TMnistVAE(**_MLP_VAE, do_m5bias=True),
        "law"),
    "MNISTConvVAE-do_xavier": lambda: _baseline(
        JConvVAE(z_dim=Z, do_xavier=True), TConvVAE(z_dim=Z, do_xavier=True), "both"),
    "MNISTConvVAE-do_m5bias": lambda: _baseline(
        JConvVAE(z_dim=Z, do_m5bias=True), TConvVAE(z_dim=Z, do_m5bias=True),
        "forward"),
    "MNISTResConvVAE-do_m5bias": lambda: _baseline(
        JResConvVAE(z_dim=Z, do_m5bias=True), TResConvVAE(z_dim=Z, do_m5bias=True),
        "forward"),
    "MNISTAuxVAE-do_xavier": lambda: _baseline(
        jvaux.MNISTAuxVAE(**_AUX_MLP, do_xavier=True),
        tvaux.MNISTAuxVAE(**_AUX_MLP, do_xavier=True), "law"),
    "ToyAuxVAE-do_xavier": lambda: _baseline(
        jvaux.ToyAuxVAE(input_dim=784, **_AUX_MLP, do_xavier=True),
        tvaux.ToyAuxVAE(input_dim=784, **_AUX_MLP, do_xavier=True), "law"),
    "MNISTConvAuxVAE-do_xavier": lambda: _baseline(
        jvaux.MNISTConvAuxVAE(z0_dim=6, z_dim=Z, do_xavier=False),
        tvaux.MNISTConvAuxVAE(z0_dim=6, z_dim=Z, do_xavier=False), "law"),
    "MNISTConvAuxVAE-do_m5bias": lambda: _baseline(
        jvaux.MNISTConvAuxVAE(z0_dim=6, z_dim=Z, do_m5bias=True),
        tvaux.MNISTConvAuxVAE(z0_dim=6, z_dim=Z, do_m5bias=True), "forward",
        io=_aux_decode_io),
}


@pytest.mark.parametrize("case", list(BASELINES))
def test_baseline_options(case):
    BASELINES[case]()()


def test_m5bias_constants():
    """do_m5bias's own constants on the port alone: the MLP baseline's
    logit bias starts at -5; the conv and resconv decoders shift their
    logits by -5 and -3 against the same weights without the option."""
    tm = init_module(TMnistVAE(**_MLP_VAE, do_m5bias=True),
                     torch.Generator().manual_seed(0))
    assert torch.equal(tm.dec_logit.bias, torch.full((784,), -5.0))
    z = t(rand(7, 3, Z))
    for cls, shift in ((TConvVAE, 5.0), (TResConvVAE, 3.0)):
        plain = init_module(cls(z_dim=Z), torch.Generator().manual_seed(0))
        shifted = cls(z_dim=Z, do_m5bias=True)
        shifted.load_state_dict(plain.state_dict())
        with torch.no_grad():
            (a,), (b,) = plain.decode_params(z), shifted.decode_params(z)
        torch.testing.assert_close(b, a - shift, rtol=0, atol=1e-5)


# ---- implicit models: do_xavier, the MLP aux models' logvar clips ------------

def _pair(n, seed, noise=6, z=Z):
    return rand(seed, n, noise), rand(seed + 1, n, z)


def _ivae_law(jm, tm, inputs):
    return lambda: check_law(jm, tm, inputs)


def _clip_forward(jm, tm, x):
    eps = _pair(BS * 3, 9)
    jcall = lambda q, x, e0, e1: jm.apply(q, x, (e0, e1), method=jm.sample_z)
    tcall = lambda x, e0, e1: tm.sample_z(x, (e0, e1))
    return lambda: check_forward(jm, tm, (x, *eps), jcall, tcall, (x, eps))


_CLIPS = dict(clip_z0_logvar="spm4", clip_z_logvar="2tanh")
IMPLICIT = {
    "ConvIPVAE-do_xavier": lambda: _ivae_law(
        JConvIPVAE(z_dim=Z, noise_dim=6, do_xavier=False),
        TConvIPVAE(z_dim=Z, noise_dim=6, do_xavier=False),
        (_mnist_x(2, 5), rand(2, 2, 6))),
    "MNISTAuxIPVAE-do_xavier": lambda: _ivae_law(
        jiaux.MNISTAuxIPVAE(**_AUX_MLP, do_xavier=False),
        tiaux.MNISTAuxIPVAE(**_AUX_MLP, do_xavier=False),
        (_mnist_x(2, 5), _pair(2, 4))),
    "MNISTConvAuxIPVAE-do_xavier": lambda: _ivae_law(
        jiaux.MNISTConvAuxIPVAE(z0_dim=6, z_dim=Z, do_xavier=False),
        tiaux.MNISTConvAuxIPVAE(z0_dim=6, z_dim=Z, do_xavier=False),
        (_mnist_x(2, 5), _pair(2, 4))),
    "ToyAuxIPVAE-clip_logvar": lambda: _clip_forward(
        jiaux.ToyAuxIPVAE(input_dim=2, **_AUX_MLP, **_CLIPS),
        tiaux.ToyAuxIPVAE(input_dim=2, **_AUX_MLP, **_CLIPS), rand(8, BS, 2, scale=3.0)),
    "MNISTAuxIPVAE-clip_logvar": lambda: _clip_forward(
        jiaux.MNISTAuxIPVAE(**_AUX_MLP, **_CLIPS),
        tiaux.MNISTAuxIPVAE(**_AUX_MLP, **_CLIPS), _mnist_x()),
}


@pytest.mark.parametrize("case", list(IMPLICIT))
def test_implicit_options(case):
    IMPLICIT[case]()()


# ---- a default-valued model of each family keeps its parameter set ----------

DEFAULTS = {
    "ContextWeightNormalizedLinear": (
        lambda: jl.ContextWeightNormalizedLinear(OUT),
        lambda: tl.ContextWeightNormalizedLinear(IN, CTX, OUT), _xc(IN, CTX)),
    "WeightNormalizedSimplifiedBilinear": (
        lambda: jl.WeightNormalizedSimplifiedBilinear(OUT),
        lambda: tl.WeightNormalizedSimplifiedBilinear(IN, CTX, OUT), _xc(IN, CTX)),
    "ContextResLinear": (lambda: jl.ContextResLinear(OUT),
                         lambda: tl.ContextResLinear(IN, CTX, OUT), _xc(IN, CTX)),
    **{cls: (lambda cls=cls: _mlp(cls, {})[0], lambda cls=cls: _mlp(cls, {})[1],
             _mlp(cls, {})[2])
       for cls in ("WNMLP", "ContextConcatMLP", "ContextResMLP")
       + _CONTEXT_LAYER_MLPS},
    "ToyIPVAE": (lambda: JToyIPVAE(), lambda: TToyIPVAE(),
                 (rand(1, 2, 2), rand(2, 2, 2))),
    "MNISTIPVAE": (lambda: JMnistIPVAE(h_dim=16, noise_dim=6, z_dim=Z),
                   lambda: TMnistIPVAE(h_dim=16, noise_dim=6, z_dim=Z),
                   (_mnist_x(2, 5), rand(2, 2, 6))),
    "MNISTVAE": (lambda: JMnistVAE(**_MLP_VAE), lambda: TMnistVAE(**_MLP_VAE),
                 (_mnist_x(2, 5),)),
    "MNISTConvVAE": (lambda: JConvVAE(z_dim=Z), lambda: TConvVAE(z_dim=Z),
                     (_mnist_x(2, 5),)),
    "MNISTConvAuxVAE": (lambda: jvaux.MNISTConvAuxVAE(z0_dim=6, z_dim=Z),
                        lambda: tvaux.MNISTConvAuxVAE(z0_dim=6, z_dim=Z),
                        (_mnist_x(2, 5),)),
    "ConvIPVAE": (lambda: JConvIPVAE(z_dim=Z, noise_dim=6),
                  lambda: TConvIPVAE(z_dim=Z, noise_dim=6),
                  (_mnist_x(2, 5), rand(2, 2, 6))),
    "MNISTAuxIPVAE": (lambda: jiaux.MNISTAuxIPVAE(**_AUX_MLP),
                      lambda: tiaux.MNISTAuxIPVAE(**_AUX_MLP),
                      (_mnist_x(2, 5), _pair(2, 4))),
}


@pytest.mark.parametrize("case", list(DEFAULTS))
def test_defaults_keep_their_parameters(case):
    """The port's default model: the JAX default's parameter names and
    shapes, converted, key for key."""
    make_j, make_t, inputs = DEFAULTS[case]
    jm, tm = make_j(), make_t()
    want = flax_to_state_dict(jax.jit(jm.init)(KEY, *inputs), tm)
    got = tm.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
