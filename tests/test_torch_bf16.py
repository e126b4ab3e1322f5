"""bf16 mixed precision of the port's models, against the JAX package in
bf16 (its ``compute_dtype='bfloat16'``): the parameter cast
(core/precision.py), ``cdae_loss`` in both styles with an lt0-like and a
hidden1a-like context, ``ivae_loss`` and ``encode_det`` / ``sample_latents``
of resconvct, conv, mnist-concat, the toy model and auxresconvct,
the bf16 upsampling, and the baselines' ``vae_loss`` (Gaussian: mnist,
resconv; MAF: toy-maf) and ``aux_vae_loss`` (auxmnist). Small widths
(z 8, noise 10, h 16-32, bs 4); the parameters cross through convert.py
and every draw is made by jax.random and injected.

Tolerances: bf16 keeps 8 mantissa bits (3.9e-3 relative rounding a
step) and the two frameworks round other intermediate sums, so losses
agree to 2e-2 relative and z and encodings to a relative norm of 2e-2.
Each parameter gradient g of the port agrees with JAX's bf16 one g_b to
||g - g_b|| <= 5e-2 ||g_b|| + 2 ||g_b - g_f||, g_f JAX's fp32 gradient:
bf16 itself moves a gradient by ||g_b - g_f||, 4e-3 relative for a
well-conditioned one but 5-11 % for the conv trunks' weights, whose
gradients cross ten bf16 layers, and up to 95 % for the bias of a
decoder's last convolutions, which XLA on the CPU sums over every pixel
in bf16 (the port's convolutions accumulate in fp32 and land within 5e-4
of fp32 there). Each check also holds
the dtypes: the fp32 master gradients come back fp32, and the tensors JAX
keeps in fp32 (z, the decoder's outputs, the loss, a std-0 encoding that
fp32 zeros promote) are fp32 in the port, those it keeps in bf16 (a
sampling pass) bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.models.cdae import MLPResCARDAE as JRes
from ardae_tpu.models.cdae import cdae_loss as j_cdae_loss
from ardae_tpu.models.ivae import api as jiapi
from ardae_tpu.models.ivae import aux as jaux
from ardae_tpu.models.ivae.conv import ConvIPVAE as JConv
from ardae_tpu.models.ivae.mnist import MNISTIPVAE as JMnist
from ardae_tpu.models.ivae.resconv import ResConvIPVAE as JResConv
from ardae_tpu.models.ivae.toy import ToyIPVAE as JToy
from ardae_tpu.models.vae import api as jvapi
from ardae_tpu.models.vae import aux as jvaux
from ardae_tpu.nn.conv import upsample_bilinear_align_corners as j_upsample
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.core.precision import cast_module, compute_dtype, promote
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.cdae.cardae import MLPGradCARDAE as TGrad
from ardae_tpu_torch.models.cdae.cardae import MLPResCARDAE as TRes
from ardae_tpu_torch.models.cdae.cardae import cdae_loss as t_cdae_loss
from ardae_tpu_torch.models.ivae import api as tiapi
from ardae_tpu_torch.models.ivae import aux as taux
from ardae_tpu_torch.models.ivae.conv import ConvIPVAE as TConv
from ardae_tpu_torch.models.ivae.mnist import MNISTIPVAE as TMnist
from ardae_tpu_torch.models.ivae.resconv import ResConvIPVAE as TResConv
from ardae_tpu_torch.models.ivae.toy import ToyIPVAE as TToy
from ardae_tpu_torch.models.vae import api as tvapi
from ardae_tpu_torch.models.vae import aux as tvaux
from ardae_tpu_torch.nn.conv import align_corners_matrix
from ardae_tpu_torch.nn.conv import upsample_bilinear_align_corners as t_upsample
from ardae_tpu_torch.nn.linear import Linear
from test_torch_maf import _maf
from torch_parity import close, init, loaded, rand, t
from torch_vae_cases import binary
from torch_vae_cases import build as build_vae

BF = "bfloat16"
LOSS_REL, Z_REL, GRAD_REL = 2e-2, 2e-2, 5e-2
Z, NOISE, BS, NZ = 8, 10, 4, 3


def _rel_norm(a, b):
    a = a.detach().float() if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, np.float32))
    b = b.detach().float() if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b, np.float32))
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _rel(a, b):
    return abs(float(a.detach() if isinstance(a, torch.Tensor) else a)
               / float(b) - 1.0)


def _check_grads(jgrads, jgrads32, module):
    """Every parameter's gradient fp32 and within the bound above of JAX's
    bf16 one (``jgrads``; ``jgrads32`` JAX's fp32 one); where torch leaves
    a gradient None (the grad style's output bias, which the score never
    reads) JAX's is zero."""
    want = flax_to_state_dict(jgrads, module)
    want32 = flax_to_state_dict(jgrads32, module)
    for k, prm in module.named_parameters():
        assert prm.dtype == torch.float32, k
        if prm.grad is None:
            assert float(want[k].abs().max()) == 0.0, k
            continue
        assert prm.grad.dtype == torch.float32, k
        err = float((prm.grad - want[k]).norm())
        bound = (GRAD_REL * float(want[k].norm())
                 + 2.0 * float((want[k] - want32[k]).norm()))
        assert err <= bound, (k, err, bound)


# --------------------------------------------------------------------------
# the parameter cast and the promotion


def test_cast_module_runs_bf16_and_returns_fp32_gradients():
    """The cast copies carry the product; the gradient reaches the fp32
    parameter through the cast, equal to the gradient of the same product
    on hand-cast weights; fp32 is the module itself."""
    lin = Linear(5, 3)
    lin.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(1))
    assert cast_module(lin, "float32") is lin and cast_module(lin, None) is lin
    y = cast_module(lin, BF)(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    assert lin.weight.grad.dtype == torch.float32
    w = lin.weight.detach().to(torch.bfloat16).requires_grad_(True)
    b = lin.bias.detach().to(torch.bfloat16).requires_grad_(True)
    F.linear(x.to(torch.bfloat16), w, b).float().square().sum().backward()
    assert torch.equal(lin.weight.grad, w.grad.float())
    assert torch.equal(lin.bias.grad, b.grad.float())
    # an fp32 input against the bf16 copies computes in fp32, as flax does
    assert cast_module(lin, BF)(x).dtype == torch.float32
    assert compute_dtype("float32") is None and compute_dtype(BF) == torch.bfloat16
    with pytest.raises(ValueError, match="float16"):
        compute_dtype("float16")


def test_promote_follows_jax():
    """bf16 with fp32 gives fp32 either way round, as jnp's promotion;
    operands of one dtype come back untouched."""
    a, b = torch.ones(2, 3, dtype=torch.bfloat16), torch.ones(2, 3)
    want = str((jnp.ones((2, 3), jnp.bfloat16) @ jnp.ones((3, 2))).dtype)
    for pa, pb in ((a, b), (b, a)):
        got = promote(pa, pb, None)
        assert [str(g.dtype) for g in got[:2]] == ["torch." + want] * 2
        assert got[2] is None
    same = promote(a, a)
    assert same[0] is a and same[1] is a


# --------------------------------------------------------------------------
# cdae_loss


CDAE = {"res": (JRes, TRes), "grad": (JGrad, TGrad)}
# lt0: a z-wide context of encodings; hidden1a: a 32-wide one of features
CONTEXTS = {"lt0": (Z, lambda: rand(5, BS, Z)),
            "hidden1a": (32, lambda: np.log1p(np.exp(rand(5, BS, 32))))}


@pytest.mark.parametrize("ctx_type", list(CONTEXTS))
@pytest.mark.parametrize("style", list(CDAE))
def test_cdae_loss_bf16_matches_jax(style, ctx_type):
    """Both styles in bf16 (a grad-style net's input gradient taken in bf16
    with create_graph) against JAX cdae_loss(compute_dtype='bfloat16'); the
    loss fp32; the gradients fp32 and other than fp32's (bf16 ran)."""
    jcls, tcls = CDAE[style]
    c, ctx_fn = CONTEXTS[ctx_type]
    jm = jcls(input_dim=Z, context_dim=c, h_dim=32, num_hidden_layers=3,
              nonlinearity="softplus")
    p = init(jm, np.zeros((4, Z), np.float32), np.zeros((4, c), np.float32),
             np.zeros((4, 1), np.float32), seed=3)
    tm = loaded(tcls(Z, c, 32, 3, "softplus"), p)
    latent, ctx = rand(4, BS, 8, Z), ctx_fn()
    std = np.abs(rand(6, BS, 8, 1, scale=0.5))
    key = jax.random.PRNGKey(9)
    (jl, jg), (_, jg32) = jax.jit(lambda q: [jax.value_and_grad(
        lambda r: j_cdae_loss(jm, r, key, latent, ctx, std, compute_dtype=cd))(q)
        for cd in (BF, None)])(p)
    eps = t(jax.random.normal(key, (BS * 8, Z)))  # the draw cdae_loss makes
    loss = t_cdae_loss(tm, t(latent), t(ctx), t(std), eps=eps, compute_dtype=BF)
    assert loss.dtype == torch.float32
    loss.backward()
    assert _rel(loss, jl) <= LOSS_REL
    _check_grads(jg, jg32, tm)
    g_bf16 = {k: q.grad.clone() for k, q in tm.named_parameters() if q.grad is not None}
    tm.zero_grad(set_to_none=True)
    t_cdae_loss(tm, t(latent), t(ctx), t(std), eps=eps).backward()
    assert max(_rel_norm(g, tm.get_parameter(k).grad) for k, g in g_bf16.items()) > 1e-4


# --------------------------------------------------------------------------
# the implicit models: ivae_loss, encode_det, sample_latents


def _mnist_x(n, seed):
    return (_synthetic_mnist(n, seed=seed)[0] > 0.5).astype(np.float32)


IVAE = {
    # name: (flax module, the port's, input maker)
    "resconvct": (
        lambda: JResConv(z_dim=Z, noise_dim=NOISE, h_dim=32, num_hidden_layers=1,
                         nonlinearity="elu", do_center=True, enc_type="res-wn-mlp"),
        lambda: TResConv(z_dim=Z, noise_dim=NOISE, h_dim=32, num_hidden_layers=1,
                         nonlinearity="elu", do_center=True),
        _mnist_x),
    "conv": (lambda: JConv(z_dim=Z, noise_dim=NOISE),
             lambda: TConv(z_dim=Z, noise_dim=NOISE), _mnist_x),
    "mnist-concat": (
        lambda: JMnist(noise_dim=NOISE, h_dim=16, z_dim=Z, num_hidden_layers=2),
        lambda: TMnist(noise_dim=NOISE, h_dim=16, z_dim=Z, num_hidden_layers=2),
        _mnist_x),
    "toy": (lambda: JToy(noise_dim=NOISE, h_dim=16, z_dim=2, nonlinearity="relu",
                         num_hidden_layers=2),
            lambda: TToy(noise_dim=NOISE, h_dim=16, z_dim=2, nonlinearity="relu",
                         num_hidden_layers=2),
            lambda n, seed: rand(seed, n, 2, scale=3.0)),
    "auxresconvct": (
        lambda: jaux.MNISTResConvAuxIPVAE(z0_dim=NOISE, z_dim=Z, c_dim=32,
                                          do_center=True),
        lambda: taux.MNISTResConvAuxIPVAE(z0_dim=NOISE, z_dim=Z, c_dim=32,
                                          do_center=True),
        _mnist_x),
}


@functools.cache
def build_ivae(name):
    """(flax module, params, the port's module with them, x); built once."""
    jmf, tmf, xf = IVAE[name]
    jm = jmf()
    x = xf(BS, 6)
    noise = (np.zeros((2, NOISE), np.float32) if jm.family != "aux" else
             (np.zeros((2, NOISE), np.float32), np.zeros((2, Z), np.float32)))
    p = jax.jit(jm.init)(jax.random.PRNGKey(3), x[:2], noise)
    return jm, p, loaded(tmf(), p), x


def _injected(jm, key, n, nz):
    """The encoder noise sample_latents draws from ``key``, as tensors."""
    eps = jiapi.make_eps(jm, key, n, nz)
    return tuple(t(e) for e in eps) if jm.family == "aux" else t(eps)


def _cast(p):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)


@pytest.mark.parametrize("name", list(IVAE))
def test_ivae_loss_bf16_matches_jax(name):
    """ivae_loss(compute_dtype='bfloat16') against JAX's: the loss and its
    terms, z and the decoder's outputs fp32, the fp32 master gradients."""
    jm, p, tm, x = build_ivae(name)
    key = jax.random.PRNGKey(4)
    ((jl, wterms), jg), (_, jg32) = jax.jit(lambda q: [
        jax.value_and_grad(lambda r: jiapi.ivae_loss(
            jm, r, key, jnp.asarray(x), NZ, beta=0.7, compute_dtype=cd),
            has_aux=True)(q) for cd in (BF, None)])(p)
    tm.zero_grad(set_to_none=True)
    loss, terms = tiapi.ivae_loss(tm, t(x), NZ, beta=0.7,
                                  eps=_injected(jm, key, BS, NZ), compute_dtype=BF)
    assert loss.dtype == terms["z"].dtype == torch.float32
    assert all(d.dtype == torch.float32 for d in terms["dist_params"])
    assert str(wterms["z"].dtype) == "float32"
    loss.backward()
    assert _rel(loss, jl) <= LOSS_REL
    for k in ("recon", "prior"):
        assert _rel(terms[k], wterms[k]) <= LOSS_REL, k
    assert _rel_norm(terms["z"], wterms["z"]) <= Z_REL
    _check_grads(jg, jg32, tm)


@pytest.mark.parametrize("name", list(IVAE))
def test_encode_det_and_sampling_bf16_dtypes_match_jax(name):
    """On bf16 parameters and input, the std-0 encoding (and an aux model's
    hidden1a features) takes JAX's fp32 zeros, which promote the rest of
    the encoding to fp32, while a sampling pass stays bf16: the dtypes are
    JAX's, the values within Z_REL."""
    jm, p, tm, x = build_ivae(name)
    key = jax.random.PRNGKey(5)
    pc, xc = _cast(p), jnp.asarray(x, jnp.bfloat16)

    def jfn(pc, xc):
        out = {"det": jiapi.encode_det(jm, pc, xc),
               "sample": jiapi.sample_latents(jm, pc, key, xc, NZ)}
        if jm.family == "aux":
            out["hidden"] = jiapi.encode_hidden_feats(jm, pc, xc)
        return out

    want = jax.jit(jfn)(pc, xc)
    net, x_c = cast_module(tm, BF), t(x).to(torch.bfloat16)
    with torch.no_grad():
        got = {"det": tiapi.encode_det(net, x_c),
               "sample": tiapi.sample_latents(net, x_c, NZ,
                                              eps=_injected(jm, key, BS, NZ))}
        if jm.family == "aux":
            got["hidden"] = tiapi.encode_hidden_feats(net, x_c)
    assert str(want["det"].dtype) == "float32" and str(want["sample"].dtype) == BF
    for k, w in want.items():
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        assert _rel_norm(got[k], w) <= Z_REL, k


# --------------------------------------------------------------------------
# the bf16 upsampling


def test_upsampling_bf16_matches_jax():
    """The resconv decoder's x2 upsampling in bf16: JAX's two products with
    bf16 coefficients (1/3 rounds to 0.333984375), here NCHW; equal to one
    bf16 step. fp32 keeps F.interpolate (channels-last), bit for bit."""
    x = rand(7, 3, 5, 7, 6)                           # N C H W
    xb = t(x).to(torch.bfloat16)
    got = t_upsample(xb, 2)
    want = j_upsample(jnp.asarray(np.transpose(x, (0, 2, 3, 1)), jnp.bfloat16), 2)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 14, 12)
    close(got.float(), np.transpose(np.asarray(want, np.float32), (0, 3, 1, 2)),
          2.0 ** -7, 0.0)
    coeff = align_corners_matrix(2, 4).to(torch.bfloat16)
    assert 0.333984375 in [float(v) for v in coeff.flatten()]
    want32 = F.interpolate(t(x), scale_factor=2, mode="bilinear", align_corners=True)
    assert torch.equal(t_upsample(t(x), 2), want32)


# --------------------------------------------------------------------------
# the baselines: vae_loss and aux_vae_loss


def _check_vae(jloss_fn, p, tm, x, eps, beta=0.7):
    """``jloss_fn(params, compute_dtype)``: JAX's loss and terms."""
    ((jl, wterms), jg), (_, jg32) = jax.jit(lambda q: [
        jax.value_and_grad(lambda r: jloss_fn(r, cd), has_aux=True)(q)
        for cd in (BF, None)])(p)
    tm.zero_grad(set_to_none=True)
    loss, terms = tvapi.vae_loss(tm, t(x), beta=beta, eps=eps, compute_dtype=BF)
    assert loss.dtype == terms["z"].dtype == torch.float32
    loss.backward()
    assert _rel(loss, jl) <= LOSS_REL
    for k in ("recon", "kld"):
        assert _rel(terms[k], wterms[k]) <= LOSS_REL, k
    assert _rel_norm(terms["z"], wterms["z"]) <= Z_REL
    _check_grads(jg, jg32, tm)


@pytest.mark.parametrize("name", ["mnist", "resconv"])
def test_vae_loss_bf16_matches_jax(name):
    jm, p, tm = build_vae(name)
    x, key = binary(4, 8), jax.random.PRNGKey(9)
    _check_vae(lambda q, cd: jvapi.vae_loss(jm, q, key, jnp.asarray(x),
                                            beta=0.7, compute_dtype=cd),
               p, tm, x, t(jax.random.normal(key, (4, 4))))


def test_maf_vae_loss_bf16_matches_jax():
    """toy-maf: the encoder and decoder in bf16, the flow on the fp32
    master parameters (its gradients fp32 too)."""
    jm, p, tm = _maf()
    x, key = rand(8, 16, 2, scale=3.0), jax.random.PRNGKey(11)
    _check_vae(lambda q, cd: jvapi.vae_loss(jm, q, key, jnp.asarray(x),
                                            beta=0.7, compute_dtype=cd),
               p, tm, x, t(jax.random.normal(key, (16, jm.z_dim))))


def test_aux_vae_loss_bf16_matches_jax():
    """auxmnist baseline: the towers and decoder in bf16, the Gaussian
    sampling and both KLDs in fp32."""
    jm = jvaux.MNISTAuxVAE(noise_dim=NOISE, h_dim=16, z_dim=Z, num_hidden_layers=2,
                           do_xavier=False)
    x, key = _mnist_x(BS, 8), jax.random.PRNGKey(9)
    p = init(jm, x[:2], seed=1)
    tm = loaded(tvaux.MNISTAuxVAE(noise_dim=NOISE, h_dim=16, z_dim=Z,
                                  num_hidden_layers=2), p)
    k0, k1 = jax.random.split(key)
    eps = (t(jax.random.normal(k0, (BS, NOISE))), t(jax.random.normal(k1, (BS, Z))))
    _check_vae(lambda q, cd: jvaux.aux_vae_loss(jm, q, key, jnp.asarray(x),
                                                beta=0.7, compute_dtype=cd),
               p, tm, x, eps)
