"""The driverless modules of the port against their JAX twins at small
widths: core/aux_grad.py, core/distributions.py, core/jacobian_clamping.py,
the marginal-entropy helpers and the column shuffle of core/stats.py, the
probability-form losses of core/losses.py, CategoricalHead and the relaxed
samplers of nn/heads.py, and nn/torchkit_extras.py (CWNlinear, CWNconv2d,
WNBilinear, GatingLinear and the Sequential plumbing). Each JAX test of
these modules (tests/test_parity_extras.py, tests/test_core.py:151-200) has
its counterpart here, and each function is also held against its twin on
the same numpy inputs, the JAX draws injected. Flax params cross through
convert.py (CWNconv2d's HWIO -> OIHW, WNBilinear's (out, in1, in2) as it
is). Tolerances: values rel 1e-5 (atol 1e-6 near 0), gradients rel-norm
1e-4; the port's own init against JAX's by the moments of every tensor.
"""

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ardae_tpu.core import aux_grad as jaux_grad
from ardae_tpu.core import distributions as jdist
from ardae_tpu.core import jacobian_clamping as jjac
from ardae_tpu.core import losses as jlosses
from ardae_tpu.core import stats as jstats
from ardae_tpu.nn import heads as jheads
from ardae_tpu.nn import torchkit_extras as jtk
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.core import aux_grad as taux_grad
from ardae_tpu_torch.core import distributions as tdist
from ardae_tpu_torch.core import jacobian_clamping as tjac
from ardae_tpu_torch.core import losses as tlosses
from ardae_tpu_torch.core import stats as tstats
from ardae_tpu_torch.nn import heads as theads
from ardae_tpu_torch.nn import torchkit_extras as ttk
from ardae_tpu_torch.nn.initializers import init_module
from torch_parity import check_init_law, check_round_trip, close, loaded, rand, t

KEY = jax.random.PRNGKey(0)


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


# ------------------------------ core/aux_grad ------------------------------

def test_aux_loss_for_grad_contract():
    """d/dx = g exactly and g gets no gradient (tests/test_core.py:157);
    the value is JAX's sum(g * x)."""
    x, g = rand(1, 2, 2), rand(2, 2, 2)
    tx, tg = t(x).requires_grad_(True), t(g).requires_grad_(True)
    val = taux_grad.aux_loss_for_grad(tx, tg)
    val.backward()
    assert torch.equal(tx.grad, tg.detach())
    assert tg.grad is None
    close(val, jaux_grad.aux_loss_for_grad(x, g), 1e-6, 0.0)


# ---------------------------- core/distributions ---------------------------

def test_hyperspherical_uniform():
    """tests/test_parity_extras.py:63: unit norm on S^2, entropy log(4 pi),
    the constant log-density; the JAX draw injected gives JAX's points."""
    s = tdist.sample_hyperspherical_uniform(3, 1000, 2,
                                            generator=torch.Generator().manual_seed(0))
    close(torch.linalg.vector_norm(s, dim=-1), np.ones((3, 1000)), 0.0, 1e-5)
    assert abs(tdist.hyperspherical_uniform_entropy(2) - np.log(4 * np.pi)) < 1e-6
    for dim in (1, 2, 5, 31):
        # JAX's gammaln runs in fp32, math.lgamma in fp64
        want = jdist.hyperspherical_uniform_entropy(dim)
        assert abs(tdist.hyperspherical_uniform_entropy(dim) - want) <= 1e-6 * abs(want)
    lp = tdist.hyperspherical_uniform_logprob(s, 2)
    assert lp.shape == (3, 1000)
    close(lp, np.full((3, 1000), -np.log(4 * np.pi)), 0.0, 1e-6)
    eps = jax.random.normal(KEY, (2, 5, 4))
    close(tdist.sample_hyperspherical_uniform(2, 5, 3, eps=t(eps)),
          jdist.sample_hyperspherical_uniform(KEY, 2, 5, 3), 1e-5, 1e-6)


# -------------------------- core/jacobian_clamping -------------------------

def test_minrelu():
    close(tjac.minrelu(torch.tensor([-2.0, 0.0, 3.0])), [-2.0, 0.0, 0.0])


def test_jac_clamping_zero_for_expanding_map():
    """tests/test_parity_extras.py:34: f(z) = 3z is penalised 0 at eta_min
    1, f(z) = 0.01 z more than 0.5."""
    x = t(jax.random.normal(KEY, (16, 2)))
    z = x / 3.0
    g = torch.Generator().manual_seed(0)
    loss = tjac.jac_clamping_loss(lambda zz: 3.0 * zz, x, z, 4, 1.0, generator=g)
    assert float(loss) == 0.0
    loss2 = tjac.jac_clamping_loss(lambda zz: 0.01 * zz, 0.01 * z, z, 4, 1.0,
                                   generator=g)
    assert float(loss2) > 0.5


def test_cond_jac_clamping_runs():
    """tests/test_parity_extras.py:49."""
    bsz, nz, zdim = 4, 3, 2
    ctx = torch.randn(bsz, 5, generator=torch.Generator().manual_seed(1))
    z = torch.randn(bsz * nz, zdim, generator=torch.Generator().manual_seed(2))
    loss = tjac.cond_jac_clamping_loss(lambda c, zr, a, b: 2.0 * zr, 2.0 * z, ctx,
                                       z, nz, 2, 1.0,
                                       generator=torch.Generator().manual_seed(3))
    assert float(loss) == 0.0


def test_jac_clamping_matches_jax():
    """Both variants through a tanh map, with JAX's perturbation injected:
    the penalty and its gradient with respect to the map's weight."""
    w = rand(4, 3, 5)
    z = rand(5, 6, 3)
    key = jax.random.PRNGKey(9)

    def jloss(ww):
        f = lambda zz: jnp.tanh(zz @ ww)
        return jjac.jac_clamping_loss(f, key, f(z), z, 4, 2.0, eps=0.05)

    def jcloss(ww):
        f = lambda c, zz, a, b: jnp.tanh(zz @ ww)
        return jjac.cond_jac_clamping_loss(f, key, jnp.tanh(z @ ww), z[:2], z, 3, 4,
                                           2.0, eps=0.05)

    for variant, jfn, shape in (("plain", jloss, (6, 4, 3)),
                                ("cond", jcloss, (6, 4, 3))):
        want, jg = jax.value_and_grad(jfn)(w)
        pert = t(jax.random.normal(key, shape))
        tw = t(w).requires_grad_(True)
        f = lambda zz: torch.tanh(zz @ tw)
        if variant == "plain":
            got = tjac.jac_clamping_loss(f, f(t(z)), t(z), 4, 2.0, eps=0.05,
                                         perturb=pert)
        else:
            got = tjac.cond_jac_clamping_loss(
                lambda c, zz, a, b: f(zz), f(t(z)), t(z[:2]), t(z), 3, 4, 2.0,
                eps=0.05, perturb=pert)
        got.backward()
        assert float(want) > 0.0, variant
        close(got, want, 1e-5, 0.0, msg=variant)
        assert _rel_norm(tw.grad, t(jg)) <= 1e-4, variant


# ------------------------------- core/stats --------------------------------

def test_gaussian_density_helpers_match_jax():
    mu, lv, z = rand(1, 4, 3), rand(2, 4, 3, scale=0.5), rand(3, 4, 3)
    close(tstats.prob_gaussian(t(mu), t(lv), t(z)),
          jstats.prob_gaussian(mu, lv, z), 1e-5, 1e-7)
    for std in (1.0, 0.3):
        close(tstats.logprob_gaussian_w_fixed_var(t(mu), t(z), std),
              jstats.logprob_gaussian_w_fixed_var(mu, z, std), 1e-5, 1e-6)


def test_shuffle_permutes_columns_independently():
    """tests/test_core.py:171; and JAX's permutations injected give JAX's
    shuffle."""
    z = torch.arange(24.0).reshape(8, 3)
    out = tstats.shuffle(z, generator=torch.Generator().manual_seed(3))
    for i in range(3):
        assert sorted(out[:, i].tolist()) == sorted(z[:, i].tolist())
    assert not torch.equal(out, z)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 3)
    perm = np.stack([np.array(jax.random.permutation(keys[i], 8)) for i in range(3)])
    close(tstats.shuffle(z, perm=torch.from_numpy(perm)),
          jstats.shuffle(key, jnp.asarray(z.numpy())), 0.0, 0.0)


def test_marginal_entropy_gaussian_single_kernel():
    """tests/test_core.py:183: with one kernel both reduce to the Gaussian
    log-density."""
    mu, logvar = torch.zeros(1, 2), torch.zeros(1, 2)
    z = torch.tensor([[0.5, -1.0], [2.0, 0.0]])
    exact = -tstats.logprob_gaussian(torch.zeros(2), torch.zeros(2), z)
    close(tstats.loss_marginal_entropy_gaussian(mu, logvar, z, reduce="none"),
          exact, 1e-4)
    close(tstats.loss_approx_marginal_entropy_gaussian(mu, logvar, z, reduce="none"),
          exact, 1e-5)


@pytest.mark.parametrize("reduce", ["sum", "none"])
def test_marginal_entropy_matches_jax(reduce):
    mu, lv, z = rand(1, 5, 3), rand(2, 5, 3, scale=0.5), rand(3, 4, 3)
    for tfn, jfn in ((tstats.loss_marginal_entropy_gaussian,
                      jstats.loss_marginal_entropy_gaussian),
                     (tstats.loss_approx_marginal_entropy_gaussian,
                      jstats.loss_approx_marginal_entropy_gaussian)):
        close(tfn(t(mu), t(lv), t(z), reduce=reduce), jfn(mu, lv, z, reduce=reduce),
              1e-5, 1e-6)


# ------------------------------- core/losses -------------------------------

def test_loss_recon_bernoulli_matches_logit_version():
    """tests/test_core.py:195, and against JAX."""
    logit = rand(5, 4, 7)
    x = (rand(6, 4, 7) > 0).astype(np.float32)
    via_logit = torch.sum(tlosses.loss_recon_bernoulli_with_logit(t(logit), t(x)))
    via_prob = tlosses.loss_recon_bernoulli(torch.sigmoid(t(logit)), t(x))
    close(via_prob, via_logit, 1e-4)
    close(via_prob, jlosses.loss_recon_bernoulli(jax.nn.sigmoid(logit), x), 1e-5)


@pytest.mark.parametrize("kw", [{}, dict(std=0.5, const=1.5),
                                dict(std=2.0, add_logvar=False, reduce="sum"),
                                dict(reduce="none")])
def test_loss_recon_gaussian_w_fixed_var_matches_jax(kw):
    mu, x = rand(1, 4, 3, 2), rand(2, 4, 3, 2)
    close(tlosses.loss_recon_gaussian_w_fixed_var(t(mu), t(x), **kw),
          jlosses.loss_recon_gaussian_w_fixed_var(mu, x, **kw), 1e-5, 1e-6)


# -------------------------------- nn/heads ---------------------------------

def test_categorical_and_relaxed_samples():
    """tests/test_parity_extras.py:98, then each against JAX: the head on
    converted params, each sampler with JAX's uniforms injected."""
    h = rand(1, 5, 10)
    jhead = jheads.CategoricalHead(4)
    p = jhead.init(KEY, h)
    head = loaded(theads.CategoricalHead(10, 4), p)
    check_round_trip(p, head)
    logits = head(t(h))
    assert logits.shape == (5, 4)
    close(logits, jhead.apply(p, h), 1e-5, 1e-6)
    g = torch.Generator().manual_seed(0)
    gs = theads.sample_gumbel_softmax(logits, temperature=0.5, generator=g)
    close(gs.sum(-1), np.ones(5), 0.0, 1e-5)
    ls = theads.sample_logistic_sigmoid(logits, generator=g)
    assert bool(((ls >= 0) & (ls <= 1)).all())
    jl = np.asarray(jhead.apply(p, h))
    u = t(jax.random.uniform(KEY, jl.shape))
    close(theads.sample_gumbel_softmax(t(jl), 0.5, u=u),
          jheads.sample_gumbel_softmax(KEY, jl, 0.5), 1e-5, 1e-6)
    close(theads.sample_logistic_sigmoid(t(jl), 0.7, u=u),
          jheads.sample_logistic_sigmoid(KEY, jl, 0.7), 1e-5, 1e-6)


# ---------------------------- nn/torchkit_extras ----------------------------

N, F_IN, CTX, OUT = 4, 6, 3, 5
# name: (flax module, its example inputs, the port's module)
LAYERS = {
    "CWNlinear": (jtk.CWNlinear(OUT), lambda: (rand(1, N, F_IN), rand(2, N, CTX)),
                  lambda: ttk.CWNlinear(F_IN, CTX, OUT)),
    "CWNlinear-unnormed": (jtk.CWNlinear(OUT, norm=False),
                           lambda: (rand(1, N, F_IN), rand(2, N, CTX)),
                           lambda: ttk.CWNlinear(F_IN, CTX, OUT, norm=False)),
    "WNBilinear": (jtk.WNBilinear(7), lambda: (rand(1, N, F_IN), rand(2, N, CTX)),
                   lambda: ttk.WNBilinear(F_IN, CTX, 7)),
    "GatingLinear": (jtk.GatingLinear(OUT), lambda: (rand(1, N, F_IN),),
                     lambda: ttk.GatingLinear(F_IN, OUT)),
    "CWNconv2d": (jtk.CWNconv2d(4, 3, 1, 1),
                  lambda: (rand(1, 2, 8, 8, 3), rand(2, 2, CTX)),
                  lambda: ttk.CWNconv2d(3, CTX, 4, 3, 1, 1)),
    "CWNconv2d-stride2": (jtk.CWNconv2d(4, 3, 2, 0),
                          lambda: (rand(1, 2, 9, 9, 3), rand(2, 2, CTX)),
                          lambda: ttk.CWNconv2d(3, CTX, 4, 3, 2, 0)),
}


def _nchw(name, args):
    """The port's inputs: an image NHWC -> NCHW."""
    if name.startswith("CWNconv2d"):
        return (t(np.transpose(args[0], (0, 3, 1, 2))), t(args[1]))
    return tuple(t(a) for a in args)


@pytest.mark.parametrize("name", list(LAYERS))
def test_torchkit_layer_matches_jax(name):
    """Forward and every parameter gradient of sum(out * w) on converted
    params, the converter's round trip, and the port's init law."""
    jm, inputs, make = LAYERS[name]
    args = inputs()
    p = jm.init(jax.random.PRNGKey(3), *args)
    tm = loaded(make(), p)
    check_round_trip(p, tm)
    out = tm(*_nchw(name, args))
    want = jm.apply(p, *args)
    if name.startswith("CWNconv2d"):
        want = np.transpose(np.asarray(want), (0, 3, 1, 2))
    assert tuple(out.shape) == tuple(np.shape(want))
    close(out, want, 1e-5, 1e-6)
    wts = rand(9, *np.shape(want))
    jw = np.transpose(wts, (0, 2, 3, 1)) if name.startswith("CWNconv2d") else wts
    jg = jax.grad(lambda q: jnp.sum(jm.apply(q, *args) * jw))(p)
    torch.sum(out * t(wts)).backward()
    want_g = flax_to_state_dict(jg, tm)
    for k, prm in tm.named_parameters():
        assert _rel_norm(prm.grad, want_g[k]) <= 1e-4, k
    # the port's own draws by JAX's law (a wide layer, so moments mean something)
    wide = {"CWNlinear": (lambda: ttk.CWNlinear(64, 32, 48), jtk.CWNlinear(48),
                          (np.zeros((1, 64), np.float32), np.zeros((1, 32), np.float32))),
            "WNBilinear": (lambda: ttk.WNBilinear(32, 24, 16), jtk.WNBilinear(16),
                           (np.zeros((1, 32), np.float32), np.zeros((1, 24), np.float32))),
            "GatingLinear": (lambda: ttk.GatingLinear(64, 48), jtk.GatingLinear(48),
                             (np.zeros((1, 64), np.float32),)),
            "CWNconv2d": (lambda: ttk.CWNconv2d(16, 32, 24, 3), jtk.CWNconv2d(24, 3),
                          (np.zeros((1, 5, 5, 16), np.float32),
                           np.zeros((1, 32), np.float32)))}
    if name in wide:
        mk, jwide, ex = wide[name]
        mine = init_module(mk(), torch.Generator().manual_seed(4))
        ref = flax_to_state_dict(jwide.init(jax.random.PRNGKey(4), *ex), mine)
        check_init_law(mine.state_dict(), ref)


def test_torchkit_sequential_plumbing():
    """tests/test_parity_extras.py:145."""
    assert ttk.Reshape((2, 6))(torch.ones(3, 4)).shape == (2, 6)
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    # the reference resconv decoder's crop, NCHW: slicer[:, :, :-1, :-1]
    assert ttk.slicer[:, :, :-1, :-1](x).shape == (1, 1, 3, 3)
    assert isinstance(ttk.slicer[1:], ttk.Slice)
    assert float(ttk.Lambda(torch.sum)(torch.ones(2, 3))) == 6.0
    y, ctx = ttk.ContextWrapper(ttk.Lambda(torch.tanh))((torch.zeros(2, 2),
                                                         torch.ones(2, 1)))
    assert y.shape == (2, 2) and ctx.shape == (2, 1)

    class Shift(torch.nn.Module):
        def forward(self, inputs):
            x, logdet, ctx = inputs
            return x + 1.0, logdet + 2.0, ctx

    flow = ttk.SequentialFlow([Shift(), Shift()], dim=3, context_dim=2)
    x, logdet, ctx = flow.sample(5, generator=torch.Generator().manual_seed(0))
    assert x.shape == (5, 3) and ctx.shape == (5, 2) and logdet.shape == (5,)
    assert bool((logdet >= 4.0).all()) and bool((logdet < 5.0).all())
    assert not ctx.any()

    class JShift(fnn.Module):
        @fnn.compact
        def __call__(self, inputs):
            x, logdet, ctx = inputs
            return x + 1.0, logdet + 2.0, ctx

    jflow = jtk.SequentialFlow(blocks=(JShift(), JShift()), dim=3, context_dim=2)
    want = jflow.apply({}, KEY, 5, method=jflow.sample)
    k1, k2 = jax.random.split(KEY)
    got = flow.sample(5, x=t(jax.random.normal(k1, (5, 3))),
                      logdet=t(jax.random.uniform(k2, (5,))))
    for a, b in zip(got, want):
        close(a, b, 1e-6, 0.0)
    assert math.isfinite(float(got[1].sum()))
