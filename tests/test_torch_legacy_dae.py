"""The legacy reconstruction-style DAEs of the port (models/cdae/legacy.py)
against their JAX twins: MLPDAE and MLPCDAE (context encoded, and input
and context both encoded) at small, unequal widths. The forward, the loss
mse(recon(x + std*eps), x) with the JAX eps injected and every parameter
gradient, and the score (recon(x) - x) / std^2. Tolerances: values and
loss rel 1e-5 (atol 1e-6 near 0), gradients rel-norm 1e-4. Neither driver
builds them: build_cdae("mlp") still raises, as in the JAX package.
"""

import functools

import jax
import numpy as np
import pytest

from ardae_tpu.models.cdae import legacy as jleg
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.models.cdae import legacy as tleg
from ardae_tpu_torch.models.registry import build_cdae
from torch_parity import check_round_trip, close, loaded, rand, t

D, CTX, N = 3, 5, 6
CASES = {
    "dae": dict(),
    "cdae": dict(enc_input=False, enc_ctx=True),
    "cdae-enc-input": dict(enc_input=True, enc_ctx=True),
}


@functools.cache
def build(case):
    widths = dict(h_dim=8, num_hidden_layers=2, nonlinearity="tanh")
    if case == "dae":
        jm, tm = jleg.MLPDAE(D, **widths), tleg.MLPDAE(D, **widths)
        p = jm.init(jax.random.PRNGKey(0), np.zeros((1, D), np.float32))
        return jm, p, loaded(tm, p), None
    jm = jleg.MLPCDAE(D, CTX, **widths, **CASES[case])
    tm = tleg.MLPCDAE(D, CTX, **widths, **CASES[case])
    p = jm.init(jax.random.PRNGKey(0), np.zeros((1, D), np.float32),
                np.zeros((1, CTX), np.float32))
    return jm, p, loaded(tm, p), rand(9, N, CTX)


def _rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_score(case):
    jm, p, tm, ctx = build(case)
    x, std = rand(1, N, D), 0.3
    args = (x,) if ctx is None else (x, ctx)
    close(tm(*map(t, args)), jm.apply(p, *args), 1e-5, 1e-6)
    tctx = None if ctx is None else t(ctx)
    close(tleg.legacy_dae_score(tm, t(x), std, tctx),
          jleg.legacy_dae_score(jm, p, x, std, ctx), 1e-5, 1e-5)
    key = jax.random.PRNGKey(2)
    want, jgrads = jax.value_and_grad(
        lambda q: jleg.legacy_dae_loss(jm, q, key, x, std, ctx))(p)
    tm.zero_grad(set_to_none=True)
    got = tleg.legacy_dae_loss(tm, t(x), std, tctx,
                               eps=t(jax.random.normal(key, x.shape)))
    got.backward()
    close(got, want, 1e-5, 0.0)
    want_g = flax_to_state_dict(jgrads, tm)
    for k, prm in tm.named_parameters():
        assert _rel_norm(prm.grad, want_g[k]) <= 1e-4, k


@pytest.mark.parametrize("case", list(CASES))
def test_convert_round_trip(case):
    _, p, tm, _ = build(case)
    check_round_trip(p, tm)


def test_no_driver_builds_it():
    with pytest.raises(NotImplementedError, match="no driver builds"):
        build_cdae("mlp", input_dim=D, context_dim=CTX, device="cpu")
