"""The baseline VAE's training step and evaluator, port against JAX: one
vae_step (mnist) against build_vae_train_step, three steps of
cli/vae.py's chunk body with binarization (conv), and evaluate_iwae_vae
over a split with a short tail and its aggregation (mnist).
The cases are tests/torch_vae_cases.py's (bs 4, z 4, vendored Adam lr
1e-3). Every draw is made by jax.random from the keys the JAX code derives
(vae_step.py:34, cli/vae.py:227-231, common.py:223-230) and injected.

Tolerances: metrics rel 1e-5 (one step) or 1e-4 (three); the split's means
rel 1e-5. Parameters after Adam steps: the update p_after - p_before agrees
as a whole to a relative norm of 1e-2, and each element to 0.25 (one step)
or 1.0 (three steps) x lr, Adam's largest move a step (its first step is
~lr*sign(g), which flips where g is within the two frameworks' rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ardae_tpu.cli.common import evaluate_iwae_vae as j_evaluate
from ardae_tpu.train import optim as jopt
from ardae_tpu.train.state import TrainState as JState
from ardae_tpu.train.vae_step import VAEStepConfig as JCfg
from ardae_tpu.train.vae_step import build_vae_train_step
from ardae_tpu_torch.cli.common import evaluate_iwae_vae as t_evaluate
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.models.vae import api as tapi
from ardae_tpu_torch.train import optim as topt
from ardae_tpu_torch.train.state import create_train_state
from ardae_tpu_torch.train.vae_step import VAEStepConfig, train_vae_chunk, vae_step
from torch_parity import close, t
from torch_vae_cases import Z, binary, build, fresh

BS, LR = 4, 1e-3


def _states(name):
    jm, p, _ = build(name)
    tm = fresh(name, p)
    tx = jopt.build_optimizer("adam", LR, beta1=0.9)
    jstate = JState(step=jnp.zeros([], jnp.int32), params_model=p,
                    opt_model=tx.init(p), params_cdae={}, opt_cdae=())
    tstate = create_train_state(tm, topt.build_optimizer("adam", tm.parameters(),
                                                         LR, beta1=0.9))
    return jm, tx, jstate, tstate


def _compare_params(jparams, module, before, move, msg):
    want = flax_to_state_dict(jparams, module)
    err = ref = 0.0
    for k, v in module.state_dict().items():
        close(v, want[k], 0.0, move, msg=f"{msg} {k}")
        d_port, d_jax = v - before[k], want[k] - before[k]
        err += float(((d_port - d_jax) ** 2).sum())
        ref += float((d_jax ** 2).sum())
    assert err ** 0.5 <= 1e-2 * ref ** 0.5, msg


def test_vae_step_matches_jax():
    """One step of the mlp model; the resconv and conv models' losses and
    gradients are held in test_torch_vae.py, and the conv model's steps in
    the chunk test below."""
    jm, tx, jstate, ts = _states("mnist")
    x, key, scale = binary(BS, 13), jax.random.PRNGKey(14), 1.0 / 784
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    step = build_vae_train_step(jm, tx, JCfg(loss_scale=scale))
    jstate2, jmet = step(jstate, x, key, 0.5)
    eps = t(jax.random.normal(jax.random.fold_in(key, 0), (BS, Z)))
    tmet = vae_step(ts, VAEStepConfig(loss_scale=scale), t(x), 0.5, None, eps)
    for k, v in jmet.items():
        close(tmet[k], v, 1e-5, 1e-7, msg=k)
    assert ts.step == 1
    _compare_params(jstate2.params_model, ts.model, before, 0.25 * LR, "step")


def test_chunk_with_binarization_matches_jax():
    """Three steps of cli/vae.py's chunk body: per step k = fold_in(key,
    step), the batch gathered and binarized with fold_in(k, 7), beta from
    the step count (cli/vae.py:226-232)."""
    jm, tx, jstate, ts = _states("conv")
    data = _synthetic_mnist(24, seed=15)[0]
    idx = np.random.default_rng(16).integers(0, 24, (3, BS))
    key, scale = jax.random.PRNGKey(17), 1.0 / 784
    beta_fn = lambda s: 0.2 + 0.1 * s  # noqa: E731
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    step = build_vae_train_step(jm, tx, JCfg(loss_scale=scale))
    draws = []
    for s in range(3):
        k = jax.random.fold_in(key, s)
        u = jax.random.uniform(jax.random.fold_in(k, 7), (BS, 784))
        batch = jax.random.bernoulli(jax.random.fold_in(k, 7),
                                     jnp.asarray(data)[idx[s]]).astype(jnp.float32)
        jstate, jmet = step(jstate, batch, key, beta_fn(s))
        draws.append({"bin": t(u), "eps": t(jax.random.normal(k, (BS, Z)))})
    tmet = train_vae_chunk(ts, VAEStepConfig(loss_scale=scale), t(data), idx, None,
                           beta_fn, binarize=True, draws=draws)
    for k, v in jmet.items():
        close(tmet[k], v, 1e-4, 1e-6, msg=k)
    assert ts.step == 3
    _compare_params(jstate.params_model, ts.model, before, 1.0 * LR, "chunk")


# --- the evaluator ------------------------------------------------------------

def _replayed_eval_draws(key, n, batch, ssz):
    """Each batch's draws as JAX's evaluate_iwae_vae makes them
    (common.py:223-230) on its zero-padded batch, cut to the real rows."""
    draws = []
    for start in range(0, n, batch):
        nv = min(batch, n - start)
        key, sub = jax.random.split(key)
        key, kb = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        draws.append({"bin": t(jax.random.uniform(kb, (batch, 784)))[:nv],
                      "iwae_eps": t(jax.random.normal(k1, (batch, ssz, Z)))[:nv],
                      "elbo_eps": t(jax.random.normal(k2, (batch, Z)))[:nv]})
    return draws


def test_evaluate_iwae_vae_matches_jax_with_a_short_tail():
    """37 items at batch 16 (a 5-item tail), binarized per batch."""
    jm, p, tm = build("mnist")
    data, key, ssz = _synthetic_mnist(37, seed=18)[0], jax.random.PRNGKey(19), 8
    w_elbo, w_lp = j_evaluate(jm, p, data, ssz, key, binarize=True, batch=16)
    elbo, lp = t_evaluate(tm, data, ssz, binarize=True, batch=16,
                          draws=_replayed_eval_draws(key, 37, 16, ssz))
    assert np.isfinite(elbo) and np.isfinite(lp) and lp >= elbo - 5.0
    assert abs(lp - w_lp) <= 1e-5 * abs(w_lp), (lp, w_lp)
    assert abs(elbo - w_elbo) <= 1e-5 * abs(w_elbo), (elbo, w_elbo)


def test_evaluate_iwae_vae_is_the_mean_of_per_item_values():
    """11 items at batch 4 (a 3-item tail), at batch 11 and one by one, each
    item with the same draws: the item-weighted means agree, and equal the
    mean of logprob_iwae and -vae_loss per item."""
    _, _, tm = build("mnist")
    data = _synthetic_mnist(11, seed=20)[0]
    g = torch.Generator().manual_seed(1)
    ssz = 8
    per_item = [{"bin": torch.rand(1, 784, generator=g),
                 "iwae_eps": torch.randn(1, ssz, Z, generator=g),
                 "elbo_eps": torch.randn(1, Z, generator=g)} for _ in range(11)]

    def grouped(batch):
        return [{k: torch.cat([d[k] for d in per_item[s:s + batch]])
                 for k in per_item[0]} for s in range(0, 11, batch)]

    runs = [t_evaluate(tm, data, ssz, binarize=True, batch=b, draws=grouped(b))
            for b in (4, 11, 1)]
    (all_d,) = grouped(11)
    x = (all_d["bin"] < torch.from_numpy(data)).float()
    with torch.no_grad():
        lp = tapi.logprob_iwae(tm, x, ssz, reduce="per_item", eps=all_d["iwae_eps"])
        loss = tapi.vae_loss(tm, x, reduce="per_item", eps=all_d["elbo_eps"])[0]
    want = (-float(loss.double().mean()), float(lp.double().mean()))
    for elbo, logprob in runs:
        assert abs(elbo - want[0]) <= 1e-5 * abs(want[0])
        assert abs(logprob - want[1]) <= 1e-5 * abs(want[1])


def test_evaluate_iwae_vae_default_batch_and_generator():
    _, _, tm = build("mnist")
    data = _synthetic_mnist(5, seed=21)[0]
    runs = [t_evaluate(tm, data, 8, torch.Generator().manual_seed(s), binarize=True)
            for s in (2, 2, 3)]
    assert all(np.isfinite(runs).ravel()) and runs[0] == runs[1] != runs[2]
