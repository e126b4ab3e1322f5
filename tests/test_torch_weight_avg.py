"""Weight averaging on the port (train/step.py ``update_weight_avg``, the
averaging slots of train/state.py and io/checkpoint.py) against the JAX
package: the update alone over a 30-step random trajectory, Polyak and SWA,
before and after the start, against JAX ``_update_weight_avg`` (rel 1e-6);
a 4-step ``train_chunk`` of the flagship line at a small width with Polyak
against JAX ``build_train_chunk`` (the averaged model through the
converter, at the step tests' tolerance: every draw injected); the
baseline chunk with Polyak and SWA against JAX ``build_vae_train_step``;
and the checkpoint round trip with the averaging slots, widened and
narrowed as the JAX checkpoint's skeleton is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ardae_tpu.train.state import TrainState as JState
from ardae_tpu.train.step import StepConfig as JCfg
from ardae_tpu.train.step import _update_weight_avg, build_train_chunk
from ardae_tpu.train.vae_step import VAEStepConfig as JVCfg
from ardae_tpu.train.vae_step import build_vae_train_step
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from ardae_tpu_torch.models.registry import build_cdae, build_ivae_model
from ardae_tpu_torch.train import optim as topt
from ardae_tpu_torch.train.state import TrainState, avg_copy, create_train_state
from ardae_tpu_torch.train.step import StepConfig as TCfg
from ardae_tpu_torch.train.step import train_chunk, update_weight_avg
from ardae_tpu_torch.train.vae_step import VAEStepConfig, train_vae_chunk
from test_torch_step import CFG, M_LR, U, _build, _compare_params, _snapshot, _step_draws
from torch_parity import t

START, DECAY, STEPS = 10, 0.9, 30


class _Pair(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3, 4))
        self.b = torch.nn.Parameter(torch.zeros(4))


@pytest.mark.parametrize("mode", ["polyak", "swa"])
def test_update_matches_jax_over_a_trajectory(mode):
    """Step k sets the live parameters to the trajectory's k-th point and
    counts k, then averages: before START the average is the live model,
    from the step counted START on it averages (JAX tests the start after
    its counter moves)."""
    rng = np.random.default_rng(0)
    traj = [{"w": rng.normal(size=(3, 4)).astype(np.float32),
             "b": rng.normal(size=4).astype(np.float32)} for _ in range(STEPS + 1)]
    jcfg = JCfg(weight_avg=mode, weight_avg_start=START, weight_avg_decay=DECAY)
    tcfg = TCfg(weight_avg=mode, weight_avg_start=START, weight_avg_decay=DECAY)
    p0 = {k: jnp.asarray(v) for k, v in traj[0].items()}
    js = JState(step=jnp.zeros([], jnp.int32), params_model=p0, opt_model=(),
                params_cdae={}, opt_cdae=(), avg_params_model=dict(p0),
                avg_count=jnp.zeros([], jnp.int32))
    model = _Pair()
    with torch.no_grad():
        for k, v in traj[0].items():
            getattr(model, k).copy_(t(v))
    ts = create_train_state(model, torch.optim.SGD(model.parameters(), 0.1),
                            weight_avg=mode)
    for step in range(1, STEPS + 1):
        js = js.replace(step=jnp.asarray(step, jnp.int32),
                        params_model={k: jnp.asarray(v) for k, v in traj[step].items()})
        js = _update_weight_avg(jcfg, js)
        with torch.no_grad():
            for k, v in traj[step].items():
                getattr(model, k).copy_(t(v))
        ts.step = step
        update_weight_avg(ts, tcfg)
        assert ts.avg_count == int(js.avg_count) == max(0, step - START + 1)
        for k in ("w", "b"):
            got = getattr(ts.avg_model, k).detach().numpy()
            np.testing.assert_allclose(got, np.asarray(js.avg_params_model[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{k} at {step}")
            live = getattr(model, k).detach().numpy()
            assert np.array_equal(got, live) == (step < START), (k, step)


def test_update_without_averaging_is_a_no_op():
    model = _Pair()
    ts = create_train_state(model, torch.optim.SGD(model.parameters(), 0.1))
    assert ts.avg_model is None and ts.avg_count is None
    ts.step = 5
    update_weight_avg(ts, TCfg(weight_avg="polyak", weight_avg_start=0))
    assert ts.avg_model is None and ts.eval_model is model


def test_train_chunk_with_polyak_matches_jax():
    """Four joint steps of the flagship line at a small width with Polyak
    from step 2 (decay 0.9): the averaged model against the JAX chunk's
    ``avg_params_model``, as test_torch_step.py holds the live one."""
    (jm, jd, opt_m, opt_d, jstate), ts = _build()
    jstate = jstate.replace(
        avg_params_model=jax.tree.map(jnp.array, jstate.params_model),
        avg_count=jnp.zeros([], jnp.int32))
    ts.avg_model, ts.avg_count = avg_copy(ts.model), 0
    wa = dict(weight_avg="polyak", weight_avg_start=2, weight_avg_decay=DECAY)
    data = (_synthetic_mnist(24, seed=6)[0] > 0.5).astype(np.float32)
    rng = np.random.default_rng(7)
    cidx = rng.integers(0, 24, (4, U, 4)).astype(np.int32)
    midx = rng.integers(0, 24, (4, 4)).astype(np.int32)
    key = jax.random.PRNGKey(8)
    before = _snapshot(ts.model)
    chunk = build_train_chunk(jm, jd, opt_m, opt_d, JCfg(**CFG, **wa))
    jstate2, _ = chunk(jstate, jnp.asarray(data), cidx, midx, key, 1.0)
    draws = [{"step": _step_draws(jm, key, s)} for s in range(4)]
    train_chunk(ts, TCfg(**CFG, **wa), t(data), cidx, midx, None,
                lambda step: 1.0, draws=draws)
    assert ts.step == 4 and ts.avg_count == int(jstate2.avg_count) == 3
    _compare_params(jstate2.params_model, ts.model, before, 4 * M_LR, 1.0, "model")
    _compare_params(jstate2.avg_params_model, ts.avg_model, before, 4 * M_LR, 1.0,
                    "averaged model")
    moved = [float((a - p).detach().abs().max()) for a, p in
             zip(ts.avg_model.parameters(), ts.model.parameters())]
    assert max(moved) > 0   # the average lags the live model


@pytest.mark.parametrize("mode", ["polyak", "swa"])
def test_baseline_chunk_with_averaging_matches_jax(mode):
    """Four steps of the mlp baseline (h 16, z 4) with averaging from step
    2: JAX's step (cli/vae.py's chunk body) against ``train_vae_chunk``."""
    from ardae_tpu.train import optim as jopt
    from torch_vae_cases import Z, binary, build, fresh

    jm, p, _ = build("mnist")
    tm = fresh("mnist", p)
    lr, scale, bs = 1e-3, 1.0 / 784, 4
    wa = dict(weight_avg=mode, weight_avg_start=2, weight_avg_decay=DECAY)
    tx = jopt.build_optimizer("adam", lr, beta1=0.9)
    jstate = JState(step=jnp.zeros([], jnp.int32), params_model=p,
                    opt_model=tx.init(p), params_cdae={}, opt_cdae=(),
                    avg_params_model=jax.tree.map(jnp.array, p),
                    avg_count=jnp.zeros([], jnp.int32))
    ts = create_train_state(tm, topt.build_optimizer("adam", tm.parameters(), lr,
                                                     beta1=0.9), weight_avg=mode)
    data = binary(16, 21)
    idx = np.random.default_rng(22).integers(0, 16, (4, bs))
    key = jax.random.PRNGKey(23)
    before = _snapshot(tm)
    step = build_vae_train_step(jm, tx, JVCfg(loss_scale=scale, **wa))
    draws = []
    for s in range(4):
        jstate, _ = step(jstate, jnp.asarray(data)[idx[s]], key, 1.0)
        draws.append({"eps": t(jax.random.normal(jax.random.fold_in(key, s), (bs, Z)))})
    train_vae_chunk(ts, VAEStepConfig(loss_scale=scale, **wa), t(data), idx, None,
                    lambda s: 1.0, draws=draws)
    assert ts.avg_count == int(jstate.avg_count) == 3
    _compare_params(jstate.params_model, ts.model, before, 4 * lr, 1.0, "model")
    _compare_params(jstate.avg_params_model, ts.avg_model, before, 4 * lr, 1.0,
                    "averaged model")


def _toy_state(weight_avg, seed=0):
    """A tiny mlp-concat IVAE and mlp-grad cdae, each optimizer one step
    in, the averaged model moved off the live one."""
    model = build_ivae_model("mlp-concat", z_dim=2, h_dim=8, n_dim=3, seed=seed,
                             device="cpu")
    cdae = build_cdae("mlp-grad", input_dim=2, context_dim=2, h_dim=8, n_layers=1,
                      seed=seed + 1, device="cpu")
    opts = [topt.build_optimizer("adam", m.parameters(), 1e-3, beta1=0.9)
            for m in (model, cdae)]
    g = torch.Generator().manual_seed(seed)
    for net, o in zip((model, cdae), opts):
        for p in net.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        o.step()
    state = create_train_state(model, opts[0], cdae, opts[1], weight_avg=weight_avg)
    if state.avg_model is not None:
        with torch.no_grad():
            for p in state.avg_model.parameters():
                p.add_(torch.randn(p.shape, generator=g))
        state.avg_count, state.step = 5, 9
    return state


def _params(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_checkpoint_round_trip_with_the_averaging_slots(tmp_path):
    saved = _toy_state("polyak")
    save_checkpoint(saved, {"i_ep": 9}, str(tmp_path))
    fresh = _toy_state("polyak", seed=3)
    load_checkpoint(fresh, str(tmp_path))
    assert fresh.step == 9 and fresh.avg_count == 5
    for a, b in ((fresh.model, saved.model), (fresh.avg_model, saved.avg_model),
                 (fresh.cdae, saved.cdae)):
        got, want = _params(a), _params(b)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert fresh.eval_model is fresh.avg_model
    assert not any(p.requires_grad for p in fresh.avg_model.parameters())


def test_checkpoint_widens_and_narrows_the_averaging_slots(tmp_path, capsys):
    """A state built without averaging takes the slots of a run saved with
    it; one built with them drops them for a run saved without, and then
    evaluates its live model (the JAX checkpoint's two messages)."""
    with_avg, without = _toy_state("polyak"), _toy_state("none")
    save_checkpoint(with_avg, {"i_ep": 9}, str(tmp_path), "avg")
    save_checkpoint(without, {"i_ep": 0}, str(tmp_path), "plain")

    widened = _toy_state("none", seed=4)
    load_checkpoint(widened, str(tmp_path), "avg")
    assert "widened the skeleton" in capsys.readouterr().out
    assert widened.avg_count == 5
    got, want = _params(widened.avg_model), _params(with_avg.avg_model)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert widened.eval_model is widened.avg_model

    narrowed = _toy_state("polyak", seed=5)
    load_checkpoint(narrowed, str(tmp_path), "plain")
    assert "narrowed the skeleton" in capsys.readouterr().out
    assert narrowed.avg_model is None and narrowed.avg_count is None
    assert narrowed.eval_model is narrowed.model
    assert "avg_model" not in narrowed.state_dict()


def test_checkpoint_other_mismatches_raise(tmp_path):
    """A checkpoint of another structure is not adjusted: a state with a
    cdae reading a baseline's checkpoint raises, as does a wider model."""
    model = build_ivae_model("mlp-concat", z_dim=2, h_dim=8, n_dim=3, device="cpu")
    baseline = create_train_state(
        model, topt.build_optimizer("adam", model.parameters(), 1e-3, beta1=0.9),
        weight_avg="swa")
    save_checkpoint(baseline, {"i_ep": 0}, str(tmp_path), "baseline")
    with pytest.raises(KeyError):
        load_checkpoint(_toy_state("swa"), str(tmp_path), "baseline")
    wide = build_ivae_model("mlp-concat", z_dim=2, h_dim=16, n_dim=3, device="cpu")
    wide_state = TrainState(0, wide, topt.build_optimizer(
        "adam", wide.parameters(), 1e-3, beta1=0.9))
    save_checkpoint(wide_state, {"i_ep": 0}, str(tmp_path), "wide")
    with pytest.raises(RuntimeError):
        load_checkpoint(_toy_state("none"), str(tmp_path), "wide")
