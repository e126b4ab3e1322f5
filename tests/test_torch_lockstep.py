"""Both drivers' training loops in lockstep, port against JAX, over hundreds
of steps: the aux baseline's chunk (ardae_tpu/cli/vae.py:224-255) against
train/vae_step.py ``train_vae_chunk``, and the joint chunk JAX's implicit
driver builds (ardae_tpu/train/step.py ``build_train_chunk``, called at
ardae_tpu/cli/ivae_ardae.py:341) against train/step.py ``train_chunk``.

Each side is built as its driver builds it, from the same flags parsed by
its own driver's parser: the JAX side as the JAX driver does (registry,
``PRNGKey(seed)`` split, ``init``, optimizers), the port's through its
driver's ``build_state``, then loaded with JAX's init (convert.py). Both
take the same ``IndexStream`` batches of a small gray surrogate, binarized
on each step, and every draw is JAX's, made from the keys its loop folds
in and injected (``draws=``). The JAX side scans a chunk at a time; the
port runs the same steps one ``draws`` list each, so each step's metrics
can be read. Cases: the aux baseline (the h2h-auxmnist-baseline flags of
cli/parity_common.py, cut to h 32, noise 16, z 8, bs 8) over 300 steps;
the flagship line scripts/run_vae_dbmnist.sh:35 (resconvct-res + mlp-res,
ctx lt0, 2 cdae updates a step, ``--use-kernels``: on CPU tensors the res
kernel's plain version, which the kernel is held to on the card) cut to z
8, noise 10, h 32, cdae h 32 x 2, bs 2, nz_cdae 8, over 200 steps; and,
marked slow, the aux baseline at the head-to-head's own widths (784-300-300,
noise 100, z 32, bs 32, lr 1e-4, Adam beta1 0.5) over 2,500 steps.

Tolerances. The baseline's loop is stable: the two frameworks round each
step's sums differently (~1e-7 relative) and Adam carries that into the
weights, where it grows slowly. So every step's loss and ELBO within rel
1e-4 of JAX's; every ``CHUNK`` steps each weight tensor within a relative
norm of 1e-4 of JAX's, and the whole model's distance from JAX's within
1e-3 of the distance JAX's weights have moved from the init.

The flagship's joint loop is not: in JAX itself, an init half an ulp away
(each weight times 1 + 2**-24 N(0, 1)) moves the weights 4e-2 of their
distance travelled by step 20 and 0.4-0.7 by step 200 (std-scale 100 and
m-lr 1e-3 amplify each step's rounding by ~1.5). No fixed tolerance holds
such a run, so it is held against that control, a second JAX run from the
nudged init: the first ``EARLY`` steps' metrics within rel ``EARLY_RTOL``
of JAX's (measured worst 2.9e-05); every ``JOINT_CHUNK`` steps the model's
and the cdae's distance from JAX's weights within ``CTRL_X`` times the
control's (measured worst ratio 1.18); and each metric's median over the
chunks of its largest deviation within ``CTRL_X`` times the control's
(measured worst 1.66). A tenth of a percent on sigma fails the early bound
by step 4.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ardae_tpu.cli import ivae_ardae as j_ivae_cli
from ardae_tpu.cli import vae as j_vae_cli
from ardae_tpu.cli.common import IndexStream as JIndexStream
from ardae_tpu.core.annealing import annealing_func as j_annealing
from ardae_tpu.models import registry as jreg
from ardae_tpu.models.ivae import api as j_ivae_api
from ardae_tpu.models.vae.aux import aux_vae_loss
from ardae_tpu.train.optim import build_optimizer as j_build_optimizer
from ardae_tpu.train.state import TrainState as JState
from ardae_tpu.train.state import create_train_state as j_create_state
from ardae_tpu.train.step import StepConfig as JCfg
from ardae_tpu.train.step import _update_weight_avg, build_train_chunk
from ardae_tpu_torch.cli import ivae_ardae as t_ivae_cli
from ardae_tpu_torch.cli import vae as t_vae_cli
from ardae_tpu_torch.cli.common import IndexStream as TIndexStream
from ardae_tpu_torch.cli.parity_common import AUXMNIST_BASELINE
from ardae_tpu_torch.convert import flax_to_state_dict, load_flax_params
from ardae_tpu_torch.core.annealing import annealing_func as t_annealing
from ardae_tpu_torch.data.mnist import _synthetic_mnist
from ardae_tpu_torch.train.step import StepConfig as TCfg
from ardae_tpu_torch.train.step import train_chunk
from ardae_tpu_torch.train.vae_step import VAEStepConfig, train_vae_chunk
from torch_parity import t

CHUNK = 100
METRIC_RTOL, PARAM_REL, MOVE_REL = 1e-4, 1e-4, 1e-3
JOINT_CHUNK, CTRL_X, FLOOR, EARLY, EARLY_RTOL = 20, 4.0, 1e-5, 5, 2e-4
N_DATA = 512  # epochs of 64 (bs 8) or 256 (bs 2) batches: the stream reshuffles
SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "run_vae_dbmnist.sh")


def _flagship_argv():
    """scripts/run_vae_dbmnist.sh:35's flags, after the module name."""
    with open(SCRIPT) as f:
        line = f.read().splitlines()[34]
    return line.split("ardae_tpu.cli.ivae_ardae", 1)[1].split()


def _annealed(opt):
    """Both drivers' reading of an annealing length under 1: none."""
    for name in ("beta_annealing", "eta_annealing", "lmbd_annealing"):
        if hasattr(opt, name) and (getattr(opt, name) is None or getattr(opt, name) < 1):
            setattr(opt, name, None)
    return opt


def _data():
    return _synthetic_mnist(N_DATA, seed=21)[0]


class _Streams:
    """Both packages' index streams, seeded as both drivers seed theirs
    (seed + 1); every take must be the same."""

    def __init__(self, opt):
        self.j = JIndexStream(N_DATA, opt.train_batch_size, seed=opt.seed + 1)
        self.p = TIndexStream(N_DATA, opt.train_batch_size, seed=opt.seed + 1)

    def take(self, k):
        want, got = self.j.take(k), self.p.take(k)
        np.testing.assert_array_equal(got, want)
        return want


def _rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _hold_params(jparams, module, init, where):
    """Each tensor within PARAM_REL of JAX's, and the whole distance from
    JAX's within MOVE_REL of the distance JAX's weights moved from init."""
    want = flax_to_state_dict(jparams, module)
    got = module.state_dict()
    worst = max(_rel(got[k], want[k]) for k in want)
    err, moved = _distance(got, want), _distance(want, init)
    assert worst <= PARAM_REL, (where, worst)
    assert err <= MOVE_REL * moved, (where, err / moved)


def _distance(a, b):
    """The whole model's distance between two state dicts."""
    return sum(float(((a[k] - b[k]) ** 2).sum()) for k in b) ** 0.5


def _hold_metrics(got, want, where):
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=1e-6,
                                   err_msg=f"{where} {k}")


# --- the aux baseline's loop ------------------------------------------------

def _jax_vae_chunk(model, tx, scale, beta_fn, wa_cfg):
    """ardae_tpu/cli/vae.py:224-255's chunk_fn for an aux model in fp32,
    with binarization: the driver's loop body as it stands there."""

    @jax.jit
    def chunk_fn(state, data, m_idx, key):
        def body(state, idx):
            k = jax.random.fold_in(key, state.step)
            batch = jnp.take(data, idx, axis=0)
            batch = jax.random.bernoulli(jax.random.fold_in(k, 7), batch).astype(
                jnp.float32)
            beta = beta_fn(state.step)

            def loss_f(p):
                loss, terms = aux_vae_loss(model, p, k, batch, beta=beta,
                                           compute_dtype=None)
                return scale * loss, terms

            (loss, terms), grads = jax.value_and_grad(loss_f, has_aux=True)(
                state.params_model)
            updates, opt_state = tx.update(grads, state.opt_model,
                                           state.params_model)
            new_params = jax.tree.map(lambda p, u: p + u, state.params_model,
                                      updates)
            state = state.replace(step=state.step + 1, params_model=new_params,
                                  opt_model=opt_state)
            state = _update_weight_avg(wa_cfg, state)
            return state, {"loss": loss, "recon_loss": terms["recon"],
                           "kld_loss": terms["kld"]}

        return jax.lax.scan(body, state, m_idx)

    return chunk_fn


def _vae_draws(key, steps, bs, n_dim, z_dim):
    """Each step's draws as the loop body makes them: k = fold_in(key,
    step); the Bernoulli uniforms from fold_in(k, 7); aux_vae_loss's
    (eps0, eps) from split(k)."""
    def one(s):
        k = jax.random.fold_in(key, s)
        k0, k1 = jax.random.split(k)
        return (jax.random.uniform(jax.random.fold_in(k, 7), (bs, 784)),
                jax.random.normal(k0, (bs, n_dim)), jax.random.normal(k1, (bs, z_dim)))
    u, e0, e1 = jax.jit(jax.vmap(one))(jnp.arange(steps))
    return [{"bin": t(u[s]), "eps": (t(e0[s]), t(e1[s]))} for s in range(steps)]


def _baseline_lockstep(argv, steps):
    jo = _annealed(j_vae_cli.build_parser().parse_args(argv))
    to = _annealed(t_vae_cli.build_parser().parse_args(argv + ["--no-cuda"]))
    bs = jo.train_batch_size
    # the JAX driver's model, init and optimizer (ardae_tpu/cli/vae.py:186-212)
    model = jreg.build_vae_model(
        jo.model, nchannels=jo.nchannels, nheight=jo.nheight, z_dim=jo.model_z_dim,
        h_dim=jo.model_h_dim, n_dim=jo.model_n_dim, n_layers=jo.model_n_layers,
        nonlin=jo.model_nonlin, clip_logvar=jo.model_clip_logvar)
    assert model.family == "aux_gaussian_posterior"
    k_init, k_train, _ = jax.random.split(jax.random.PRNGKey(jo.seed), 3)
    params = jax.jit(model.init)(k_init, jnp.zeros((bs, 784), jnp.float32))
    tx = j_build_optimizer(jo.optimizer, jo.lr, beta1=jo.beta1, momentum=jo.momentum)
    jstate = JState(step=jnp.zeros([], jnp.int32), params_model=params,
                    opt_model=tx.init(params), params_cdae={}, opt_cdae=(),
                    avg_params_model=None, avg_count=None)
    scale = 1.0 / 784
    chunk = _jax_vae_chunk(
        model, tx, scale,
        lambda s: j_annealing(jo.beta_init, jo.beta_fin, jo.beta_annealing, s),
        JCfg(weight_avg=jo.weight_avg))

    # the port's, through its driver's build_state, from JAX's init
    ts = t_vae_cli.build_state(to, "cpu")
    load_flax_params(ts.model, params)
    init = {k: v.clone() for k, v in ts.model.state_dict().items()}
    cfg = VAEStepConfig(loss_scale=scale, compute_dtype=to.model_compute_dtype,
                        weight_avg=to.weight_avg)
    beta_fn = lambda s: t_annealing(to.beta_init, to.beta_fin,  # noqa: E731
                                    to.beta_annealing, s)

    data = _data()
    idx = _Streams(jo).take(steps)  # the driver's stream.take(k), chunk by chunk
    draws = _vae_draws(k_train, steps, bs, jo.model_n_dim, jo.model_z_dim)
    data_j, data_t = jnp.asarray(data), torch.from_numpy(data)
    for c0 in range(0, steps, CHUNK):
        n = min(CHUNK, steps - c0)
        jstate, jm = chunk(jstate, data_j, jnp.asarray(idx[c0:c0 + n]), k_train)
        want = {"loss": np.asarray(jm["loss"]),
                "elbo": -(np.asarray(jm["recon_loss"]) + np.asarray(jm["kld_loss"]))}
        got = {"loss": [], "elbo": []}
        for s in range(c0, c0 + n):
            m = train_vae_chunk(ts, cfg, data_t, idx[s:s + 1], None, beta_fn,
                                binarize=True, draws=[draws[s]])
            for k in got:
                got[k].append(float(m[k]))
        got = {k: np.asarray(v) for k, v in got.items()}
        _hold_metrics(got, want, f"steps {c0}-{c0 + n}")
        _hold_params(jstate.params_model, ts.model, init, f"step {c0 + n}")
    assert ts.step == steps


BASELINE_SMALL = ["--model-h-dim", "32", "--model-n-dim", "16", "--model-z-dim", "8",
                  "--train-batch-size", "8"]


def test_aux_baseline_loop_in_lockstep():
    """300 steps of the auxmnist baseline at h 32, noise 16, z 8, bs 8.
    Measured worst: loss / ELBO rel 3.4e-06, a tensor 1.0e-05, the
    distance moved 7.1e-06."""
    _baseline_lockstep(AUXMNIST_BASELINE + BASELINE_SMALL, 300)


@pytest.mark.slow
def test_aux_baseline_loop_in_lockstep_at_head_to_head_widths():
    """2,500 steps at h2h-auxmnist-baseline's own flags (784-300-300, noise
    100, z 32, bs 32, lr 1e-4, Adam beta1 0.5): the whole head-to-head's
    training. Measured worst: loss / ELBO rel 2.8e-06, a tensor 1.3e-05,
    the distance moved 1.0e-05."""
    _baseline_lockstep(list(AUXMNIST_BASELINE), 2500)


# --- the main path's joint loop ----------------------------------------------

FLAGSHIP_SMALL = ["--model-z-dim", "8", "--model-n-dim", "10", "--model-h-dim", "32",
                  "--cdae-h-dim", "32", "--cdae-n-layers", "2", "--train-nz-cdae", "8",
                  "--train-batch-size", "2"]


def _joint_draws(key, steps, cfg, bs, n_dim, z_dim):
    """Each step's draws as build_train_chunk's body and _one_step make them
    (ardae_tpu/train/step.py): k = fold_in(key, step); the Bernoulli
    uniforms from split(fold_in(k, 1_000_003)); cdae update i's k_lat,
    k_std, k_noise from split(fold_in(k, i), 3); the model update's k_fwd
    from split(fold_in(k, 1000))."""
    u, nz = cfg.num_cdae_updates, cfg.train_nz_cdae

    def one(s):
        k = jax.random.fold_in(key, s)
        kb1, kb2 = jax.random.split(jax.random.fold_in(k, 1_000_003))
        cd = []
        for i in range(u):
            k_lat, k_std, k_noise = jax.random.split(jax.random.fold_in(k, i), 3)
            cd.append((jax.random.normal(k_lat, (bs * nz, n_dim)),
                       jax.random.normal(k_std, (bs, nz, 1)),
                       jax.random.normal(k_noise, (bs * nz, z_dim))))
        k_fwd, _ = jax.random.split(jax.random.fold_in(k, 1000))
        return (jax.random.uniform(kb1, (u, bs, 784)), jax.random.uniform(kb2, (bs, 784)),
                cd, jax.random.normal(k_fwd, (bs, n_dim)))
    b1, b2, cd, me = jax.jit(jax.vmap(one))(jnp.arange(steps))
    return [{"bin_cdae": t(b1[s]), "bin_model": t(b2[s]),
             "step": {"cdae": [{"latent_eps": t(lat[s]), "std": t(std[s]),
                                "dsm_eps": t(noise[s])} for lat, std, noise in cd],
                      "model": {"eps": t(me[s])}}}
            for s in range(steps)]


def test_flagship_joint_loop_in_lockstep():
    """200 steps of the main path's joint loop at a small width of :35, the
    port with --use-kernels (the res kernel's plain version on the CPU)."""
    steps = 200
    argv = _flagship_argv() + FLAGSHIP_SMALL
    jo = _annealed(j_ivae_cli.build_parser().parse_args(argv))
    to = _annealed(t_ivae_cli.build_parser().parse_args(
        argv + ["--no-cuda", "--use-kernels"]))
    assert (jo.model, jo.cdae, jo.cdae_ctx_type, jo.num_cdae_updates) == (
        "resconvct-res", "mlp-res", "lt0", 2)
    bs = jo.train_batch_size
    # the JAX driver's build (ardae_tpu/cli/ivae_ardae.py:277-341)
    model = jreg.build_ivae_model(
        jo.model, nchannels=jo.nchannels, nheight=jo.nheight, z_dim=jo.model_z_dim,
        h_dim=jo.model_h_dim, n_dim=jo.model_n_dim, n_layers=jo.model_n_layers,
        nonlin=jo.model_nonlin, clip_z0_logvar=jo.model_clip_z0_logvar,
        clip_z_logvar=jo.model_clip_z_logvar)
    ctx_dim = jreg.context_dim_for(jo.cdae_ctx_type, model_name=jo.model,
                                   nchannels=jo.nchannels, nheight=jo.nheight,
                                   z_dim=jo.model_z_dim, h_dim=jo.model_h_dim)
    cdae = jreg.build_cdae(jo.cdae, input_dim=jo.model_z_dim, context_dim=ctx_dim,
                           h_dim=jo.cdae_h_dim, n_layers=jo.cdae_n_layers,
                           nonlin=jo.cdae_nonlin)
    k_init_m, k_init_d, k_train, _ = jax.random.split(jax.random.PRNGKey(jo.seed), 4)
    x0 = jnp.zeros((bs, 784), jnp.float32)
    # jitted: one compile, not one an operation
    params_model = jax.jit(model.init)(k_init_m, x0,
                                       j_ivae_api.make_eps(model, k_init_m, bs, 1))
    params_cdae = jax.jit(cdae.init)(k_init_d, jnp.zeros((4, jo.model_z_dim)),
                                     jnp.zeros((4, ctx_dim)), jnp.zeros((4, 1)))
    opt_m = j_build_optimizer(jo.m_optimizer, jo.m_lr, beta1=jo.m_beta1,
                              momentum=jo.d_momentum)
    opt_d = j_build_optimizer(jo.d_optimizer, jo.d_lr, beta1=jo.d_beta1,
                              momentum=jo.d_momentum)
    jstate = j_create_state(params_model, opt_m, params_cdae, opt_d,
                            weight_avg=jo.m_weight_avg)
    # the control: JAX again, from an init half an ulp away
    rng = np.random.default_rng(0)
    nudge = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: a * (1 + 2.0 ** -24 * rng.standard_normal(a.shape).astype(np.float32)),
        tree)
    cstate = j_create_state(nudge(params_model), opt_m, nudge(params_cdae), opt_d,
                            weight_avg=jo.m_weight_avg)
    jcfg = JCfg(std_scale=jo.std_scale, delta=jo.delta,
                num_cdae_updates=jo.num_cdae_updates, train_nz_cdae=jo.train_nz_cdae,
                train_nstd_cdae=jo.train_nstd_cdae, train_nz_model=jo.train_nz_model,
                ctx_type=jo.cdae_ctx_type, weight_avg=jo.m_weight_avg,
                weight_avg_start=jo.m_weight_avg_start,
                weight_avg_decay=jo.m_weight_avg_decay,
                cdae_compute_dtype=jo.cdae_compute_dtype,
                model_compute_dtype=jo.model_compute_dtype)
    chunk = build_train_chunk(
        model, cdae, opt_m, opt_d, jcfg,
        beta_fn=lambda s: j_annealing(jo.beta_init, jo.beta_fin, jo.beta_annealing, s))

    # the port's, through its driver's build_state, from JAX's init
    ts, t_ctx = t_ivae_cli.build_state(to, "cpu")
    assert t_ctx == ctx_dim
    load_flax_params(ts.model, params_model)
    load_flax_params(ts.cdae, params_cdae)
    init_m = {k: v.clone() for k, v in ts.model.state_dict().items()}
    init_d = {k: v.clone() for k, v in ts.cdae.state_dict().items()}
    tcfg = TCfg(std_scale=to.std_scale, delta=to.delta,
                num_cdae_updates=to.num_cdae_updates, train_nz_cdae=to.train_nz_cdae,
                train_nstd_cdae=to.train_nstd_cdae, train_nz_model=to.train_nz_model,
                ctx_type=to.cdae_ctx_type, use_kernels=to.use_kernels,
                cdae_compute_dtype=to.cdae_compute_dtype,
                model_compute_dtype=to.model_compute_dtype,
                weight_avg=to.m_weight_avg, weight_avg_start=to.m_weight_avg_start,
                weight_avg_decay=to.m_weight_avg_decay)
    beta_fn = lambda s: t_annealing(to.beta_init, to.beta_fin,  # noqa: E731
                                    to.beta_annealing, s)

    data = _data()
    u = jo.num_cdae_updates
    streams = _Streams(jo)
    draws = _joint_draws(k_train, steps, jcfg, bs, jo.model_n_dim, jo.model_z_dim)
    data_j, data_t = jnp.asarray(data), torch.from_numpy(data)
    port_dev, ctrl_dev = collections.defaultdict(list), collections.defaultdict(list)
    for c0 in range(0, steps, JOINT_CHUNK):
        n = min(JOINT_CHUNK, steps - c0)
        # a chunk's cdae batches, then its model batches (ivae_ardae.py:526-528)
        c_idx = streams.take(n * u).reshape(n, u, bs)
        m_idx = streams.take(n)
        ci, mi = jnp.asarray(c_idx), jnp.asarray(m_idx)
        jstate, jm = chunk(jstate, data_j, ci, mi, k_train, 1.0, binarize=True)
        cstate, cm = chunk(cstate, data_j, ci, mi, k_train, 1.0, binarize=True)
        got = {k: [] for k in jm}
        for s in range(c0, c0 + n):
            i = s - c0
            m = train_chunk(ts, tcfg, data_t, c_idx[i:i + 1], m_idx[i:i + 1], None,
                            beta_fn, binarize=True, draws=[draws[s]])
            for k in got:
                got[k].append(float(m[k]))
        where = f"steps {c0}-{c0 + n}"
        for k, v in jm.items():
            ref = np.abs(np.asarray(v)) + 1e-6
            dev = np.abs(np.asarray(got[k]) - np.asarray(v)) / ref
            if c0 == 0:
                assert np.all(dev[:EARLY] <= EARLY_RTOL), (k, dev[:EARLY])
            port_dev[k].append(dev.max())
            ctrl_dev[k].append(np.max(np.abs(np.asarray(cm[k]) - np.asarray(v)) / ref))
        for name, module, init in (("model", ts.model, init_m), ("cdae", ts.cdae, init_d)):
            want = flax_to_state_dict(getattr(jstate, f"params_{name}"), module)
            ctrl = flax_to_state_dict(getattr(cstate, f"params_{name}"), module)
            port_d, ctrl_d = _distance(module.state_dict(), want), _distance(ctrl, want)
            moved = _distance(want, init)
            assert port_d <= CTRL_X * ctrl_d + FLOOR * moved, (where, name, port_d, ctrl_d)
    for k in port_dev:
        port, ctrl = np.median(port_dev[k]), np.median(ctrl_dev[k])
        assert port <= CTRL_X * ctrl + FLOOR, (k, port, ctrl)
    assert ts.step == steps
