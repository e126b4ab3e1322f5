"""Data and sample parallelism of the port (ardae_tpu_torch/parallel/, the
mesh in train/step.py and train/vae_step.py) on CPU ranks over gloo,
against JAX's sharded steps on conftest's virtual CPU devices
(tests/test_parallel.py's twin) and against the port's own world of one.

The ranks run the package's workers (parallel/workers.py) through
parallel/launch.py: rank 0 in this process, the others spawned, so no
child imports jax or this module. Every draw of a port-vs-JAX step is
made by jax.random from the keys JAX's step derives (step.py:148, :229,
:295-307; vae_step.py:34) at the global batch's shape and injected; the
ranks slice it, as ``jax.random`` under a sharding gives the unsharded
values.

Tolerances: JAX's own for a sharded step (tests/test_parallel.py:113-120):
parameters rtol 2e-4 / atol 2e-6, metrics rel 1e-4; the ranks' replicas
bit for bit equal; a resumed run bit for bit equal to an uninterrupted one
(the same world sums in the same order). One exception, the mnist-conv
step against JAX: Adam's first step is lr * g / (|g| + eps), so an element
whose gradient lies near eps moves by a sizeable part of lr on a
rounding-level difference between the frameworks' gradients; there the
parameters take atol 2e-6 + 1e-2 * lr (measured: 1 element of the 409,600
of fc4_inp 4.8e-6 apart, 4.8e-3 * lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from ardae_tpu.models.cdae import MLPGradCARDAE as JGrad
from ardae_tpu.models.cdae.cardae import cdae_loss as j_cdae_loss
from ardae_tpu.models.ivae.conv import ConvIPVAE as JConvIPVAE
from ardae_tpu.models.ivae.toy import ToyIPVAE as JToy
from ardae_tpu.parallel import mesh as jmesh
from ardae_tpu.train import optim as jopt
from ardae_tpu.train.state import TrainState as JState
from ardae_tpu.train.state import create_train_state as j_state
from ardae_tpu.train.step import StepConfig as JCfg
from ardae_tpu.train.step import build_train_step
from ardae_tpu.train.vae_step import VAEStepConfig as JVCfg
from ardae_tpu.train.vae_step import build_vae_train_step
from ardae_tpu_torch.convert import flax_to_state_dict
from ardae_tpu_torch.models.cdae.cardae import cdae_loss
from ardae_tpu_torch.models.registry import build_cdae, build_ivae_model, build_vae_model
from ardae_tpu_torch.parallel.launch import launch
from ardae_tpu_torch.parallel.mesh import Mesh
from ardae_tpu_torch.parallel.workers import joint_steps, vae_steps
from torch_mesh_resume import resumed_steps
from torch_parity import close, t

KEY = jax.random.PRNGKey(0)
BS, NZ, NZ_M = 32, 8, 2
# tests/test_parallel.py's setup
TOY = dict(nchannels=2, nheight=1, z_dim=2, h_dim=16, n_dim=2, n_layers=2,
           nonlin="relu")
CDAE = dict(input_dim=2, context_dim=2, h_dim=16, n_layers=2, nonlin="relu")
CFG = dict(std_scale=10.0, delta=0.1, num_cdae_updates=1, train_nz_cdae=NZ,
           train_nz_model=NZ_M, ctx_type="data")
MESHES = {"dp2": (2, 1), "dp2xsp2": (2, 2)}


def _cpu(n):
    return ["cpu"] * n


def _jax_mesh(dp, sp):
    return jmesh.make_mesh(dp) if sp == 1 else jmesh.sample_parallel_mesh(dp, sp)


def test_mesh_layout_is_jax_s():
    """Rank r = d * sp + s holds the block JAX's NamedSharding(P("data",
    "sample")) gives device r of the mesh, at every mesh shape used here
    and on the card (chip_smoke.py: (2, 1), (1, 5), (2, 2), (4, 1))."""
    for dp, sp in ((2, 1), (2, 2), (1, 5), (4, 1), (2, 4)):
        jm = _jax_mesh(dp, sp)
        spec = P("data", "sample") if sp > 1 else P("data", None)
        index = NamedSharding(jm, spec).devices_indices_map((8 * dp, 5 * sp))
        flat = list(np.asarray(jm.devices).reshape(-1))
        for rank, dev in enumerate(flat):
            mesh = Mesh(dp, sp, rank, torch.device("cpu"))
            items, samples = index[dev]
            assert mesh.items(8 * dp) == slice(items.start or 0, items.stop or 8 * dp)
            assert mesh.samples(5 * sp) == slice(samples.start or 0,
                                                samples.stop or 5 * sp)


def test_sample_axis_dsm_loss_matches_jax():
    """tests/test_parallel.py:67-95: the DSM loss over (data, sample)
    blocks of a (2, 4) mesh, each rank's mean over its block with its rows
    of the global noise, averaged over the ranks, equals JAX's loss on the
    sharded latents (and the unsharded one)."""
    jd = JGrad(input_dim=2, context_dim=2, h_dim=16, num_hidden_layers=2,
               nonlinearity="relu")
    params = jd.init(KEY, jnp.zeros((4, 2)), jnp.zeros((4, 2)), jnp.zeros((4, 1)))
    latent = jax.random.normal(KEY, (8, 16, 2))
    ctx = jax.random.normal(KEY, (8, 2))
    std = 0.2 * jnp.abs(jax.random.normal(KEY, (8, 16, 1)))
    jm = jmesh.sample_parallel_mesh(2, 4)
    with jm:
        want = jax.jit(lambda p, l, c, s: j_cdae_loss(jd, p, KEY, l, c, s))(
            params, jax.device_put(latent, NamedSharding(jm, P("data", "sample"))),
            jax.device_put(ctx, NamedSharding(jm, P("data"))),
            jax.device_put(std, NamedSharding(jm, P("data", "sample"))))
    td = build_cdae("mlp-grad", **CDAE, device="cpu")
    td.load_state_dict(flax_to_state_dict(params, td))
    eps = t(jax.random.normal(KEY, (8 * 16, 2))).reshape(8, 16, 2)
    parts = []
    for rank in range(8):
        mesh = Mesh(2, 4, rank, torch.device("cpu"))
        blk = lambda a: mesh.local(a, 0, 1)
        parts.append(cdae_loss(td, blk(t(latent)), mesh.local(t(ctx)), blk(t(std)),
                               eps=blk(eps).reshape(-1, 2)))
    close(torch.stack(parts).mean(), want, 1e-5, 1e-7)


def _toy_jax():
    jm = JToy(input_dim=2, noise_dim=2, h_dim=16, z_dim=2, nonlinearity="relu",
              num_hidden_layers=2, enc_type="concat")
    jd = JGrad(input_dim=2, context_dim=2, h_dim=16, num_hidden_layers=2,
               nonlinearity="relu")
    x = jax.random.normal(KEY, (BS, 2))
    pm = jm.init(KEY, x, jnp.zeros((BS, 2)))
    pd = jd.init(KEY, jnp.zeros((4, 2)), jnp.zeros((4, 2)), jnp.zeros((4, 1)))
    return jm, jd, pm, pd, x


def _state_dicts(pm, pd, model_kw, cdae_kw, model_name="mlp-concat"):
    tm = build_ivae_model(model_name, **model_kw, device="cpu")
    td = build_cdae("mlp-grad", **cdae_kw, device="cpu")
    return {"model": flax_to_state_dict(pm, tm), "cdae": flax_to_state_dict(pd, td)}


def _jax_draws(key, bsz, nz, noise, z, nz_m, updates=1):
    """The draws of one JAX joint step at ``key``, global, as train_chunk's
    per-step draw dict."""
    k_all = jax.random.fold_in(key, 0)
    cdae = []
    for i in range(updates):
        k_lat, k_std, k_noise = jax.random.split(jax.random.fold_in(k_all, i), 3)
        cdae.append({"latent_eps": t(jax.random.normal(k_lat, (bsz * nz, noise))),
                     "std": t(jax.random.normal(k_std, (bsz, nz, 1))),
                     "dsm_eps": t(jax.random.normal(k_noise, (bsz * nz, z)))})
    k_fwd, _ = jax.random.split(jax.random.fold_in(k_all, 1000))
    return {"step": {"cdae": cdae,
                     "model": {"eps": t(jax.random.normal(k_fwd, (bsz * nz_m, noise)))}}}


def _jax_sharded_step(jm, jd, pm, pd, cfg, x, dp, sp, key=KEY):
    opt_m = jopt.build_optimizer("adam", 1e-3, beta1=0.5)
    opt_d = jopt.build_optimizer("rmsprop", 1e-3, momentum=0.5)
    state = j_state(pm, opt_m, pd, opt_d)
    step = build_train_step(jm, jd, opt_m, opt_d, JCfg(**cfg, shard_samples=sp > 1))
    mesh = _jax_mesh(dp, sp)
    with mesh:
        return step(jax.device_put(state, NamedSharding(mesh, P())),
                    jax.device_put(x[None], NamedSharding(mesh, P(None, "data"))),
                    jax.device_put(x, NamedSharding(mesh, P("data"))), key, 1.0)


def _spec(model, cdae, data, cfg, dp, sp, **extra):
    bsz = extra.pop("bsz", len(data))
    spec = {"model": model, "cdae": cdae, "dp": dp, "sp": sp,
            "opt_model": ("adam", 1e-3, dict(beta1=0.5)),
            "opt_cdae": ("rmsprop", 1e-3, dict(momentum=0.5)),
            "cfg": cfg, "beta": 1.0, "data": data,
            "cdae_idx": np.arange(bsz).reshape(1, 1, bsz),
            "model_idx": np.arange(bsz).reshape(1, bsz), "snapshots": (1,)}
    spec.update(extra)
    return spec


def _check_against_jax(results, jstate, jmet, model_kw, cdae_kw, model_name,
                       atol=2e-6):
    tm = build_ivae_model(model_name, **model_kw, device="cpu")
    td = build_cdae("mlp-grad", **cdae_kw, device="cpu")
    snaps = [r["snapshots"][1] for r in results]
    for other in snaps[1:]:  # the replicas stay equal, bit for bit
        for key in ("model", "cdae"):
            for k, v in other[key].items():
                assert torch.equal(v, snaps[0][key][k]), (key, k)
    for key, jp, module in (("model", jstate.params_model, tm),
                            ("cdae", jstate.params_cdae, td)):
        want = flax_to_state_dict(jp, module)
        for k, v in snaps[0][key].items():
            close(v, want[k], 2e-4, atol, msg=f"{key} {k}")
    for k, v in jmet.items():
        close(results[0]["metrics"][0][k], v, 1e-4, 1e-6, msg=k)


@pytest.mark.parametrize("shape", list(MESHES))
def test_joint_step_matches_jax_sharded(shape):
    """The port's joint step on a world of 2 (dp) and of 2 x 2 (dp, sp)
    against JAX's build_train_step on make_mesh(2) / sample_parallel_mesh(2,
    2), tests/test_parallel.py's toy setup."""
    dp, sp = MESHES[shape]
    jm, jd, pm, pd, x = _toy_jax()
    jstate, jmet = _jax_sharded_step(jm, jd, pm, pd, CFG, x, dp, sp)
    spec = _spec(("mlp-concat", TOY), ("mlp-grad", CDAE), t(x), CFG, dp, sp,
                 state=_state_dicts(pm, pd, TOY, CDAE),
                 draws=[_jax_draws(KEY, BS, NZ, 2, 2, NZ_M)])
    results = launch(joint_steps, _cpu(dp * sp), spec)
    _check_against_jax(results, jstate, jmet, TOY, CDAE, "mlp-concat")


def test_kernel_plain_versions_on_a_mesh_match_jax():
    """mnist-conv + mlp-grad with use_kernels on a (2, 2) mesh: each rank's
    phase A takes the grad-style op on its rows, whose CPU dispatch is the
    plain version, against JAX's sharded step, which runs cdae_loss."""
    z, noise, bsz = 8, 10, 4
    jm = JConvIPVAE(z_dim=z, noise_dim=noise)
    jd = JGrad(input_dim=z, context_dim=z, h_dim=16, num_hidden_layers=2,
               nonlinearity="softplus")
    x = (jax.random.uniform(KEY, (bsz, 784)) > 0.5).astype(jnp.float32)
    pm = jax.jit(jm.init)(KEY, x, jnp.zeros((bsz, noise)))
    pd = jd.init(KEY, jnp.zeros((4, z)), jnp.zeros((4, z)), jnp.zeros((4, 1)))
    cfg = dict(CFG, std_scale=100.0, ctx_type="lt0")
    jstate, jmet = _jax_sharded_step(jm, jd, pm, pd, cfg, x, 2, 2)
    model_kw = dict(nchannels=1, nheight=28, z_dim=z, n_dim=noise, nonlin="softplus")
    cdae_kw = dict(input_dim=z, context_dim=z, h_dim=16, n_layers=2, nonlin="softplus")
    spec = _spec(("mnist-conv", model_kw), ("mlp-grad", cdae_kw), t(x),
                 dict(cfg, use_kernels=True), 2, 2,
                 state=_state_dicts(pm, pd, model_kw, cdae_kw, "mnist-conv"),
                 draws=[_jax_draws(KEY, bsz, NZ, noise, z, NZ_M)])
    results = launch(joint_steps, _cpu(4), spec)
    assert results[0]["launches"]["fused_dsm_grad_fwd"] == 0  # the CPU: plain
    _check_against_jax(results, jstate, jmet, model_kw, cdae_kw, "mnist-conv",
                       atol=2e-6 + 1e-2 * 1e-3)


def test_baseline_step_matches_jax_on_two_ranks():
    """The mnist baseline (h 16, z 4) on a world of 2 against JAX's
    build_vae_train_step on make_mesh(2), the batch sharded."""
    from ardae_tpu.models.vae.mnist import MNISTVAE as JMnist

    jm = JMnist(h_dim=16, z_dim=4, num_hidden_layers=2)
    x = (jax.random.uniform(KEY, (8, 784)) > 0.5).astype(jnp.float32)
    p = jax.jit(jm.init)(jax.random.PRNGKey(3), x)
    tx = jopt.build_optimizer("adam", 1e-3, beta1=0.5)
    jstate = JState(step=jnp.zeros([], jnp.int32), params_model=p,
                    opt_model=tx.init(p), params_cdae={}, opt_cdae=())
    step = build_vae_train_step(jm, tx, JVCfg(loss_scale=1.0 / 784))
    mesh = jmesh.make_mesh(2)
    with mesh:
        jstate2, jmet = step(jax.device_put(jstate, NamedSharding(mesh, P())),
                             jax.device_put(x, jmesh.batch_sharding(mesh)), KEY, 0.5)
    kw = dict(h_dim=16, z_dim=4, n_layers=2)
    tm = build_vae_model("mnist", **kw, device="cpu")
    spec = {"model": ("mnist", kw), "dp": 2, "state": {"model": flax_to_state_dict(p, tm)},
            "opt_model": ("adam", 1e-3, dict(beta1=0.5)),
            "cfg": dict(loss_scale=1.0 / 784), "beta": 0.5, "data": t(x),
            "model_idx": np.arange(8).reshape(1, 8), "snapshots": (1,),
            "draws": [{"eps": t(jax.random.normal(jax.random.fold_in(KEY, 0), (8, 4)))}]}
    results = launch(vae_steps, _cpu(2), spec)
    want = flax_to_state_dict(jstate2.params_model, tm)
    for r in results:
        for k, v in r["snapshots"][1]["model"].items():
            close(v, want[k], 2e-4, 2e-6, msg=k)
    for k, v in jmet.items():
        close(results[0]["metrics"][0][k], v, 1e-4, 1e-6, msg=k)


def _generator_spec(dp, sp, **extra):
    """Four joint steps of the toy setup on binarized uniform data, every
    draw from the training generator (seed 7)."""
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.uniform(size=(96, 2)).astype(np.float32))
    spec = _spec(("mlp-concat", dict(TOY, seed=3)), ("mlp-grad", dict(CDAE, seed=4)),
                 data, CFG, dp, sp, binarize=True, seed=7, snapshots=(1, 2, 3, 4))
    spec["cdae_idx"] = rng.integers(0, 96, (4, 1, BS))
    spec["model_idx"] = rng.integers(0, 96, (4, BS))
    spec.update(extra)
    return spec


@pytest.fixture(scope="module")
def one():
    """The generator spec as a world of one, in this process."""
    return joint_steps(torch.device("cpu"), _generator_spec(1, 1))


@pytest.fixture(scope="module")
def grid():
    """The generator spec on a (2, 2) world, and rank 0's all-reduces
    (elements, over a group or the world) in the order it made them."""
    calls = []
    real = dist.all_reduce

    def counting(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        calls.append((t.numel(), group is not None))
        return real(t, op, group, async_op)

    dist.all_reduce = counting
    try:
        return launch(joint_steps, _cpu(4), _generator_spec(2, 2)), calls
    finally:
        dist.all_reduce = real


def _equal_snapshots(a, b):
    for step, snap in a["snapshots"].items():
        for key, sd in snap.items():
            if isinstance(sd, dict):
                _equal_tree(sd, b["snapshots"][step][key], (step, key))


def _equal_tree(a, b, where):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        for k in a:
            _equal_tree(a[k], b[k], (*where, k))
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_tree(x, y, (*where, i))


@pytest.mark.parametrize("shape", list(MESHES))
def test_world_of_n_trains_as_world_of_one(shape, one, grid):
    """With every draw from the generator (binarization, encoder noise,
    sigma draws, DSM noise), 4 steps on a world of N match the same spec as
    a world of one: each rank draws at the global shape and slices, so the
    generators stay in lockstep."""
    dp, sp = MESHES[shape]
    results = (grid[0] if sp > 1 else
               launch(joint_steps, _cpu(dp * sp), _generator_spec(dp, sp)))
    for r in results[1:]:
        _equal_snapshots(r, results[0])
    for step, snap in one["snapshots"].items():
        for key in ("model", "cdae"):
            for k, v in snap[key].items():
                close(results[0]["snapshots"][step][key][k], v, 2e-4, 2e-6,
                      msg=f"step {step} {key} {k}")
    for m, m1 in zip(results[0]["metrics"], one["metrics"]):
        for k, v in m1.items():
            close(m[k], v, 1e-4, 1e-6, msg=k)


def test_baseline_world_of_two_trains_as_world_of_one():
    """The mnist baseline, 3 steps with binarization and posterior draws
    from the generator, on 2 ranks and as a world of one."""
    rng = np.random.default_rng(6)
    spec = {"model": ("mnist", dict(h_dim=16, z_dim=4, n_layers=2, seed=2)),
            "opt_model": ("adam", 1e-3, dict(beta1=0.5)),
            "cfg": dict(loss_scale=1.0 / 784), "beta": 1.0, "seed": 9,
            "data": torch.from_numpy(rng.uniform(size=(40, 784)).astype(np.float32)),
            "model_idx": rng.integers(0, 40, (3, 8)), "binarize": True,
            "snapshots": (3,)}
    one = vae_steps(torch.device("cpu"), spec)
    results = launch(vae_steps, _cpu(2), dict(spec, dp=2))
    _equal_snapshots(results[1], results[0])
    for k, v in one["snapshots"][3]["model"].items():
        close(results[0]["snapshots"][3]["model"][k], v, 2e-4, 2e-6, msg=k)
    for m, m1 in zip(results[0]["metrics"], one["metrics"]):
        for k, v in m1.items():
            close(m[k], v, 1e-4, 1e-6, msg=k)


def test_resume_on_a_mesh_is_bitwise(tmp_path, grid):
    """A (2, 2) run checkpointed after step 2 (rank 0 saves the state and
    the generator through io/checkpoint.py; every rank loads them into a
    fresh state) trains steps 3 and 4 bit for bit as the uninterrupted
    run: the same final state and the same last metrics."""
    resumed = launch(resumed_steps, _cpu(4), _generator_spec(2, 2), 2, str(tmp_path))
    assert (tmp_path / "checkpoint").exists()
    for a, b in zip(resumed, grid[0]):
        assert list(a["snapshots"]) == [4]
        _equal_snapshots(a, b)
        assert a["metrics"] == b["metrics"][-1:]


def test_one_gradient_collective_per_optimizer_step(grid):
    """Rank 0 of the (2, 2) world's all-reduces over 4 steps: each
    optimizer step reduces one flat buffer of every gradient (the model's,
    or the cdae's but its output bias, which gets no gradient in the grad
    style), each cdae update the sigma statistics twice over the sample
    group, and each step its metrics twice, over the world."""
    sizes = [sum(p.numel() for p in m.parameters())
             for m in (build_cdae("mlp-grad", **CDAE, device="cpu"),
                       build_ivae_model("mlp-concat", **TOY, device="cpu"))]
    b_local = BS // 2
    step = [(b_local * 2, True), (b_local * 2, True),   # the sample sums
            (sizes[0] - 1, False), (sizes[1], False),   # the gradients
            (5, False), (2, False)]                     # means, extremes
    assert grid[1] == step * 4
