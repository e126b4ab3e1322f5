"""The benchmark's hierarchical implicit posterior (``auxresconvct`` with
the res AR-DAE on the hidden1a context) on the CPU at smoke widths: the
cell through ``portbench.run``, traced and untraced, against the plain
reference; the reference's sampler and hidden1a feature against the
port's; four faults that the comparison must find (eps0 left out of the
program's draws, beta held at its final value, beta frozen after the first
step, the convolutions' update dropped while their optimizer state moves);
the port's spans and rows counter of the sampling pass and the context;
the step's FLOP count."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import inputs, yardstick
from portbench import reference as R
from portbench.reference import layers
from portbench.tests import tinycopy

CELL = "aux-kernels"
SEED = 3_000_000_041
CONFIG = os.path.join(tinycopy.REPO, "portbench", "configs", "auxresconvct.json")


def _tiny_config():
    """The configuration at smoke widths, with beta annealed over 4 steps in
    place of 50,000: beta moves by a quarter a step within the three checked
    steps, so a program that does not follow the schedule shows there (at
    the published ramp beta moves 2e-5 in those steps)."""
    with open(CONFIG) as f:
        c = json.load(f)
    c.update(train_batch_size=4, train_nz_cdae=8, cdae_h_dim=16, train_rows=64,
             beta_annealing=4)
    return c


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny copy of the benchmark with the new configuration shrunk under
    ``tiny-kernels``, with the full cell's limits."""
    d = str(tmp_path_factory.mktemp("auxresconvct"))
    tinycopy.make(d, "flagship")
    pb = os.path.join(d, "portbench")
    with open(os.path.join(pb, "configs", "aux.json"), "w") as f:
        json.dump(_tiny_config(), f)
    with open(os.path.join(pb, "limits", "auxresconvct-fp32-kernels.json")) as f:
        limits = json.load(f)
    with open(os.path.join(pb, "limits", f"{CELL}.json"), "w") as f:
        json.dump(limits, f)
    path = os.path.join(d, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "aux", "source": "smoke widths",
                             "file": "portbench/configs/aux.json", "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "aux", "traffic": "tiny-kernels",
                               "chips": 1, "why": "tests"})
    for m in bench["per_layer"]:
        m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(bench, f)
    return d


# each fresh interpreter holds torch to two threads, as the suite's workers
# share the machine's cores
RUN = """
import json, sys
import torch
torch.set_num_threads(2)
sys.path.insert(0, '.')
{fault}
from portbench import run
args = run.parse_args(['--workload', {cell!r}, '--seed', '{seed}', '--seconds', '0.05',
                       '--trace', '{trace}'])
print(json.dumps(run.bench(args, require_cuda=False, root='.', out=lambda s: None)))
"""


def _run(root, trace, fault=""):
    """``portbench.run.bench`` on the copy, the card's check skipped, in a
    fresh interpreter (this suite's process has JAX loaded, which the
    harness refuses); ``fault`` is code run first. Returns the result."""
    code = RUN.format(fault=fault, cell=CELL, seed=SEED, trace=trace)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_compares_correct(root, trace):
    result = _run(root, trace)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0
    checks = result["checks"]
    assert checks["cdae_loss_gap"]["value"] <= 1e-6
    assert checks["model_loss_gap"]["value"] <= 1e-6
    assert checks["grad_norm_gap"]["value"] <= 1e-5
    assert checks["delta_norm_gap"]["value"] <= 1e-4
    if trace:
        assert "train_mfu_pct" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"step_ms", "setup_s"}


# faults: code run with ``mp`` a ``pytest.MonkeyPatch``, undone after its run
FAULTS = {
    # the program's encoder draws with eps0 zeroed: z0 at its mean
    "eps0_left_out": """
import torch
from ardae_tpu_torch.models.ivae import api
make_eps = api.make_eps
def without_eps0(module, *a, **k):
    eps0, eps = make_eps(module, *a, **k)
    return torch.zeros_like(eps0), eps
mp.setattr(api, "make_eps", without_eps0)
""",
    # beta at beta_fin from the first step, in place of the schedule
    "beta_held": """
from ardae_tpu_torch.core import annealing
mp.setattr(annealing, "annealing_func", lambda init, fin, steps, step: fin)
""",
    # beta left at the first step's value, as a stale beta after the first fill
    "beta_frozen": """
from ardae_tpu_torch.core import annealing
first = annealing.annealing_func
mp.setattr(annealing, "annealing_func", lambda init, fin, steps, step: first(init, fin, steps, 0))
""",
    # Adam's update dropped for the 4-D leaves (the convolutions) alone, their
    # optimizer state moving as it should
    "conv_weights_unchanged": """
import torch
from ardae_tpu_torch.train import optim
adam_step = optim.TorchAdam.step
def partial(self, *a, **k):
    convs = [p for g in self.param_groups for p in g["params"] if p.dim() == 4]
    kept = [p.detach().clone() for p in convs]
    out = adam_step(self, *a, **k)
    with torch.no_grad():
        for p, v in zip(convs, kept):
            p.copy_(v)
    return out
mp.setattr(optim.TorchAdam, "step", partial)
""",
}

FAULT_RUN = """
import json, sys
import pytest
import torch
torch.set_num_threads(2)
sys.path.insert(0, '.')
from portbench import run
out = {{}}
for name, code in {faults!r}.items():
    mp = pytest.MonkeyPatch()
    exec(code, {{"mp": mp}})
    try:
        args = run.parse_args(['--workload', {cell!r}, '--seed', '{seed}', '--seconds', '0.05',
                               '--trace', '0'])
        out[name] = run.bench(args, require_cuda=False, root='.', out=lambda s: None)
    finally:
        mp.undo()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fault_results(root):
    """Each fault's result, the four runs in one fresh interpreter."""
    code = FAULT_RUN.format(faults=FAULTS, cell=CELL, seed=SEED)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault_results, fault):
    """Each fault reads not correct, and by a number past its limit (not
    only by a chunk that is not finite). At these widths beta_frozen reads
    0.25 in delta_norm_gap and conv_weights_unchanged reads 1 there."""
    result = fault_results[fault]
    assert result["correct"] is False
    assert any(c["limit"] is not None and not (c["value"] is not None
                                               and c["value"] <= c["limit"])
               for c in result["checks"].values()), result["checks"]


def test_reference_follows_the_ports_sampler():
    """``sample_z`` and ``hidden1a`` of the reference against the port's
    ``sample_latents`` and ``encode_hidden_feats``, on seeded weights with
    an injected noise pair, at fp32; and the std-0 encoding."""
    from ardae_tpu_torch.models import registry
    from ardae_tpu_torch.models.ivae import api

    cfg = _tiny_config()
    cpu = torch.device("cpu")
    spec = R.model(cfg).spec(cfg)
    w = inputs.weights(SEED, {"model": spec}, {"model": layers.init_bounds(spec)}, cpu)["model"]
    model = registry.build_ivae_model(
        "auxresconvct", nchannels=1, nheight=28, z_dim=cfg["model_z_dim"], h_dim=0,
        n_dim=cfg["model_n_dim"], n_layers=0, nonlin=cfg["model_nonlin"], device="cpu")
    model.load_state_dict(w)
    g = torch.Generator().manual_seed(7)
    bsz, nz = 4, 8
    x = (torch.rand(bsz, 784, generator=g) < 0.3).float()
    eps = tuple(torch.randn(bsz * nz, wd, generator=g) for wd in R.noise_widths(cfg))
    assert R.noise_widths(cfg) == (100, 32)
    with torch.no_grad():
        port = api.sample_latents(model, x, nz, eps=eps)
        ref = R.model(cfg).sample_z(cfg, w, x, eps)
        torch.testing.assert_close(port, ref, rtol=1e-5, atol=1e-5)
        port_h = api.encode_hidden_feats(model, x)
        ref_h = R.ctx(cfg).context(cfg, R.model(cfg), w, x, None)
        assert ref_h.shape == (bsz, R.ctx(cfg).width(cfg, R.model(cfg))) == (bsz, 450)
        torch.testing.assert_close(port_h, ref_h, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(api.encode_det(model, x), R.encode_det(cfg, w, x),
                                   rtol=1e-5, atol=1e-5)


def test_spans_and_rows_counter():
    """One tiny chunk under the profiler through the benchmark's program:
    ``ardae.context`` and ``ardae.sample.latents`` once an update, each
    inside ``ardae.sample``, and the rows counter at bs x nz an update; no
    count without the profiler."""
    from ardae_tpu_torch.utils import tracing

    from portbench import program as prog

    cfg = _tiny_config()
    with open(os.path.join(tinycopy.REPO, "portbench", "traffic", "fp32-kernels.json")) as f:
        traffic = json.load(f)
    cpu = torch.device("cpu")
    program = prog.Program(cfg, traffic, cpu, SEED)
    data = inputs.images(SEED, cfg["train_rows"], 784, cpu)
    feed = inputs.IndexFeed(SEED, cfg["train_rows"], cfg["train_batch_size"], cpu)
    gen = inputs.generator(SEED, "program", cpu)
    tracing.clear()
    program.chunk(data, feed, gen, 1)
    assert tracing.counted() == [] and tracing.recorded() == []
    steps, updates = 2, cfg["num_cdae_updates"]
    with profile(activities=[ProfilerActivity.CPU]):
        program.chunk(data, feed, gen, steps)
    records = tracing.recorded()
    rows = cfg["train_batch_size"] * cfg["train_nz_cdae"]
    for name in ("ardae.context", "ardae.sample.latents"):
        mine = [r for r in records if r.name == name]
        assert len(mine) == steps * updates, name
        assert all(r.parent == "ardae.sample" for r in mine)
    counts = tracing.counted()
    assert [c.name for c in counts] == ["ardae.sample.latents.rows"] * (steps * updates)
    assert all(c.n == rows for c in counts)
    assert sorted({c.step for c in counts}) == [1, 2]
    latents = sorted((r.t0_ns, r.t1_ns) for r in records if r.name == "ardae.sample.latents")
    assert all(a <= c.t_ns <= b for c, (a, b) in zip(counts, latents))


def test_step_flop():
    """The joint step's FLOP of the new configuration at its published
    shapes: finite, above the DSM chain's share, which is most of it."""
    with open(CONFIG) as f:
        c = json.load(f)
    total = yardstick.step_flop(c)
    ws, l0 = yardstick.dsm_layers(c)
    f = yardstick.flops("res", ws, l0, c["train_batch_size"] * c["train_nz_cdae"])
    dsm = (f["fwd"] + f["bwd"]) * c["num_cdae_updates"]
    assert math.isfinite(total) and total > dsm > 0
    assert 0.8 < dsm / total < 1.0
