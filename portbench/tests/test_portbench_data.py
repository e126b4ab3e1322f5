"""The benchmark's data and yardstick on the CPU: a configuration, a
traffic mix and a per-layer metric added as new files plus manifest
entries; no module of JAX or of the JAX package loaded by the harness or
the reference, and nothing of the port loaded by the reference; the frozen
DSM bounds at both lines' shapes; the joint step's FLOP count."""

import json
import os
import subprocess
import sys

import pytest

from portbench import yardstick
from portbench.tests import tinycopy

FORBIDDEN = {"jax", "jaxlib", "flax", "ardae_tpu"}


def _config(name):
    with open(os.path.join(tinycopy.REPO, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _in_copy(root, code):
    """Run ``code`` in a fresh interpreter at ``root``; its last line of
    output, parsed."""
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


RUN_TINY = """
import json, sys
sys.path.insert(0, '.')
from portbench import run
args = run.parse_args(['--workload', {cell!r}, '--seed', '4000000007', '--seconds', '0.05',
                       '--trace', '{trace}'])
res = run.bench(args, require_cuda=False, root='.', out=lambda s: None)
top = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps({{'result': res, 'modules': top}}))
"""


def _files(pb):
    return {os.path.relpath(os.path.join(dp, f), pb): open(os.path.join(dp, f), "rb").read()
            for dp, _, fs in os.walk(pb) for f in fs if "__pycache__" not in dp}


def test_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix and per-layer metric: new files and
    manifest entries, no file of the benchmark edited."""
    root = str(tmp_path)
    tinycopy.make(root, "implicit-conv")
    pb = os.path.join(root, "portbench")
    before = _files(pb)
    cfg = json.load(open(os.path.join(pb, "configs", "tiny.json")))
    cfg.update(cdae_n_layers=3, std_scale=100.0)
    json.dump(cfg, open(os.path.join(pb, "configs", "newconf.json"), "w"))
    traffic = json.load(open(os.path.join(pb, "traffic", "tiny-plain.json")))
    traffic.update(chunk_steps=3, warmup_steps=2)
    json.dump(traffic, open(os.path.join(pb, "traffic", "newmix.json"), "w"))
    with open(os.path.join(pb, "metrics", "steps_traced.py"), "w") as f:
        f.write("def read(run):\n    return float(run.trace.steps)\n")
    limits = json.load(open(os.path.join(pb, "limits", "tiny-plain.json")))
    json.dump(limits, open(os.path.join(pb, "limits", "newconf-newmix.json"), "w"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "newconf", "source": "x",
                             "file": "portbench/configs/newconf.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "newconf-newmix", "config": "newconf",
                               "traffic": "newmix", "chips": 1, "why": "x"})
    for m in bench["per_layer"]:
        m["workloads"].append("newconf-newmix")
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step loop",
                               "moves": "step_ms", "workloads": ["newconf-newmix"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    out = _in_copy(root, RUN_TINY.format(cell="newconf-newmix", trace=1))
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["steps_traced"]["value"] == 2.0
    assert res["attempted"] % 3 == 0
    after = _files(pb)
    assert all(after[p] == b for p, b in before.items())


def test_model_added_by_files_alone(tmp_path):
    """A configuration of a model the reference has no file for yet: the
    benchmark without ``reference/models/mnist-concat.py`` refuses it with
    one error line, and that file, the configuration and the manifest's
    entries make a cell that compares correct; no file of the benchmark is
    edited."""
    root = str(tmp_path)
    tinycopy.make(root, "implicit-conv")
    pb = os.path.join(root, "portbench")
    model_file = os.path.join(pb, "reference", "models", "mnist-concat.py")
    source = open(model_file, "rb").read()
    os.remove(model_file)
    before = _files(pb)
    cfg = json.load(open(os.path.join(pb, "configs", "tiny.json")))
    cfg.update(model="mnist-concat", model_h_dim=16, model_n_layers=2)
    json.dump(cfg, open(os.path.join(pb, "configs", "concat.json"), "w"))
    limits = json.load(open(os.path.join(pb, "limits", "tiny-kernels.json")))
    json.dump(limits, open(os.path.join(pb, "limits", "concat-kernels.json"), "w"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "concat", "source": "x",
                             "file": "portbench/configs/concat.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "concat-kernels", "config": "concat",
                               "traffic": "tiny-kernels", "chips": 1, "why": "x"})
    for m in bench["per_layer"]:
        m["workloads"].append("concat-kernels")
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    p = subprocess.run([sys.executable, "-c", RUN_TINY.format(cell="concat-kernels", trace=0)],
                       cwd=root, capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and "reference/models/mnist-concat.py" in p.stderr
    with open(model_file, "wb") as f:
        f.write(source)
    out = _in_copy(root, RUN_TINY.format(cell="concat-kernels", trace=1))
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["cdae_loss_gap"]["value"] <= 1e-6
    assert res["checks"]["model_loss_gap"]["value"] <= 1e-6
    assert res["checks"]["grad_norm_gap"]["value"] <= 1e-5
    assert res["checks"]["delta_norm_gap"]["value"] <= 1e-4
    assert "train_mfu_pct" in res["metrics"]
    after = _files(pb)
    assert all(after[p] == b for p, b in before.items())


@pytest.mark.parametrize("trace", [0, 1])
def test_no_jax_loaded(tmp_path, trace):
    """Whole top-level names: ``ardae_tpu_torch`` is the port, ``ardae_tpu``
    is not to be loaded."""
    root = str(tmp_path)
    cells = tinycopy.make(root, "flagship")
    out = _in_copy(root, RUN_TINY.format(cell=cells[0], trace=trace))
    assert not FORBIDDEN & set(out["modules"])
    assert "ardae_tpu_torch" in out["modules"]


def test_reference_stands_alone():
    """The reference, with every model, score net and context file that
    the configurations name loaded, imports nothing of the port."""
    code = ("import sys, json, glob; import portbench.reference.step, portbench.yardstick; "
            "[portbench.yardstick.step_flop(json.load(open(f))) "
            "for f in sorted(glob.glob('portbench/configs/*.json'))]; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tinycopy.REPO, capture_output=True,
                       text=True, timeout=300)
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not (FORBIDDEN | {"ardae_tpu_torch"}) & top


@pytest.mark.parametrize("config,fwd,bwd", [("flagship", 2.320, 4.623),
                                            ("implicit-conv", 1.160, 2.312)])
def test_dsm_bound(config, fwd, bwd):
    """The frozen arithmetic gives the bounds of the kernels' table (res
    kernel at the flagship's shape, grad kernel at implicit conv's)."""
    b = yardstick.dsm_bound_ms(_config(config))
    assert round(b["fwd"], 3) == fwd and round(b["bwd"], 3) == bwd


@pytest.mark.parametrize("config", ["flagship", "implicit-conv"])
def test_step_flop(config):
    """The joint step's FLOP: the DSM chain's products (the frozen count,
    forward and backward, once an update) are most of it, and the rest is
    the sampling pass over the same rows and phase B at 128 rows."""
    c = _config(config)
    total = yardstick.step_flop(c)
    ws, l0 = yardstick.dsm_layers(c)
    kind = "res" if c["cdae"] == "mlp-res" else "grad"
    n = c["train_batch_size"] * c["train_nz_cdae"]
    f = yardstick.flops(kind, ws, l0, n)
    dsm = (f["fwd"] + f["bwd"]) * c["num_cdae_updates"]
    expect = {"flagship": 2.608712265728e12, "implicit-conv": 5.95583168512e11}[config]
    assert total == expect
    assert 0.8 < dsm / total < 1.0
