"""A copy of the benchmark at smoke widths for the CPU tests: ``portbench``
and ``BENCHMARK.json`` copied into a directory, the port linked beside
them, and one tiny configuration (``tiny``: the given configuration at bs
4, nz 8, hidden widths 16, 64 images) under two tiny traffic mixes (2-step
chunks), each with the limits of the full cell it shrinks."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make(dst, config="flagship"):
    """Build the copy under ``dst``; returns the two cells' names."""
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, "ardae_tpu_torch"), os.path.join(dst, "ardae_tpu_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(dst, "portbench")
    with open(os.path.join(pb, "configs", f"{config}.json")) as f:
        c = json.load(f)
    c.update(train_batch_size=4, train_nz_cdae=8, cdae_h_dim=16, train_rows=64)
    if c["model_h_dim"]:
        c["model_h_dim"] = 16
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump(c, f)
    bench["configs"].append({"name": "tiny", "source": "smoke widths",
                             "file": "portbench/configs/tiny.json", "reduced": [], "why": "tests"})
    cells = []
    for kind in ("kernels", "plain"):
        with open(os.path.join(pb, "traffic", f"fp32-{kind}.json")) as f:
            t = json.load(f)
        t.update(chunk_steps=2, warmup_steps=1, trace_steps=2)
        with open(os.path.join(pb, "traffic", f"tiny-{kind}.json"), "w") as f:
            json.dump(t, f)
        name = f"tiny-{kind}"
        shutil.copy(os.path.join(pb, "limits", f"{config}-fp32-{kind}.json"),
                    os.path.join(pb, "limits", f"{name}.json"))
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": f"tiny-{kind}",
                                   "chips": 1, "why": "tests"})
        for m in bench["per_layer"]:
            m.setdefault("workloads", []).append(name)
        cells.append(name)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return cells
