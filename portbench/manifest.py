"""The benchmark's data, found by the names in ``BENCHMARK.json``:

  * a configuration: the file its entry names (``configs/<config>.json``);
  * a traffic mix: ``traffic/<traffic>.json``;
  * a cell's comparison limits: ``limits/<workload>.json``;
  * a per-layer metric: ``metrics/<metric>.py``, whose ``read(run)``
    returns the number or None when it finds nothing to read.

Adding any of them is adding a file and a manifest entry; no file here
changes.
"""

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    root: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list      # the manifest's entries this cell reports
    per_layer: list


def _load(path):
    with open(path) as f:
        return json.load(f)


def _reports(entry, name):
    return "workloads" not in entry or name in entry["workloads"]


def cell(name, root=None):
    """The workload ``name`` of the manifest at ``root`` (the checkout)."""
    root = root or os.path.dirname(HERE)
    here = os.path.join(root, "portbench")
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    limits_path = os.path.join(here, "limits", f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in reported and _reports(m, name)]
    return Cell(name, root, _load(os.path.join(root, conf["file"])),
                _load(os.path.join(here, "traffic", f"{w['traffic']}.json")),
                _load(limits_path) if os.path.exists(limits_path) else {},
                int(w["chips"]), e2e, layer)


def reader(metric, root=None):
    """The ``read`` function of ``metrics/<metric>.py`` of the checkout at
    ``root``."""
    path = os.path.join(root or os.path.dirname(HERE), "portbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
