"""The three notebook workloads at their published lengths, each held to the
criteria of tests/test_examples.py (JAX package), with its time.

    python -m ardae_tpu_torch.examples.published

Five runs, one after the other at the JAX scripts' defaults: dae_toy grad
and res (5,000 iterations), ardae_toy grad and res (5,000) and ardae_fit
(50,000). Criteria: dae_toy's losses and score field finite; ardae_toy's
last logged loss below 1 and, at sigma 1, the score from (4.5, 4.5),
(-4.5, -4.5) and (4.5, -4.5) pointing toward the swiss roll (a 0.5 step
along it nears the data); ardae_fit's mean energy_func4 over 4,000 samples
at least 0.5 below that of 4,000 N(0, I) points. Each run prints one JSON
line (seconds and ms per iteration, host clock around a synchronised run;
every logged loss; the criteria's numbers), then the card's name and power
limit, then {"ok": ...}; the exit code is 1 if a criterion failed.
It runs on the card only. chip_smoke.py's phase 9a calls ``run`` at the
tests' shorter lengths.
"""

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from ardae_tpu_torch.core.energy import energy_func4
from ardae_tpu_torch.examples import ardae_fit, ardae_toy, dae_toy
from ardae_tpu_torch.models.cdae import dae_score

EXAMPLES = {"dae_toy": dae_toy, "ardae_toy": ardae_toy, "ardae_fit": ardae_fit}
PUBLISHED = (("dae_toy", "grad", 5000), ("dae_toy", "res", 5000),
             ("ardae_toy", "grad", 5000), ("ardae_toy", "res", 5000),
             ("ardae_fit", None, 50000))
FAR = ((4.5, 4.5), (-4.5, -4.5), (4.5, -4.5))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def toward_the_data(dae):
    """(distance to 5,000 swiss-roll points before, after) a 0.5 step along
    the score at sigma 1 from each point of FAR."""
    device = next(dae.parameters()).device
    data = dae_toy.swissroll_sampler(
        torch.Generator(device=device).manual_seed(5), 5000).cpu().numpy()
    far = torch.tensor(FAR, device=device)
    score = dae_score(dae, far, 1.0).detach().cpu().numpy()
    moves = []
    for p, s in zip(np.asarray(FAR), score):
        step = p + 0.5 * s / (np.linalg.norm(s) + 1e-9)
        moves.append((float(np.linalg.norm(data - p, axis=1).min()),
                      float(np.linalg.norm(data - step, axis=1).min())))
    return moves


def fit_energy(gen, z_dim=10):
    """(mean energy_func4 of 4,000 generator samples, of 4,000 N(0, I)
    points)."""
    energy = lambda a: float(energy_func4(torch.as_tensor(a)).mean())
    xs = ardae_fit.sample(gen, 4000, z_dim=z_dim)
    normal = np.random.default_rng(0).normal(size=(4000, 2)).astype(np.float32)
    return energy(xs) if np.isfinite(xs).all() else math.nan, energy(normal)


def run(example, score_type, iterations, device="cuda", **train_kw):
    """Train one example (``score_type`` None for ardae_fit), time it and
    hold it to its criteria: a dict of the numbers, "ok" among them."""
    kw = dict(train_kw, iterations=iterations, device=device, log=lambda *_: None)
    if score_type is not None:
        kw["score_type"] = score_type
    _sync(device)
    t0 = time.perf_counter()
    out = EXAMPLES[example].train(**kw)
    _sync(device)
    sec = time.perf_counter() - t0
    res = {"example": example, "score_type": score_type, "iterations": iterations,
           "seconds": sec, "ms_per_iteration": 1e3 * sec / iterations}
    if example == "ardae_fit":
        gen, _, losses = out
        e, e_normal = fit_energy(gen, train_kw.get("z_dim", 10))
        res.update(losses=losses, energy=e, energy_normal=e_normal,
                   ok=bool(np.isfinite(losses).all() and e < e_normal - 0.5))
        return res
    dae, losses = out
    finite = bool(np.isfinite(losses).all()
                  and np.isfinite(dae_toy.score_field(dae)[0]).all())
    res.update(losses=losses, ok=finite)
    if example == "ardae_toy":
        moves = toward_the_data(dae)
        res.update(toward_the_data=moves, ok=finite and losses[-1] < 1.0
                   and all(after < before for before, after in moves))
    return res


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    ok = True
    for example, score_type, iters in PUBLISHED:
        res = run(example, score_type, iters)
        ok = ok and res["ok"]
        print(json.dumps(res), flush=True)
    print(card_line())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
