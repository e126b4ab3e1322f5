"""Summarise port driver logs (the experiment's log.txt of
ardae_tpu_torch.cli.ivae_ardae or .vae), one JSON line each:

    python scripts/torch_log_summary.py LOG [LOG ...]

ms/step over the log intervals (median, 10th and 90th percentiles, the
first interval left out: it holds the warm-up), the number of intervals
and the last iteration, each val and test eval's seconds, each save's
seconds, the best val bound with its iteration, and the test bounds (the
last number of each eval line is the bound that picks best-checkpoint).
"""

import json
import re
import statistics
import sys


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))]


def summarise(path):
    with open(path) as f:
        lines = f.readlines()
    iters = [ln for ln in lines if ln.startswith("| iter ")]
    ms = [float(re.search(r"ms/step\s+(\S+)", ln).group(1)) for ln in iters]
    steady = ms[1:] or ms
    val = [ln for ln in lines if ln.startswith("| val")]
    test = [ln for ln in lines if ln.startswith("| test")]
    bound = lambda ln: float(re.findall(r"(-?\d+\.\d+)\s*$", ln.strip())[0])
    secs = lambda ls: [float(re.search(r"sec/step\s+(\S+)", ln).group(1)) for ln in ls]
    best = max(val, key=bound) if val else None
    saves = [float(m.group(1)) for ln in lines
             for m in [re.search(r"\| saved \S+ at iter \d+ \((\S+) s\)", ln)] if m]
    return {
        "log": path,
        "last_iter": int(re.search(r"iter (\d+)", iters[-1]).group(1)) if iters else 0,
        "intervals": len(ms),
        "ms_step_median": statistics.median(steady) if steady else None,
        "ms_step_p10": _pct(steady, 0.1) if steady else None,
        "ms_step_p90": _pct(steady, 0.9) if steady else None,
        "val_eval_s": secs(val), "test_eval_s": secs(test),
        "save_s_min": min(saves) if saves else None,
        "save_s_max": max(saves) if saves else None,
        "best_val": bound(best) if best else None,
        "best_val_iter": int(re.search(r"iter (\d+)", best).group(1)) if best else None,
        "test": [ln.strip() for ln in test],
    }


if __name__ == "__main__":
    for p in sys.argv[1:]:
        print(json.dumps(summarise(p)))
