"""The comparison that decides ``correct``: what the program's first steps
produced, set up through the window's own call and feed, against the plain
reference following the same steps from the same weights, batches and
draws (``reference/step.py``). Four numbers, each with a limit of its own
(``limits/<workload>.json``):

  * ``cdae_loss_gap``: |program - reference| / |reference| of the first
    step's phase-A loss (its last update's);
  * ``model_loss_gap``: the same of the first step's phase-B model loss;
  * ``grad_norm_gap``: by the worst leaf of both nets, the gap between the
    program's and the reference's norm of the first gradient as the
    optimizer holds it after one step, over the larger of the reference's
    norm of that leaf and of its net's median leaf;
  * ``delta_norm_gap``: by the worst leaf, the same gap of the norm of
    each leaf's change over the checked steps, taken over the elements
    whose first gradient in the reference is above round-off (ELEM_QUIET
    of the leaf's root mean square), and leaving out the leaves whose
    first gradient in the reference is under QUIET of their net's median
    leaf's.

Medians are taken within each net ("model.", "cdae."): the two nets have
losses and optimizers of their own, and the model's gradients, a sum over
every pixel, are orders above the cdae's, a mean.

Why the elements: Adam's and RMSprop's first updates move every element by
about the learning rate whatever its gradient's size, so an element whose
gradient is round-off small moves one way or the other on the last bit;
one such element of a small leaf (a 144-weight first convolution) moves
that leaf's whole change by ~4e-3. The losses of the later steps move
with it, so only the first step's losses are compared.
"""

import statistics

import torch

NAMES = ("cdae_loss_gap", "model_loss_gap", "grad_norm_gap", "delta_norm_gap")
QUIET = 1e-3
ELEM_QUIET = 1e-3


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _norm(t):
    return float(torch.linalg.vector_norm(t.float()))


def _net(leaf):
    return leaf.split(".", 1)[0]


def _net_medians(values, leaves):
    nets = {}
    for k in leaves:
        nets.setdefault(_net(k), []).append(values[k])
    return {n: statistics.median(v) for n, v in nets.items()}


def _leaf_gaps(prog, ref, leaves):
    med = _net_medians(ref, leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med[_net(k)], 1e-30) for k in leaves}


def gaps(prog, ref):
    """Every reading the numbers are taken from: each checked step's
    relative loss gaps, each leaf's gap of the first gradient's norm, and
    of the change's norm over the elements whose gradient is above
    round-off (the leaves that move by more than round-off). ``prog`` and
    ``ref`` are {"losses", "first_grad", "delta"}, the last two {leaf:
    tensor}."""
    g = {k: _norm(t) for k, t in ref["first_grad"].items()}
    med = _net_medians(g, g)
    moving = [k for k in g if g[k] >= QUIET * med[_net(k)]]
    kept, dp, dr = {}, {}, {}
    for k in moving:
        a = ref["first_grad"][k]
        mask = a >= ELEM_QUIET * torch.sqrt(torch.mean(a.float() ** 2))
        kept[k] = float(mask.float().mean())
        dp[k], dr[k] = _norm(prog["delta"][k][mask]), _norm(ref["delta"][k][mask])
    return {"cdae_steps": [_rel(p[0], r[0]) for p, r in zip(prog["losses"], ref["losses"])],
            "model_steps": [_rel(p[1], r[1]) for p, r in zip(prog["losses"], ref["losses"])],
            "grad_leaves": _leaf_gaps({k: _norm(t) for k, t in prog["first_grad"].items()}, g,
                                      list(g)),
            "delta_leaves": _leaf_gaps(dp, dr, moving),
            "delta_kept": kept}


def numbers(prog, ref):
    """{name: value} of the program's observations against the
    reference's."""
    d = gaps(prog, ref)
    return {"cdae_loss_gap": d["cdae_steps"][0],
            "model_loss_gap": d["model_steps"][0],
            "grad_norm_gap": max(d["grad_leaves"].values()),
            "delta_norm_gap": max(d["delta_leaves"].values())}


def judge(values, limits):
    """(correct, [(name, value, limit)]): correct where every number with
    a limit is finite and within it. A limit of None: the number is read
    and printed, not compared (it has no upper reading in that cell)."""
    rows = [(n, values[n], limits[n]) for n in NAMES]
    ok = all(v == v and v <= lim for _, v, lim in rows if lim is not None)
    return ok, rows
