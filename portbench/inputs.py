"""Everything a run feeds both sides, made on the device from ``--seed``:
the training images, the weights, the batch indices and the draws of the
checked steps. Each stream has a generator of its own, seeded from
(seed, stream), so one seed gives the same inputs in every run.

  * images: (rows, pixels) gray values U(0, 1) ** 3, at the split's
    shapes (dbMNIST-val5k: 55,000 training images of 28 x 28), binarized
    per fetch by the program as by the reference;
  * weights: one U(-1, 1) draw for all leaves of both nets, scaled per
    leaf to U(+-1/sqrt(fan_in)) (a weight-norm scale is 1);
  * indices: shuffled epochs without remainder, as the trainers' host
    index stream takes them, made on the device a few epochs at a time
    and handed to the program as host arrays;
  * the checked steps' draws, at the shapes the step injects.
"""

import numpy as np
import torch

STREAMS = {"data": 1, "weights": 2, "indices": 3, "draws": 4, "program": 5}
EPOCHS_AT_ONCE = 8


def stream_seed(seed, stream):
    """A 63-bit seed of (seed, stream), for any whole ``seed``."""
    state = np.random.SeedSequence([int(seed) % 2**64, STREAMS[stream]]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed, stream, device):
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def images(seed, rows, pixels, device):
    g = generator(seed, "data", device)
    return torch.rand((rows, pixels), generator=g, device=device) ** 3


def weights(seed, specs, bounds, device):
    """{net: {leaf: tensor}} for ``specs`` {net: {leaf: shape}} and
    ``bounds`` {net: {leaf: (bound, offset)}}, cut from one draw."""
    names = [(net, leaf) for net, spec in specs.items() for leaf in spec]
    sizes = [int(np.prod(specs[n][k])) for n, k in names]
    scale = torch.repeat_interleave(
        torch.tensor([bounds[n][k][0] for n, k in names], device=device),
        torch.tensor(sizes, device=device))
    shift = torch.repeat_interleave(
        torch.tensor([bounds[n][k][1] for n, k in names], device=device),
        torch.tensor(sizes, device=device))
    g = generator(seed, "weights", device)
    flat = (torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0) * scale + shift
    out = {net: {} for net in specs}
    for (net, leaf), part in zip(names, torch.split(flat, sizes)):
        out[net][leaf] = part.view(specs[net][leaf])
    return out


class IndexFeed:
    """Batches of ``bs`` row indices of ``rows`` images, epoch after epoch
    (drop-remainder), as host int64 arrays; the permutations are drawn on
    the device, EPOCHS_AT_ONCE epochs a refill."""

    def __init__(self, seed, rows, bs, device):
        self.rows, self.bs, self.device = rows, bs, device
        self.per_epoch = rows // bs
        self._g = generator(seed, "indices", device)
        self._buf = np.empty((0, bs), np.int64)

    def take(self, k):
        """(k, bs) int64 of the next k batches."""
        while self._buf.shape[0] < k:
            perm = torch.argsort(torch.rand((EPOCHS_AT_ONCE, self.rows), generator=self._g,
                                            device=self.device), dim=1)
            more = perm[:, : self.per_epoch * self.bs].reshape(-1, self.bs).cpu().numpy()
            self._buf = np.concatenate([self._buf, more])
        out, self._buf = self._buf[:k], self._buf[k:]
        return out


def step_draws(seed, n_steps, shapes, device):
    """The draws of ``n_steps`` checked steps, two draws in all (one
    normal, one uniform), cut to the step's shapes: ``shapes`` gives U (the
    phase-A updates), B, pixels, nz, nstd, nz_model, the noise widths (a
    tuple: more than one makes each noise a tuple, an aux model's pair)
    and z. Returns a list of {"bin_cdae", "bin_model", "step": {"cdae":
    [...], "model": {...}}}, the draws ``train_chunk`` injects."""
    s = shapes
    rows, rows_m = s["bs"] * s["nz"], s["bs"] * s["nz_model"]
    normal = ([("latent_eps", (rows, w)) for w in s["noise"]]
              + [("std", (s["bs"], s["nz"] * s["nstd"], 1)), ("dsm_eps", (rows * s["nstd"], s["z"]))])
    model = [("eps", (rows_m, w)) for w in s["noise"]]
    size = lambda spec: [int(np.prod(sh)) for _, sh in spec]
    n_sizes = (size(normal) * s["updates"] + size(model)) * n_steps
    u_sizes = [s["updates"] * s["bs"] * s["pixels"], s["bs"] * s["pixels"]] * n_steps
    g = generator(seed, "draws", device)
    n_parts = iter(torch.split(torch.randn(sum(n_sizes), generator=g, device=device), n_sizes))
    u_parts = iter(torch.split(torch.rand(sum(u_sizes), generator=g, device=device), u_sizes))

    def take(spec):
        out = {}
        for k, sh in spec:
            out.setdefault(k, []).append(next(n_parts).view(sh))
        return {k: v[0] if len(v) == 1 else tuple(v) for k, v in out.items()}

    out = []
    for _ in range(n_steps):
        cdae = [take(normal) for _ in range(s["updates"])]
        out.append({"bin_cdae": next(u_parts).view(s["updates"], s["bs"], s["pixels"]),
                    "bin_model": next(u_parts).view(s["bs"], s["pixels"]),
                    "step": {"cdae": cdae, "model": take(model)}})
    return out
