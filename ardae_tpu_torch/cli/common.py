"""Driver plumbing (JAX twin: ardae_tpu/cli/common.py): experiment naming
and resume directory, the host index stream, chunk boundaries, and the IWS
evaluation of an implicit VAE over a split. The baseline VAE's IWAE
evaluator waits (ROADMAP queue 1, slice 3)."""

import datetime
import glob
import os

import numpy as np
import torch

from ardae_tpu_torch.io.logging import get_time


def resolve_experiment_path(cache, experiment, resume):
    """Timestamped experiment dir; resume picks the latest matching one
    (any '-YYMMDD-HH:MM:SS' suffix; the reference's '-19*'/'-20*' glob stops
    matching from 2021 on, a documented reference bug)."""
    base = os.path.join(cache, experiment)
    path = None
    if resume:
        listing = []
        for p in glob.glob(base + "-[0-9][0-9]*"):
            try:
                listing.append(
                    (datetime.datetime.strptime(p, base + "-%y%m%d-%H:%M:%S"), p))
            except ValueError:
                continue
        if listing:
            path = max(listing)[1]
    if path is None:
        path = f"{base}-{get_time()}"
    os.makedirs(path, exist_ok=True)
    return path


class IndexStream:
    """Host-side shuffled-epoch batch-index stream (drop-remainder); only
    index arrays cross to the device, where the rows live."""

    def __init__(self, n, batch_size, seed=0):
        if n < batch_size:
            raise ValueError(
                f"dataset size {n} < batch size {batch_size}: no full batch "
                "exists under drop-remainder semantics")
        self.n = n
        self.bs = batch_size
        self.per_epoch = n // batch_size
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(n)
        self._pos = 0

    def take(self, k):
        """(k, bs) int64 of k consecutive shuffled batches."""
        out = np.empty((k, self.bs), np.int64)
        for i in range(k):
            if self._pos + self.bs > self.per_epoch * self.bs:
                self._perm = self._rng.permutation(self.n)
                self._pos = 0
            out[i] = self._perm[self._pos : self._pos + self.bs]
            self._pos += self.bs
        return out


def chunk_until_boundary(i_ep, intervals, end_iter=None, max_chunk=200):
    """Largest k such that no cadence boundary falls strictly inside
    (i_ep, i_ep + k): boundaries happen when (i_ep + j) % interval == 0."""
    k = max_chunk
    for interval in intervals:
        if interval and interval > 0:
            k = min(k, interval - (i_ep % interval))
    if end_iter is not None:
        k = min(k, max(1, end_iter - i_ep))
    return max(1, k)


def evaluate_iws_ivae(model, eval_data, iws_samples, generator=None,
                      binarize=False, batch=None, jitter=0.0, draws=None):
    """Mean IWS log-likelihood over an eval split (reference
    ivae_ardae.py:644-673), without autograd.

    The bound is per item, so the grouping ``batch`` does not change the
    math; None picks max(1, min(128, 2**25 // (iws_samples * 784))) items.
    The tail batch is simply shorter. A dynamically binarized split draws
    each batch's pixels anew. ``draws``: optional per-batch list of
    {"bin": (nv, D) uniforms, "eps": (nv*ssz, noise_dim), "new_eps":
    (nv, ssz, z_dim)}; otherwise every draw comes from ``generator``."""
    from ardae_tpu_torch.models.ivae.api import logprob_iws

    if batch is None:
        batch = max(1, min(128, (1 << 25) // (iws_samples * 28 * 28)))
    device = next(model.parameters()).device
    data = torch.as_tensor(eval_data, device=device)
    sums = []
    with torch.no_grad():
        for i, start in enumerate(range(0, data.shape[0], batch)):
            d = draws[i] if draws else {}
            x = data[start:start + batch]
            if binarize:
                u = d.get("bin")
                if u is None:
                    u = torch.rand(x.shape, generator=generator, device=device)
                x = (u.to(device) < x).to(torch.float32)
            per_item = logprob_iws(model, x, iws_samples, jitter=jitter,
                                   reduce="per_item", generator=generator,
                                   eps=d.get("eps"), new_eps=d.get("new_eps"))
            sums.append(torch.sum(per_item))
    total = float(torch.stack(sums).double().sum()) if sums else 0.0
    return total / max(data.shape[0], 1)


class EndIterError(Exception):
    """Final-mode stop (reference utils/msc.py:112-113)."""
