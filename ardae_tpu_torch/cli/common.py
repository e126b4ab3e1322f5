"""Driver plumbing (JAX twin: ardae_tpu/cli/common.py): experiment naming
and resume directory, the host index stream, and chunk boundaries. The IWS
evaluators wait (ROADMAP queue 1, slice 1 item 9)."""

import datetime
import glob
import os

import numpy as np

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
