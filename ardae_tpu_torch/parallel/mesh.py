"""Data and sample parallelism over ``torch.distributed`` (JAX twin:
ardae_tpu/parallel/mesh.py).

A ``Mesh`` is one rank's view of a (data, sample) grid of ``dp * sp`` ranks
in JAX's layout, rank = d * sp + s (``np.array(devices).reshape(dp, sp)``).
Rank (d, s) holds the d-th of dp equal parts of the batch axis and the s-th
of sp equal parts of phase A's nz_cdae sample axis; the parameters are
replicated. Its sample group is the sp ranks that share its part of the
batch: phase A's sigma statistics (a std over the samples) reduce there.
The gradients and the metrics reduce over the world.

Every random draw of a step is made at its global shape from a generator
seeded alike on every rank, then sliced (``local``), as ``jax.random``
under a sharding gives the unsharded values: a world of N trains as a
world of one, up to the order of its sums.

A world whose ranks share a card, or run on the CPU, talks over gloo; gloo
reduces a card tensor through a host copy here.
"""

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

# the metrics a world reduces by MAX and by MIN; every other one by its mean
_EXTREMES = {"std_eff_max": 1.0, "std_eff_min": -1.0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    sp: int
    rank: int
    device: torch.device
    backend: str = "gloo"
    sample_group: Any = None  # the rank's sample group (a ProcessGroup), sp > 1

    @property
    def size(self):
        return self.dp * self.sp

    def items(self, n):
        """This rank's slice of a batch axis of n items."""
        if n % self.dp:
            raise ValueError(f"{n} items do not split over {self.dp} data ranks")
        d, k = self.rank // self.sp, n // self.dp
        return slice(d * k, (d + 1) * k)

    def samples(self, n):
        """This rank's slice of a sample axis of n samples."""
        if n % self.sp:
            raise ValueError(f"{n} samples do not split over {self.sp} sample ranks")
        s, k = self.rank % self.sp, n // self.sp
        return slice(s * k, (s + 1) * k)

    def local(self, t, items_axis=0, samples_axis=None):
        """This rank's block of a global tensor: its items on ``items_axis``
        and, where given, its samples on ``samples_axis``."""
        idx = [slice(None)] * t.dim()
        idx[items_axis] = self.items(t.shape[items_axis])
        if samples_axis is not None:
            idx[samples_axis] = self.samples(t.shape[samples_axis])
        return t[tuple(idx)]

    def _all_reduce(self, t, op=dist.ReduceOp.SUM, group=None):
        if self.backend == "gloo" and t.is_cuda:
            host = t.cpu()
            dist.all_reduce(host, op, group)
            return t.copy_(host)
        dist.all_reduce(t, op, group)
        return t

    def average_grads(self, params):
        """The gradient all-reduce, averaged over the world, in place: every
        gradient flattened into one buffer, one collective an optimizer
        step. Parameters without a gradient have none on every rank."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        self._all_reduce(flat).div_(self.size)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))

    def reduce_metrics(self, metrics):
        """What a world of one reports: each metric's mean over the world
        (every rank's part is the same size), std_eff_max's maximum and
        std_eff_min's minimum; two collectives."""
        means = [k for k in metrics if k not in _EXTREMES]
        out = {}
        if means:
            v = torch.stack([metrics[k].detach().float().reshape(()) for k in means])
            out.update(zip(means, self._all_reduce(v).div_(self.size).unbind()))
        ext = [k for k in metrics if k in _EXTREMES]
        if ext:
            v = torch.stack([_EXTREMES[k] * metrics[k].detach().float().reshape(())
                             for k in ext])
            v = self._all_reduce(v, dist.ReduceOp.MAX)
            out.update((k, _EXTREMES[k] * x) for k, x in zip(ext, v.unbind()))
        return out

    def sample_sum(self, t):
        """t summed over the sample group, in place."""
        if self.sp > 1:
            self._all_reduce(t, group=self.sample_group)
        return t

    def share(self, obj):
        """Rank 0's ``obj`` on every rank (a broadcast, so also a barrier
        behind rank 0)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self):
        dist.barrier()


def sample_parallel_mesh(data, sample, device):
    """The calling rank's 2-D (data, sample) mesh over the initialised world
    of data * sample ranks; every rank calls it, in the same order."""
    world = dist.get_world_size()
    if data * sample != world:
        raise ValueError(f"mesh needs {data * sample} devices but the world has "
                         f"{world} ranks")
    rank = dist.get_rank()
    group = None
    if sample > 1:
        # every rank creates every group, in the same order
        groups = [dist.new_group(list(range(d * sample, (d + 1) * sample)))
                  for d in range(data)]
        group = groups[rank // sample]
    return Mesh(data, sample, rank, torch.device(device), dist.get_backend(), group)


def make_mesh(n_devices, device):
    """The calling rank's 1-D data-parallel mesh over the world of n_devices
    ranks."""
    return sample_parallel_mesh(n_devices, 1, device)


def local(mesh, t, items_axis=0, samples_axis=None):
    """``mesh.local``; t itself without a mesh."""
    return t if mesh is None else mesh.local(t, items_axis, samples_axis)
