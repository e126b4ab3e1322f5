"""Device-resident batching (JAX twin: ardae_tpu/data/loader.py).

The whole split lives on the device; a batch is an index gather there, and
dynamic binarization is a Bernoulli draw on the device per fetch (the
reference re-binarizes on the CPU at every epoch access,
datasets/mnist.py:38-40).
"""

import torch

from ardae_tpu_torch.parallel.mesh import local


def gather_batches(data, idx, binarize=False, generator=None, u=None,
                   mesh=None, items_axis=0):
    """data[idx] for an index tensor of any shape -> idx.shape + (D,).
    With ``binarize``, each pixel is 1 with probability its gray value:
    ``u < p`` for uniform ``u`` (injected, or drawn from ``generator``),
    the same law as ``jax.random.bernoulli``. With a ``mesh``
    (parallel/mesh.py), only this rank's items of idx (on ``items_axis``),
    their uniforms cut from the draw at idx's global shape."""
    if binarize and u is None:
        u = torch.rand((*idx.shape, data.shape[1:].numel()), generator=generator,
                       device=data.device)
    idx = local(mesh, idx, items_axis)
    batch = data.index_select(0, idx.reshape(-1)).reshape(*idx.shape, -1)
    if not binarize:
        return batch
    return (local(mesh, u, items_axis).to(batch.device) < batch).to(torch.float32)
