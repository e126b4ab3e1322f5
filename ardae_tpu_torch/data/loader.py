"""Device-resident batching (JAX twin: ardae_tpu/data/loader.py).

The whole split lives on the device; a batch is an index gather there, and
dynamic binarization is a Bernoulli draw on the device per fetch (the
reference re-binarizes on the CPU at every epoch access,
datasets/mnist.py:38-40).
"""

import torch


def gather_batches(data, idx, binarize=False, generator=None, u=None):
    """data[idx] for an index tensor of any shape -> idx.shape + (D,).
    With ``binarize``, each pixel is 1 with probability its gray value:
    ``u < p`` for uniform ``u`` (injected, or drawn from ``generator``),
    the same law as ``jax.random.bernoulli``."""
    batch = data.index_select(0, idx.reshape(-1)).reshape(*idx.shape, -1)
    if not binarize:
        return batch
    if u is None:
        u = torch.rand(batch.shape, generator=generator, device=batch.device)
    return (u.to(batch.device) < batch).to(torch.float32)
