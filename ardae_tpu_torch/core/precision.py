"""Mixed precision as the JAX package runs it (its ``compute_dtype``
arguments; ardae_tpu/models/cdae/cardae.py, models/ivae/api.py,
models/vae/api.py).

JAX casts the fp32 master parameters to bf16 inside the loss
(``jax.tree.map(astype)``); the gradient comes back to the fp32 masters
through the cast's transpose. ``cast_module`` does the same here: it casts
every fp32 parameter of a module once, and runs the module's methods on the
cast copies through ``torch.func.functional_call``, so autograd carries the
gradient through ``Tensor.to`` to the fp32 ``nn.Parameter``s. It is not
``torch.autocast``: autocast runs softplus, exp, log and the sums in fp32
where JAX runs them in bf16, and casts ops JAX leaves as they are.

``promote`` gives the layers JAX's type promotion: an fp32 tensor against
bf16 weights computes in fp32 (flax's ``x @ kernel`` promotes; a PyTorch
matmul or convolution refuses mixed dtypes). Where the dtypes agree it
returns its arguments untouched, so the fp32 path is what it was.
"""

import torch
import torch.nn as nn
from torch.func import functional_call

_DTYPES = {None: None, "float32": None, torch.float32: None,
           "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16}


def compute_dtype(name):
    """The cast a ``compute_dtype`` names: None for fp32 (no cast), else
    torch.bfloat16."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r}: float32 or "
                         "bfloat16") from None


def promote(*tensors):
    """The tensors (None passes through) cast to their common dtype, as JAX
    promotes the operands of a product: bf16 with fp32 gives fp32."""
    present = [t for t in tensors if t is not None]
    dtype = present[0].dtype
    for t in present[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t if t is None or t.dtype == dtype else t.to(dtype)
                 for t in tensors)


class _Dispatch(nn.Module):
    """``forward(name, *args)`` runs ``module.name(*args)``: functional_call
    calls forward only."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, name, *args, **kwargs):
        return getattr(self.module, name)(*args, **kwargs)


class _CastModule:
    """A module seen through parameters cast to another dtype: its methods
    and submodules run on the cast copies, its other attributes read
    through."""

    def __init__(self, module, dtype):
        self._dispatch = _Dispatch(module)
        self._params = {"module." + k: (p.to(dtype) if p.dtype == torch.float32
                                        else p)
                        for k, p in module.named_parameters()}

    def __getattr__(self, name):
        attr = getattr(self._dispatch.module, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            return functional_call(self._dispatch, self._params,
                                   (name, *args), kwargs)
        return call

    def __call__(self, *args, **kwargs):
        return self.__getattr__("__call__")(*args, **kwargs)


def cast_module(module, dtype):
    """``module`` itself for fp32 (``dtype`` None or "float32"), else a view
    of it whose methods (``sample_z``, ``decode_params``, ``raw_score``,
    ``energy``, ...) run on its fp32 parameters cast to ``dtype``, the
    gradient reaching the fp32 parameters through the cast."""
    dtype = compute_dtype(dtype)
    return module if dtype is None else _CastModule(module, dtype)


def cast_input(x, dtype):
    """``x`` in the compute dtype (itself for fp32)."""
    dtype = compute_dtype(dtype)
    return x if dtype is None else x.to(dtype)


def fp32(tensors):
    """The tensors as a tuple in fp32 (each itself when already fp32): a
    bf16 pass's outputs as JAX casts them back."""
    return tuple(t.float() for t in tensors)
