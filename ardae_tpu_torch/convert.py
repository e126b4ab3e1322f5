"""Weights carried between the JAX package and the port.

``flax_to_state_dict`` turns a flax param tree (nested dict of arrays, with
or without the top ``"params"`` level) into the port module's
``state_dict``; ``state_dict_to_flax`` is its inverse. The rules:

  * names: ``layers_3`` -> ``layers.3``, ``kernel`` -> ``weight``; every
    other name (``direction``, ``scale``, ``bias``, the split
    ``*_l0_row``/``*_l0_ctx`` layers) maps to itself;
  * the MADE blocks of toy-maf (``flow0``, ``flow1``: ``w_in``, ``w_ctx``,
    ``b_h``, ``w_m``, ``b_m``, ``w_a``, ``b_a``) keep flax's names and
    (in, out) layout in the port (nn/made.py), so they cross as they are;
  * dense kernels and the raw matrices of the weight-normalized, context
    and bilinear layers (``direction``, ``cscale``, ``path1``, ``path2``)
    (in, out) -> (out, in); their vectors (``scale``, ``cscalebias``,
    ``bias``) cross as they are;
  * conv kernels and directions HWIO -> OIHW; transposed-conv kernels HWIO
    -> (in, out, k, k), torch's ConvTranspose2d layout, with no spatial flip
    (the JAX layer flips at use, nn/conv.py:108-117, and torch's transposed
    convolution is that same flipped correlation);
  * the two NHWC reshapes of each conv stack become NCHW: the layer after
    the trunk takes the (32, s, s) features in NCHW order (columns
    permuted: the resconv trunk's fc, the conv IVAE's fc4_inp, the conv
    baseline's enc_fc, the aux conv models' aux_fc; of enc_fc and
    auxdec_fc of the aux conv models, which take cat(trunk features, z0 or
    z), only the trunk's leading columns) and the
    decoder layer before the first conv emits them in NCHW order (rows,
    scales and biases permuted: the resconv decoder's fc1, the conv
    decoder's fc.fc).
"""

import re

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")
# leaves stored (in, out) in flax and (out, in) in the port, besides kernels
_MATRICES = ("direction", "cscale", "path1", "path2")


def _nhwc_to_nchw_perm(c, hgt, wid):
    """perm[j_nchw] = j_nhwc for a (c, h, w) feature map flattened."""
    cc, yy, xx = np.meshgrid(np.arange(c), np.arange(hgt), np.arange(wid),
                             indexing="ij")
    return ((yy * wid + xx) * c + cc).reshape(-1)


def _perm_rules(module):
    """{torch key prefix: ('in' | 'out', perm)} for the NHWC sites of the
    resconv and conv stacks; an 'in' perm shorter than the layer's input
    permutes its leading columns."""
    from ardae_tpu_torch.models.ivae.aux import MNISTConvAuxIPVAE
    from ardae_tpu_torch.models.ivae.conv import ConvIPVAE
    from ardae_tpu_torch.models.vae.aux import MNISTConvAuxVAE
    from ardae_tpu_torch.models.vae.conv import ConvDecoder, MNISTConvVAE
    from ardae_tpu_torch.models.vae.resconv import ResConvDecoder, ResConvTrunk

    perm = _nhwc_to_nchw_perm(32, 4, 4)
    rules = {}
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, ResConvTrunk):
            rules[f"{pre}fc.dot_0h."] = ("in", perm)
            rules[f"{pre}fc.dot_01."] = ("in", perm)
        elif isinstance(m, ResConvDecoder):
            rules[f"{pre}fc1.dot_h1."] = ("out", perm)
            rules[f"{pre}fc1.dot_01."] = ("out", perm)
        elif isinstance(m, (ConvIPVAE, MNISTConvVAE)):
            s = m.trunk.s
            site = "fc4_inp" if isinstance(m, ConvIPVAE) else "enc_fc"
            rules[f"{pre}{site}."] = ("in", _nhwc_to_nchw_perm(32, s, s))
        elif isinstance(m, (MNISTConvAuxIPVAE, MNISTConvAuxVAE)):
            p = _nhwc_to_nchw_perm(32, m.aux_trunk.s, m.aux_trunk.s)
            for site in ("aux_fc", "enc_fc", "auxdec_fc"):
                if hasattr(m, site):
                    rules[f"{pre}{site}."] = ("in", p)
        elif isinstance(m, ConvDecoder):
            rules[f"{pre}fc.fc."] = ("out", _nhwc_to_nchw_perm(32, m.s, m.s))
    return rules


def _transposed_convs(module):
    """Torch key prefixes of the ConvTranspose2d layers of ``module``."""
    from ardae_tpu_torch.nn.conv import ConvTranspose2d

    return tuple(f"{name}." if name else "" for name, m in module.named_modules()
                 if isinstance(m, ConvTranspose2d))


def _to_torch_kernel(key, a, transposed):
    if a.ndim == 2:
        return a.T
    if key.startswith(transposed):
        return np.transpose(a, (2, 3, 0, 1))   # HWIO -> (in, out, k, k)
    return np.transpose(a, (3, 2, 0, 1))       # HWIO -> OIHW


def _to_flax_kernel(key, a, transposed):
    if a.ndim == 2:
        return a.T
    if key.startswith(transposed):
        return np.transpose(a, (2, 3, 0, 1))   # (in, out, k, k) -> HWIO
    return np.transpose(a, (2, 3, 1, 0))       # OIHW -> HWIO


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path):
    segs = [f"layers.{_LAYER.match(s).group(1)}" if _LAYER.match(s) else s
            for s in path[:-1]]
    leaf = "weight" if path[-1] == "kernel" else path[-1]
    return ".".join(segs + [leaf])


def _apply_rule(key, a, rules, inverse):
    for prefix, (side, perm) in rules.items():
        if not key.startswith(prefix):
            continue
        p = np.argsort(perm) if inverse else perm
        if side == "in" and a.ndim == 2:
            return a[:, np.concatenate([p, np.arange(len(p), a.shape[1])])]
        if side == "out":
            return a[p]
    return a


def flax_to_state_dict(params, module):
    tree = params["params"] if "params" in params else params
    rules = _perm_rules(module)
    transposed = _transposed_convs(module)
    out = {}
    for path, v in _flatten(tree):
        a = np.array(v, dtype=np.float32)
        key = _torch_key(path)
        if path[-1] == "kernel" or path[-1] in _MATRICES:
            a = _to_torch_kernel(key, a, transposed)
        out[key] = torch.from_numpy(np.ascontiguousarray(
            _apply_rule(key, a, rules, inverse=False)))
    return out


def state_dict_to_flax(state_dict, module):
    """Inverse of ``flax_to_state_dict``: {"params": nested numpy dicts}."""
    rules = _perm_rules(module)
    transposed = _transposed_convs(module)
    tree = {}
    for key, t in state_dict.items():
        a = _apply_rule(key, t.detach().cpu().numpy(), rules, inverse=True)
        segs = key.split(".")
        path, i = [], 0
        while i < len(segs) - 1:
            if segs[i] == "layers" and segs[i + 1].isdigit() and i + 1 < len(segs) - 1:
                path.append(f"layers_{segs[i + 1]}")
                i += 2
            else:
                path.append(segs[i])
                i += 1
        leaf = segs[-1]
        if leaf == "weight" or leaf in _MATRICES:
            a = _to_flax_kernel(key, a, transposed)
        if leaf == "weight":
            leaf = "kernel"
        node = tree
        for s in path:
            node = node.setdefault(s, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


def load_flax_params(module, params):
    """Copy a flax param tree into ``module`` (strict: every key must match)."""
    sd = flax_to_state_dict(params, module)
    module.load_state_dict(sd, strict=True)
    return module
