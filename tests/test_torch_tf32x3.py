"""The precision argument of the port's tensor-core GEMM core
(ardae_tpu_torch/csrc/dsm_sgemm.cuh), held on the CPU.

The core runs every fp32 product of both DSM kernels as 3xTF32: each operand
x is split as hi = tf32(x), lo = tf32(x - hi) (``cvt.rna.tf32.f32``: round to
nearest, ties away from zero, on the 13 mantissa bits TF32 drops), and each
8-deep k-step (one ``wgmma`` m64n128k8 TF32 product a term) adds lo*hi, then
hi*lo, then hi*hi into an fp32 accumulator; a weight gradient sums its
split-K partials in a fixed order.
This file emulates that arithmetic in plain PyTorch (one 8-deep k-step at a
time, in fp32) at the lines' layer shapes with the rows cut, in the three
operand layouts the core serves (forward x.W^T, input gradient dp.W, weight
gradient dp^T.h over the rows), and holds it against an fp64 product:
  * its rel-norm error is at most RATIO_BOUND times plain fp32's
    (``torch.matmul`` in fp32), and at most 1e-6;
  * one TF32 product alone misses 1e-6 by orders of magnitude, which is why
    the kernel takes three.
"""

import numpy as np
import pytest
import torch

REL_BOUND = 1e-6
RATIO_BOUND = 2.0   # 3xTF32 vs fp32 rel-norm error; the cases below give 0.68-1.15
MMA_K = 8
BK = 32             # the core's k-tile: split-K ranges are multiples of it


def tf32(x):
    """Round fp32 to TF32 as cvt.rna.tf32.f32 does (the result is fp32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def cdiv(a, b):
    return -(-a // b)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def gemm_3xtf32(a, b, splits=1):
    """a (M, K) @ b (K, N) as the core computes it: per split of K (each a
    multiple of BK rows), per 8-deep k-step, lo*hi + hi*lo + hi*hi into one
    fp32 accumulator; the splits' partials summed in order."""
    ah, al = split(a)
    bh, bl = split(b)
    K = a.shape[1]
    kps = cdiv(cdiv(K, splits), BK) * BK
    total = None
    for k_lo in range(0, K, kps):
        acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
        for k in range(k_lo, min(K, k_lo + kps), MMA_K):
            s = slice(k, min(K, k + MMA_K))
            acc += al[:, s] @ bh[s]
            acc += ah[:, s] @ bl[s]
            acc += ah[:, s] @ bh[s]
        total = acc if total is None else total + acc
    return total


def rel_err(got, want):
    return float((got.double() - want).norm() / want.norm())


def operands(layout, rows, k_or_out, width, seed):
    """(A, B, splits) of one product in its memory layout, as logical
    (M, K) and (K, N) views; inputs from a numpy seed. Activations are
    softplus outputs, weights torch-default uniform, cotangents normal."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    bound = 1.0 / np.sqrt(k_or_out)
    if layout == "forward":        # h (rows, in) . W (out, in)^T
        h = t(np.logaddexp(0.0, rng.standard_normal((rows, k_or_out))))
        w = t(rng.uniform(-bound, bound, (width, k_or_out)))
        return h, w.T, 1
    if layout == "input_grad":     # dp (rows, out) . W (out, in)
        dp = t(rng.standard_normal((rows, k_or_out)) * 1e-3)
        w = t(rng.uniform(-bound, bound, (k_or_out, width)))
        return dp, w, 1
    # weight gradient: dp (rows, out)^T . h (rows, in), K = the rows, split
    # as wgrad_splits splits it (264 blocks over the 128x128 tiles, at least
    # 16 k-tiles a split)
    dp = t(rng.standard_normal((rows, k_or_out)) * 1e-3)
    h = t(np.logaddexp(0.0, rng.standard_normal((rows, width))))
    tiles = cdiv(k_or_out, 128) * cdiv(width, 128)
    return dp.T, h, max(1, min(264 // tiles, cdiv(rows, 16 * BK)))


# (layout, rows, K or out, N): the flagship's h 512 and the implicit-conv
# line's h 256 layers, rows cut from 80,000 (the weight gradient keeps
# 20,000 rows: K there is the rows)
CASES = [
    ("forward", 1024, 512, 512),
    ("forward", 1024, 256, 256),
    ("input_grad", 1024, 512, 512),
    ("input_grad", 1024, 256, 256),
    ("weight_grad", 20000, 256, 256),
    ("weight_grad", 20000, 512, 512),
]


@pytest.mark.parametrize("layout,rows,k_or_out,width", CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}" for c in CASES])
def test_3xtf32_is_as_accurate_as_fp32(layout, rows, k_or_out, width):
    a, b, splits = operands(layout, rows, k_or_out, width, seed=rows + width)
    want = a.double() @ b.double()
    err_fp32 = rel_err(a @ b, want)
    err_3x = rel_err(gemm_3xtf32(a, b, splits), want)
    assert err_3x <= REL_BOUND, (err_3x, err_fp32)
    assert err_3x <= RATIO_BOUND * err_fp32, (err_3x, err_fp32)


def test_one_tf32_product_misses_the_bound():
    a, b, _ = operands("forward", 1024, 512, 512, seed=7)
    want = a.double() @ b.double()
    err_1x = rel_err(tf32(a) @ tf32(b), want)
    err_3x = rel_err(gemm_3xtf32(a, b), want)
    assert err_1x > 100 * REL_BOUND, err_1x
    assert err_3x <= REL_BOUND, err_3x


def test_tf32_rounding_is_round_to_nearest_ties_away():
    # 1 + 2^-11 is a tie between 1 and 1 + 2^-10: away from zero
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -12, 3.0e38], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         1.0 + 2.0 ** -10, 3.0e38], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got[:4], want[:4])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = split(x)   # hi + lo keeps x to ~22 bits
    assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()
