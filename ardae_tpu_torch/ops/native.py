"""Build and bind the hand-written CUDA kernels of ``ardae_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by nvcc for sm_90a into
``build/lib<name>.so`` (a plain C interface), at first use and again
whenever the source or a shared header in ``csrc/`` is newer than the
library, and loaded with ctypes. ``build`` starts one nvcc per stale source,
all at once, so several kernels compile in parallel. Nothing is built when
this module is imported.
"""

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import time

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_REPO, "ardae_tpu_torch", "csrc")
_BUILD = os.path.join(_REPO, "build")


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the fused DSM kernels need the "
                           "CUDA toolkit to build")
    return path


def lib_path(name):
    return os.path.join(_BUILD, f"lib{name}.so")


def _stale(name):
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    sources = [os.path.join(_CSRC, f"{name}.cu")] + glob.glob(
        os.path.join(_CSRC, "*.cuh"))
    return os.path.getmtime(lib) < max(os.path.getmtime(s) for s in sources)


def build(names):
    """Compile every stale ``csrc/<name>.cu`` of ``names`` concurrently.
    Returns {name: {"seconds", "log", "built"}}; raises if any nvcc fails."""
    os.makedirs(_BUILD, exist_ok=True)
    info = {n: {"seconds": 0.0, "log": "", "built": False} for n in names}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        info[name].update(seconds=time.perf_counter() - t0, log=out)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib_path(name))
        info[name]["built"] = True
    if failed:
        raise RuntimeError("\n".join(failed))
    return info


@functools.lru_cache(maxsize=None)
def load(name):
    """(ctypes library, build info) of ``csrc/<name>.cu``, built if stale."""
    info = build([name])[name]
    return ctypes.CDLL(lib_path(name)), info


def bind_core(lib):
    """Declare the GEMM core's own entry points (csrc/dsm_sgemm.cuh), which
    every kernel library exports: its shared memory a block, the count of
    operands its loader copied with cp.async, and the core alone."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dsm_sgemm_smem_bytes.argtypes = [i, i]
    lib.dsm_sgemm_smem_bytes.restype = i
    lib.dsm_sgemm_cp_async_operands.argtypes = []
    lib.dsm_sgemm_cp_async_operands.restype = ll
    lib.dsm_sgemm_probe.argtypes = [i] * 6 + [p, i, p, i, p, p, p]
    lib.dsm_sgemm_probe.restype = i


def ptr_array(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def int_array(xs):
    return (ctypes.c_int * len(xs))(*xs)


def check_operand(t, name):
    if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
        raise ValueError(f"fused DSM kernel: {name} must be a contiguous "
                         f"float32 CUDA tensor, got {t.dtype} on {t.device}")
