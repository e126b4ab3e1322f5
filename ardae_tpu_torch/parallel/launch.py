"""Start the ranks of a world (the port's counterpart of placing a JAX
computation on a device mesh).

``launch(fn, devices, *args)`` runs ``fn(device, *args)`` on len(devices)
ranks, rank r on ``devices[r]``: rank 0 in the calling process, so its
result may be any object (a driver's ``(state, path)``), and ranks 1..N-1
in processes started with the ``spawn`` context, whose results come back
through files. Every rank joins one process group through a ``file://``
store in a temporary directory (no TCP port to race for). The backend is
chosen from the devices, never by trying: NCCL where each rank has a card
of its own, gloo where the ranks are CPU processes or share a card (NCCL
refuses two ranks on one GPU). A rank that fails fails the run; nothing
carries on in one process.
"""

import datetime
import multiprocessing
import os
import tempfile

import torch
import torch.distributed as dist

# how long a collective waits for a missing rank before it fails
TIMEOUT = datetime.timedelta(minutes=5)
# how long a rank may take to finish once rank 0 has
JOIN_SECONDS = 120


def backend_for(devices):
    """NCCL when every rank has a card of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def _run(rank, devices, store, threads, fn, args):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend_for(devices), init_method=f"file://{store}",
                            world_size=len(devices), rank=rank, timeout=TIMEOUT)
    try:
        return fn(device, *args)
    finally:
        dist.destroy_process_group()


def _child(rank, devices, store, threads, fn, args, out):
    torch.save(_run(rank, devices, store, threads, fn, args), out)


def launch(fn, devices, *args):
    """Every rank's result, rank 0's first. ``fn`` must be importable by
    name (a module-level function) and ``args`` picklable. CPU ranks take
    the calling process's thread count."""
    devices = [str(d) for d in devices]
    ctx = multiprocessing.get_context("spawn")
    threads = torch.get_num_threads()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(len(devices))]
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, devices, store, threads, fn, args, outs[r]))
                 for r in range(1, len(devices))]
        for p in procs:
            p.start()
        try:
            first = _run(0, devices, store, threads, fn, args)
        finally:
            for p in procs:
                p.join(JOIN_SECONDS)
                if p.is_alive():
                    p.terminate()
                    p.join()
        failed = {r: p.exitcode for r, p in enumerate(procs, 1) if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"ranks failed (rank: exit code) {failed}; their "
                               "tracebacks are on standard error")
        return [first] + [torch.load(o, map_location="cpu", weights_only=False)
                          for o in outs[1:]]
