"""The rank function of tests/test_torch_parallel.py's resume test, in a
module of its own that imports neither jax nor the test module, so that the
spawned ranks import only torch and the port."""

import torch

from ardae_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from ardae_tpu_torch.parallel.mesh import sample_parallel_mesh
from ardae_tpu_torch.parallel.workers import joint_state
from ardae_tpu_torch.train.step import StepConfig, train_chunk


def resumed_steps(device, spec, at, directory):
    """A parallel/workers.py joint-step spec on its (dp, sp) mesh: steps
    1..``at`` as one chunk, a checkpoint there (rank 0 saves the state and
    the training generator, as a driver does), every rank loading it into a
    fresh state, then the other steps as a second chunk. Returns the final
    state as snapshot {step: state dict} and the last chunk's metrics, in
    parallel/workers.py's layout."""
    mesh = sample_parallel_mesh(spec["dp"], spec["sp"], device)
    cfg, data = StepConfig(**spec["cfg"]), torch.as_tensor(spec["data"])
    generator = torch.Generator(device=device).manual_seed(spec["seed"])

    def chunk(state, steps):
        return train_chunk(state, cfg, data, spec["cdae_idx"][steps],
                           spec["model_idx"][steps], generator,
                           lambda s: spec["beta"], spec["binarize"], mesh=mesh)

    state = joint_state(spec, device)
    chunk(state, slice(0, at))
    if mesh.rank == 0:
        save_checkpoint(state, {"i_ep": state.step}, directory, "checkpoint",
                        generator)
    mesh.barrier()
    state = joint_state(spec, device)
    load_checkpoint(state, directory, "checkpoint", generator)
    metrics = chunk(state, slice(at, None))
    return {"snapshots": {state.step: state.state_dict()},
            "metrics": [{n: float(v) for n, v in metrics.items()}]}
