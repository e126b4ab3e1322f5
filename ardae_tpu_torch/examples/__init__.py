"""The reference notebooks' workloads on the port (JAX twins:
examples/{dae_toy,ardae_toy,ardae_fit}.py): swiss-roll score matching with
a DAE and an AR-DAE, and energy fitting with an implicit sampler. Each runs
as ``python -m ardae_tpu_torch.examples.<name>``, on the card unless
``--no-cuda`` is given."""
