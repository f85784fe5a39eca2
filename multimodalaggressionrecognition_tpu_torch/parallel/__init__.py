"""Data and tensor parallelism on torch.distributed (the JAX package's
parallel/): process groups and batch layout (mesh.py), the placement of a
model and its training state on a (dp x tp) mesh (sharding_rules.py), and
`dryrun_multichip` (dryrun.py), the twin of the JAX package's multi-chip
dry run."""

from .mesh import (data_sharding, initialize_distributed, make_mesh,
                   replicated_sharding, shard_batch)


def dryrun_multichip(n_devices: int, timeout: float = 600) -> str:
    """One dp x tp flagship train step over `n_devices` gloo ranks on the
    CPU, held to the one-process step (parallel/dryrun.py)."""
    from .dryrun import dryrun_multichip as run

    return run(n_devices, timeout)
