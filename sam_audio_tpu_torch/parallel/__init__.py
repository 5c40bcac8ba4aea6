"""Parallelism over torch.distributed: the (dp, tp) mesh with JAX's sharding
rules (mesh.py), the collectives (comm.py) and the sequence-parallel DiT
trunk (sp.py)."""

from sam_audio_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    param_partition_spec,
    params_pspec_tree,
    process_allgather,
    shard_batch,
    shard_params,
)
