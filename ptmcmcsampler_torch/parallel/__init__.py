"""Multi-process runs over ``torch.distributed``: the port of
``ptmcmcsampler_tpu.parallel``, one process a device."""

from .distributed import (  # noqa: F401
    initialize_distributed,
    make_pt_mesh,
    process_local_block,
)
from .mesh import PTMesh, make_temp_mesh, shard_state, state_sharding  # noqa: F401
