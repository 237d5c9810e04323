"""Multi-process training (counterpart of ``open_clip_tpu/parallel``): process groups
and host collectives (``distributed``), the (data, fsdp) mesh and FSDP2 sharding
(``mesh``). Importing the package starts no process group."""

from .distributed import init_distributed, is_primary, world_info_from_env
from .mesh import DATA_AXIS, FSDP_AXIS, create_mesh, shard_batch, shard_model

__all__ = ["DATA_AXIS", "FSDP_AXIS", "create_mesh", "init_distributed", "is_primary",
           "shard_batch", "shard_model", "world_info_from_env"]
