"""The multi-device paths (compose_tpu.parallel): the DTensor cell-sharded
step, communicators, the halo exchange, and the cell-sharded ISL and IR
steps."""

from .sharding import cell_mesh, shard_state, sharded_step  # noqa: F401
from .comm import DistComm, LocalComm  # noqa: F401
from .halo import HaloMaps, halo_exchange, tile_owner  # noqa: F401
from .sharded import ShardedIsl  # noqa: F401
from .sharded_ir import ShardedIr  # noqa: F401
