"""Multi-process execution layer, counterpart of gravit_tpu/parallel/.

The reference's distribution story is MPI: every rank runs the same
binary, gvtInit calls MPI_Init (api/api.cpp:76-102), the communicator moves
rays between ranks (core/comm/communicator/scomm.cpp:39-120) and IceT
composites over MPI. Here every process runs the same program on
torch.distributed, and the schedulers (schedule/) are written once against
a group (distributed.py): LocalGroup runs its members in one process,
DistGroup one member per process.
"""

from gravit_tpu_torch.parallel.distributed import (DistGroup, LocalGroup,
                                                   Mesh, global_mesh,
                                                   host_array, initialize,
                                                   is_initialized,
                                                   process_count,
                                                   process_index, shutdown)

__all__ = [
    "initialize", "shutdown", "is_initialized", "process_count",
    "process_index", "global_mesh", "host_array", "LocalGroup", "DistGroup",
    "Mesh",
]
