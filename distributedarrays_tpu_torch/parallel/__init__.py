"""parallel of the PyTorch port: collectives (the static half of SPMD mode),
the reshard planner, and SPMD mode."""

from . import collectives, reshard, spmd_mode  # noqa: F401
from .collectives import (axis_rank, axis_size, halo_exchange,
                          halo_exchange_2d, pall_to_all, pbarrier, pbcast,
                          pgather, preduce, pshift, psum_scatter, run_spmd,
                          spmd_mesh)
from .spmd_mode import (SPMDContext, barrier, bcast, close_context, context,
                        context_local_storage, gather_spmd, myid, nprocs,
                        recvfrom, recvfrom_any, scatter, sendto, spmd,
                        spmd_async)
