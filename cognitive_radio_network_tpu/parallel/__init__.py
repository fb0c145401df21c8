"""Scale-out: device meshes, overlap-save halo exchange, sharded pipelines.

Replaces the reference's distributed backend (TCP star + ssh process launch,
SURVEY.md §2.5) with one pjit-ed program over a ``jax.sharding.Mesh``:
in-graph collectives between devices (``ppermute`` for FIR halo exchange,
``psum`` for spectrum reductions, which XLA hands to NCCL on GPUs) and
``jax.distributed`` for multi-host.
"""

from cognitive_radio_network_tpu.parallel.mesh import make_mesh, MeshSpec
from cognitive_radio_network_tpu.parallel.halo import halo_exchange, sharded_channelize
from cognitive_radio_network_tpu.parallel.wideband import (
    WidebandConfig,
    wideband_sense,
    make_wideband_fn,
)

__all__ = [
    "make_mesh",
    "MeshSpec",
    "halo_exchange",
    "sharded_channelize",
    "WidebandConfig",
    "wideband_sense",
    "make_wideband_fn",
]
