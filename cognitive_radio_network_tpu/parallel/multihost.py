"""Multi-host initialization.

The reference scales across hosts by ssh-launching processes and speaking
raw-struct TCP (SURVEY.md §2.5).  The equivalent here is
``jax.distributed``: every host runs the same program, global device meshes
span hosts, and the collectives laid out in :mod:`.halo` / :mod:`.wideband`
run over NVLink within a host and the network across hosts.

Usage (every host):

    from cognitive_radio_network_tpu.parallel import multihost
    multihost.initialize()          # env-driven
    mesh = multihost.global_mesh(MeshSpec(time=4, channel=2, data=N//8))

Single-process runs (tests, one chip) skip initialization transparently.
"""

from __future__ import annotations

import os

import jax

from cognitive_radio_network_tpu.parallel.mesh import MeshSpec, make_mesh

__all__ = ["initialize", "is_distributed", "global_mesh", "host_local_sync"]

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """jax.distributed.initialize with env fallbacks; no-op if single-process.

    Pass the arguments or set JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID (a GPU or CPU fleet does not configure itself).
    """
    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    num_processes = num_processes or _int_env("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        # single-process, or a cluster jax.distributed detects itself
        try:
            jax.distributed.initialize()
        except Exception:
            return  # single-process fallback: nothing to do
    else:
        jax.distributed.initialize(coordinator_address, num_processes, process_id)
    _initialized = True


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def is_distributed() -> bool:
    return jax.process_count() > 1


def global_mesh(spec: MeshSpec):
    """Mesh over ALL devices across hosts (jax.devices() is global)."""
    return make_mesh(spec, devices=jax.devices())


def host_local_sync(tag: int = 0) -> None:
    """Barrier across hosts (the start-time broadcast analog,
    src/crts_controller.cpp:487-509): a tiny psum over one device per host."""
    if not is_distributed():
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(f"crn_sync_{tag}")
