"""Host fault domains (port of ``repro.launch.mesh``).

The port has no device mesh yet (multi-GPU rig sharding is ROADMAP
A12), so the domains are named from the mesh's axis sizes alone: the
names, not the devices behind them, are what the failover layer keys
on.  ``make_host_mesh`` and ``domain_devices`` wait for A12.
"""

from __future__ import annotations

import typing


def host_fault_domains(sizes: typing.Mapping[str, int],
                       axis: str = "data") -> tuple[str, ...]:
    """Name one host fault domain per index along ``axis`` of a mesh
    with axis sizes ``sizes`` (for example ``{"data": 4, "model": 1}``,
    a JAX mesh's ``dict(mesh.shape)``): the unit of failure for
    multi-host failover is a serving HOST (every device behind one index
    of the sharded rig axis dies together), not a device.
    ``serving.failover.HostMap`` assigns rigs to these domain ids and
    redistributes them when one goes down."""
    sizes = dict(sizes)
    if axis not in sizes:
        raise ValueError(
            f"host_fault_domains: mesh has no axis {axis!r} "
            f"(axes: {tuple(sizes)})")
    return tuple(f"host{i}" for i in range(int(sizes[axis])))
