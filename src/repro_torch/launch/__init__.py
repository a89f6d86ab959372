"""Launchers (port of ``repro.launch``): the host fault domains the
serving tier's failover keys on.  Device meshes and their devices are
multi-GPU rig sharding, ROADMAP A12."""

from repro_torch.launch.mesh import host_fault_domains

__all__ = ["host_fault_domains"]
