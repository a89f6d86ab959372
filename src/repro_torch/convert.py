"""Carry a JAX-package configuration across to the port.

The system has no learned weights: what crosses from the JAX package is
its configuration (``ORBConfig``, ``RigConfig``, ``CameraIntrinsics``)
and its ROM, the descriptor steering LUT.  The functions below take
``dataclasses.asdict(...)`` of the JAX objects — plain Python and numpy,
so this module needs neither jax nor the ``repro`` package — and build
the port's objects.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.rig import RigConfig
from repro_torch.core.sync import TriggerConfig
from repro_torch.core.types import CameraIntrinsics, ORBConfig
from repro_torch.kernels import pattern


def orb_config_from_reference(d: dict) -> ORBConfig:
    """``ORBConfig`` from ``dataclasses.asdict`` of the JAX one."""
    return ORBConfig(**d)


def intrinsics_from_reference(d: dict) -> CameraIntrinsics:
    """``CameraIntrinsics`` from ``dataclasses.asdict`` of the JAX one."""
    return CameraIntrinsics(**d)


def rig_config_from_reference(d: dict) -> RigConfig:
    """``RigConfig`` from ``dataclasses.asdict`` of the JAX one (its
    nested intrinsics and trigger config arrive as dicts)."""
    d = dict(d)
    d["intrinsics"] = tuple(intrinsics_from_reference(ic)
                            for ic in d["intrinsics"])
    if d.get("sync") is not None:
        d["sync"] = TriggerConfig(**d["sync"])
    d["pairs"] = tuple(tuple(p) for p in d["pairs"])
    return RigConfig(**d)


def steer_lut() -> np.ndarray:
    """The port's (12, 256, 2) int32 descriptor steering ROM."""
    return pattern.STEER_LUT.copy()
