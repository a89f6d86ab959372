"""Carry a JAX-package configuration across to the port.

The system has no learned weights: what crosses from the JAX package is
its configuration (``ORBConfig``, ``RigConfig``, ``CameraIntrinsics``,
``PipelineConfig``),
its ROM, the descriptor steering LUT, and the localization backend's
cross-frame state.  The functions below take plain Python and numpy —
``dataclasses.asdict(...)`` of the JAX configs, ``._asdict()`` of a JAX
state with its fields as numpy arrays — so this module needs neither
jax nor the ``repro`` package, and build the port's objects.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.rig import RigConfig
from repro_torch.core.sync import TriggerConfig
from repro_torch.core.types import (CameraIntrinsics, LocalizationState,
                                    ORBConfig)
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


def pipeline_config_from_reference(d: dict) -> PipelineConfig:
    """``PipelineConfig`` from ``dataclasses.asdict`` of the JAX one (its
    nested ``ORBConfig`` arrives as a dict), precision included.  The JAX
    package's ``impl`` (its kernel-implementation switch) has no
    counterpart here: the tensors' device picks the implementation.  Its
    ``rig_shard_axis`` (sharding a fleet's rigs over a device mesh,
    ROADMAP A12) is not ported: a set one raises."""
    d = dict(d)
    d.pop("impl", None)
    if d.pop("rig_shard_axis", None) is not None:
        raise NotImplementedError(
            "rig_shard_axis (multi-GPU rig sharding) is not ported yet "
            "(ROADMAP A12)")
    d["orb"] = orb_config_from_reference(d["orb"])
    return PipelineConfig(**d)


def localization_state_from_reference(d: dict) -> LocalizationState:
    """The port's ``LocalizationState`` from a JAX one's fields as numpy
    (``{k: np.asarray(v) for k, v in state._asdict().items()}``), with
    any leading axes (a frame's (n_pairs,), a fleet's (n_rigs,
    n_pairs)): the uint32 descriptors become the port's int32
    bit-views."""
    def tensor(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype))

    return LocalizationState(
        desc=tensor(np.asarray(d["desc"], np.uint32).view(np.int32),
                    np.int32),
        meta=tensor(d["meta"], np.float32),
        points=tensor(d["points"], np.float32),
        valid=tensor(d["valid"], bool))


def steer_lut() -> np.ndarray:
    """The port's (12, 256, 2) int32 descriptor steering ROM."""
    return pattern.STEER_LUT.copy()
