"""Core library of the port: the session layer (``VisualSystem``) over
the FE engine (``orb``), the FM engine (``matching``), the pyramid and
top-K selection."""

from repro_torch.core.types import (CameraIntrinsics, DepthSet, FeatureSet,
                                    MatchSet, ORBConfig, StereoOutput)
from repro_torch.core.rig import DesyncError, RigConfig
from repro_torch.core.pipeline import PipelineConfig, VisualSystem
from repro_torch.core import sync  # noqa: F401

__all__ = [
    "CameraIntrinsics", "DepthSet", "FeatureSet", "MatchSet", "ORBConfig",
    "StereoOutput", "RigConfig", "DesyncError", "PipelineConfig",
    "VisualSystem", "sync",
]
