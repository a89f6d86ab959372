"""Core library of the port: the session layer (``VisualSystem``) over
the FE engine (``orb``), the FM engine (``matching``), the pyramid,
top-K selection and the rigid alignment of the pose solve
(``backend``)."""

from repro_torch.core.types import (CameraIntrinsics, DepthSet, FeatureSet,
                                    LocalizationOutput, LocalizationState,
                                    MatchSet, ORBConfig, PoseSet,
                                    StereoOutput)
from repro_torch.core.rig import DesyncError, RigConfig
from repro_torch.core.pipeline import PipelineConfig, VisualSystem
from repro_torch.core import sync  # noqa: F401

__all__ = [
    "CameraIntrinsics", "DepthSet", "FeatureSet", "LocalizationOutput",
    "LocalizationState", "MatchSet", "ORBConfig", "PoseSet", "StereoOutput", "RigConfig", "DesyncError", "PipelineConfig",
    "VisualSystem", "sync",
]
