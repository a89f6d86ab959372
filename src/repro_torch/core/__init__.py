"""Core library of the port: the session layer (``VisualSystem``) over
the FE engine (``orb``), the FM engine (``matching``), the pyramid,
top-K selection and the rigid alignment of the pose solve
(``backend``); the single-image FE API (``extract_features``, and the
paper's FE modules ``pyramid.build_pyramid``, ``fast.detect`` /
``fast.orientations``, ``brief.smooth`` / ``brief.describe``)."""

from repro_torch.core.types import (CameraIntrinsics, DepthSet, FeatureSet,
                                    LocalizationOutput, LocalizationState,
                                    MatchSet, ORBConfig, PoseSet,
                                    StereoOutput)
from repro_torch.core.rig import DesyncError, RigConfig
from repro_torch.core.pipeline import PipelineConfig, VisualSystem
from repro_torch.core.orb import (extract_features, extract_features_batched,
                                  extract_features_per_level)
from repro_torch.core import brief, fast, pyramid, sync  # noqa: F401

__all__ = [
    "CameraIntrinsics", "DepthSet", "FeatureSet", "LocalizationOutput",
    "LocalizationState", "MatchSet", "ORBConfig", "PoseSet", "StereoOutput",
    "RigConfig", "DesyncError", "PipelineConfig",
    "VisualSystem", "extract_features", "extract_features_batched",
    "extract_features_per_level", "brief", "fast", "pyramid", "sync",
]
