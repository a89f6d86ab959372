"""Core library of the port: the session layer (``VisualSystem``) over
the FE engine (``orb``), the FM engine (``matching``: the fused
matcher and the unfused oracle schedule), the pyramid, top-K selection,
the stereo VO backend (``backend``: triangulation, Kabsch, Gauss-Newton
refinement, the robust relative pose and trajectory integration); the
single-image FE API (``extract_features``, and the paper's FE modules
``pyramid.build_pyramid``, ``fast.detect`` / ``fast.orientations``,
``brief.smooth`` / ``brief.describe``); and the legacy free functions
(``process_quad_frame``, ``run_sequence*``, ``stereo_match``, ...), thin
deprecation shims over the session (``frontend`` has the migration
map)."""

from repro_torch.core.types import (CameraIntrinsics, DepthSet, FeatureSet,
                                    LocalizationOutput, LocalizationState,
                                    MatchSet, ORBConfig, PoseSet,
                                    StereoOutput)
from repro_torch.core.rig import DesyncError, RigConfig
from repro_torch.core.pipeline import PipelineConfig, VisualSystem
from repro_torch.core.orb import (extract_features, extract_features_batched,
                                  extract_features_per_level)
from repro_torch.core.matching import (match_pair_fused, match_pair_unfused,
                                       sad_rectify, sad_rectify_unfused,
                                       stereo_match, stereo_match_unfused,
                                       temporal_match)
from repro_torch.core.frontend import (extract_pair, match_pair,
                                       pipeline_schedule, process_quad_frame,
                                       process_stereo_frame, run_sequence,
                                       run_sequence_pipelined)
from repro_torch.core import backend, brief, fast, pyramid, sync  # noqa: F401

__all__ = [
    "CameraIntrinsics", "DepthSet", "FeatureSet", "LocalizationOutput",
    "LocalizationState", "MatchSet", "ORBConfig", "PoseSet", "StereoOutput",
    "RigConfig", "DesyncError", "PipelineConfig",
    "VisualSystem", "extract_features", "extract_features_batched",
    "extract_features_per_level", "stereo_match", "stereo_match_unfused",
    "sad_rectify", "sad_rectify_unfused", "match_pair_fused",
    "match_pair_unfused", "temporal_match", "extract_pair", "match_pair",
    "process_stereo_frame", "process_quad_frame", "run_sequence",
    "run_sequence_pipelined", "pipeline_schedule", "backend", "brief",
    "fast", "pyramid", "sync",
]
