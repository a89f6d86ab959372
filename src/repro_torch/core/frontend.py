"""Legacy free-function frontend API (port of ``repro.core.frontend``):
thin deprecation shims over the ``VisualSystem`` session
(``repro_torch.core.pipeline``).

MIGRATION MAP — every function below delegates to the session method on
the right (sessions are cached per configuration and device by
``pipeline.session_for``) and warns ``DeprecationWarning``:

    process_quad_frame(im, cfg, intr)     -> VisualSystem.process_frame(im)
    process_stereo_frame(l, r, cfg, intr) -> .process_frame(stack([l, r]))
    run_sequence(frames, cfg, intr)       -> .run(frames)   # "sequential"
    run_sequence_pipelined(frames, ...)   -> .run(frames)   # "pipelined"
    extract_pair(l, r, cfg)               -> .extract(stack([l, r]))
    match_pair(l, r, fl, fr, cfg, intr)   -> .match_pair(l, r, fl, fr)

The same holds for ``core.matching.stereo_match`` / ``sad_rectify`` /
``temporal_match``.  Each shim takes ``device`` ("cuda" unless the
caller asks for the CPU) where the JAX package's takes ``impl``.
``pipeline_schedule`` (the analytic Fig. 4 timeline) and
``StereoOutput`` (re-exported from ``core.types``) are not deprecated.
"""

from __future__ import annotations

import torch

from repro_torch.core.matching import _deprecated, _shim_session as _session
from repro_torch.core.types import (CameraIntrinsics, ORBConfig,  # noqa: F401
                                    StereoOutput, map_fields)


def _split_cameras(feats, n_pairs: int):
    """(B, ...) FeatureSet, B = 2 * n_pairs cameras in [L, R, L, R, ...]
    order -> (feat_l, feat_r), each with leading (n_pairs,) axes."""
    paired = map_fields(lambda x: x.reshape(n_pairs, 2, *x.shape[1:]), feats)
    return (map_fields(lambda x: x[:, 0], paired),
            map_fields(lambda x: x[:, 1], paired))


def _stack(img_l, img_r) -> torch.Tensor:
    """The (2, H, W) camera batch of one L/R pair (tensors or arrays)."""
    return torch.stack([torch.as_tensor(img_l), torch.as_tensor(img_r)])


def extract_pair(img_l, img_r, cfg: ORBConfig, device="cuda"):
    """DEPRECATED shim for ``VisualSystem.extract`` over the stacked L/R
    camera batch (two launches for the whole frame)."""
    _deprecated("core.frontend.extract_pair", "extract")
    feats = _session(cfg, None, device, 2).extract(_stack(img_l, img_r))
    return (map_fields(lambda x: x[0], feats),
            map_fields(lambda x: x[1], feats))


def match_pair(img_l, img_r, feat_l, feat_r, cfg: ORBConfig,
               intr: CameraIntrinsics, device="cuda"):
    """DEPRECATED shim for ``VisualSystem.match_pair`` (a pair batch of
    one through the fused matcher, one launch)."""
    _deprecated("core.frontend.match_pair", "match_pair")
    return _session(cfg, intr, device, 2).match_pair(img_l, img_r, feat_l,
                                                     feat_r)


def process_stereo_frame(img_l, img_r, cfg: ORBConfig,
                         intr: CameraIntrinsics,
                         device="cuda") -> StereoOutput:
    """DEPRECATED shim for ``VisualSystem.process_frame`` on a 2-camera
    rig (outputs drop the pair-batch axis)."""
    _deprecated("core.frontend.process_stereo_frame", "process_frame")
    out = _session(cfg, intr, device, 2).process_frame(_stack(img_l, img_r))
    return map_fields(lambda x: x[0], out)


def process_quad_frame(images, cfg: ORBConfig, intr: CameraIntrinsics,
                       device="cuda") -> StereoOutput:
    """DEPRECATED shim for ``VisualSystem.process_frame`` on the quad
    rig: images (4, H, W) = [pair0_L, pair0_R, pair1_L, pair1_R] ->
    StereoOutput with a leading (2,) pair axis, 3 kernel launches."""
    _deprecated("core.frontend.process_quad_frame", "process_frame")
    return _session(cfg, intr, device, 4).process_frame(images)


def run_sequence(frames, cfg: ORBConfig, intr: CameraIntrinsics,
                 device="cuda") -> StereoOutput:
    """DEPRECATED shim for ``VisualSystem.run`` under the "sequential"
    schedule: frames (T, 4, H, W) -> StereoOutput with (T, 2) axes."""
    _deprecated("core.frontend.run_sequence", "run")
    return _session(cfg, intr, device, 4).run(frames)


def run_sequence_pipelined(frames, cfg: ORBConfig, intr: CameraIntrinsics,
                           device="cuda") -> StereoOutput:
    """DEPRECATED shim for ``VisualSystem.run`` under the "pipelined"
    schedule (Fig. 4: FE(t) overlaps FM(t-1), on two CUDA streams of a
    card session): frames (T, 4, H, W) -> StereoOutput with (T, 2) axes,
    equal to ``run_sequence``'s."""
    _deprecated("core.frontend.run_sequence_pipelined", "run")
    return _session(cfg, intr, device, 4, schedule="pipelined").run(frames)


def pipeline_schedule(n_frames: int, t_fe_ms: float, t_fm_ms: float):
    """Analytic Fig. 4 timeline for the frame-multiplexed discipline.

    One FE module serves both channels (2 x t_fe per frame, serialized
    L then R); FM(t) runs concurrently with FE(t+1).  Returns a dict of
    per-frame (fe_start, fe_end, fm_start, fm_end) lists plus makespan
    and steady-state frame period max(2 * t_fe, t_fm).
    """
    fe_start, fe_end, fm_start, fm_end = [], [], [], []
    fe_free = 0.0
    fm_free = 0.0
    for _ in range(n_frames):
        s = fe_free
        e = s + 2.0 * t_fe_ms               # L then R through the shared FE
        fe_start.append(s)
        fe_end.append(e)
        ms = max(e, fm_free)
        me = ms + t_fm_ms
        fm_start.append(ms)
        fm_end.append(me)
        fe_free = e                          # FE(n+1) may start right away
        fm_free = me
    return {
        "fe_start": fe_start, "fe_end": fe_end,
        "fm_start": fm_start, "fm_end": fm_end,
        "makespan_ms": fm_end[-1],
        "steady_period_ms": max(2.0 * t_fe_ms, t_fm_ms),
        "serial_period_ms": 2.0 * t_fe_ms + t_fm_ms,
    }
