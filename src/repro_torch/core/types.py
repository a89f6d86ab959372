"""Shared output types and configs of the visual frontend (port of
``repro.core.types``).

Outputs are NamedTuples of torch tensors with the JAX package's field
names, shapes and dtypes, with one exception: descriptors travel as
int32 bit-views of the 8 x uint32 rBRIEF words, because torch on the
CPU has no uint32 shifts; compare them as ``desc.numpy().view(np.uint32)``
at the boundary.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class FeatureSet(NamedTuple):
    """Static-shape top-K feature list with a validity mask; every field
    shares the leading K axis (after any batch axes)."""

    xy: torch.Tensor       # (K, 2) float32 — (x, y) in level-0 pixels
    level: torch.Tensor    # (K,)  int32 — pyramid level of the point
    score: torch.Tensor    # (K,)  float32 — FAST corner score
    theta: torch.Tensor    # (K,)  float32 — patch orientation (rad)
    desc: torch.Tensor     # (K, 8) int32 — bit-view of 8 uint32 words
    valid: torch.Tensor    # (K,)  bool

    @property
    def k(self) -> int:
        return self.xy.shape[-2]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)


class MatchSet(NamedTuple):
    """Stereo matches: one candidate per left feature."""

    right_index: torch.Tensor   # (K,) int32 — index into right FeatureSet
    distance: torch.Tensor      # (K,) int32 — Hamming distance of best
    valid: torch.Tensor         # (K,) bool — passed the match gates

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)


class DepthSet(NamedTuple):
    """Per-left-feature disparity/depth after SAD rectification."""

    disparity: torch.Tensor     # (K,) float32 — rectified disparity (px)
    depth: torch.Tensor         # (K,) float32 — fx * baseline / disp (m)
    xy_right: torch.Tensor      # (K, 2) float32 — rectified right coords
    valid: torch.Tensor         # (K,) bool

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)


class StereoOutput(NamedTuple):
    """One processed frame: per-pair features, matches and depth, with
    a leading (n_pairs,) axis on every field."""

    features_l: FeatureSet
    features_r: FeatureSet
    matches: MatchSet
    depth: DepthSet


class PoseSet(NamedTuple):
    """Relative rig pose(s) from the localization backend:
    ``p_curr = rotation @ p_prev + translation`` over rig-frame points.
    A degenerate solve (first frame, < 3 usable correspondences,
    collapsed geometry) is exactly identity + ``valid=False``, never
    NaN.  Leading axes: none for ``process_frame``, ``(T,)`` for
    ``run``."""

    rotation: torch.Tensor     # (..., 3, 3) float32
    translation: torch.Tensor  # (..., 3)    float32
    inliers: torch.Tensor      # (...,)      int32 — final solve support
    valid: torch.Tensor        # (...,)      bool


class LocalizationOutput(NamedTuple):
    """One localized frame: the stereo output, the rig-frame 3-D points
    of its left features ((..., n_pairs, K, 3), exactly zero where the
    feature or its depth is invalid) and the relative ego-motion since
    the previous frame.  The frontend fields delegate, so
    ``StereoOutput`` consumers read either type."""

    stereo: StereoOutput
    points: torch.Tensor       # (..., n_pairs, K, 3) float32, rig frame
    pose: PoseSet

    @property
    def features_l(self) -> FeatureSet:
        return self.stereo.features_l

    @property
    def features_r(self) -> FeatureSet:
        return self.stereo.features_r

    @property
    def matches(self) -> MatchSet:
        return self.stereo.matches

    @property
    def depth(self) -> DepthSet:
        return self.stereo.depth


class LocalizationState(NamedTuple):
    """The previous frame's memory the temporal pose solve consumes
    (``repro_torch.localization.state_from``): left descriptors (int32
    bit-views, as ``FeatureSet.desc``), matcher meta rows, rig-frame
    points and the feature-and-depth usability mask."""

    desc: torch.Tensor         # (..., n_pairs, K, 8) int32
    meta: torch.Tensor         # (..., n_pairs, K, 4) float32 (x,y,lvl,valid)
    points: torch.Tensor       # (..., n_pairs, K, 3) float32, rig frame
    valid: torch.Tensor        # (..., n_pairs, K) bool — feature & depth


def map_fields(fn, tup):
    """Apply ``fn`` to every tensor of a (nested) output NamedTuple —
    the port's stand-in for ``jax.tree.map`` over outputs."""
    return type(tup)(*[map_fields(fn, f) if isinstance(f, tuple) else fn(f)
                       for f in tup])


def combine_fields(fn, tups):
    """Join several output NamedTuples of one type leaf by leaf:
    ``fn`` takes the list of one leaf's tensors (``torch.stack`` over
    frames, ``torch.cat`` along a batch axis)."""
    first = tups[0]
    return type(first)(*[
        combine_fields(fn, [t[i] for t in tups]) if isinstance(f, tuple)
        else fn([t[i] for t in tups]) for i, f in enumerate(first)])


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    fx: float = 460.0
    fy: float = 460.0
    cx: float = 640.0
    cy: float = 360.0
    baseline: float = 0.12    # stereo baseline in metres

    def scaled(self, s: float) -> "CameraIntrinsics":
        return CameraIntrinsics(self.fx * s, self.fy * s,
                                self.cx * s, self.cy * s, self.baseline)


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """Visual-frontend configuration (paper defaults)."""

    height: int = 720
    width: int = 1280
    n_levels: int = 2               # two-layer pyramid (Sec. III-C)
    scale_factor: float = 1.2       # 1280x720 -> 1067x600, as in the paper
    max_features: int = 1000        # static top-K
    fast_threshold: int = 20        # FAST intensity threshold
    nms: bool = True                # 3x3 non-max suppression on score map
    border: int = 16                # keep 31x31 patches inside the image
    # --- matching ---
    row_band: int = 2               # epipolar search half-height
    max_disparity: int = 96         # search range x_L - x_R in [0, max]
    max_hamming: int = 64           # match acceptance threshold (of 256)
    # --- SAD rectification ---
    sad_window: int = 11            # 11x11 patch (Sec. III-D)
    sad_range: int = 5              # slide +-range pixels
    # --- arithmetic (paper Sec. III-C word-length optimization) ---
    quantized: bool = True          # integer-valued levels and blur

    def level_shape(self, level: int) -> tuple[int, int]:
        """(H, W) of a pyramid level, matching the paper's rounding."""
        h, w = self.height, self.width
        for _ in range(level):
            h = int(round(h / self.scale_factor))
            w = int(round(w / self.scale_factor))
        return h, w

    def features_per_level(self) -> list[int]:
        """Split the top-K budget across levels proportional to area."""
        areas = [self.level_shape(l)[0] * self.level_shape(l)[1]
                 for l in range(self.n_levels)]
        total = sum(areas)
        ks = [max(1, int(self.max_features * a / total)) for a in areas]
        ks[0] += self.max_features - sum(ks)
        return ks
