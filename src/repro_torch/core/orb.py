"""ORB feature extraction — the paper's Feature Extractor block (port
of ``repro.core.orb.extract_features_batched``): TWO kernel launches
per FRAME for every camera at every pyramid level.

  1. DENSE stage (``ops.fast_blur_nms_pyramid``): one launch over every
     camera x level slab -> blur + NMS'd FAST score.
  2. per-level static top-K (``fast.select_topk``, a stable sort).
  3. SPARSE stage (``ops.orient_describe_pyramid``): one launch over the
     level-sorted (B, K_total) keypoints -> theta, moments, rBRIEF.

Then the levels merge into one static-shape FeatureSet with level-0
coordinates.  ``features_from_levels`` is steps 1-3 on given pyramid
levels, so a caller (or a test) can feed its own pyramid;
``extract_features`` is the single-image view of the same 2 launches.
``extract_features_per_level`` is the per-level schedule the JAX
package keeps as its oracle (port of ``repro.core.orb.
extract_features_per_level``): the same three steps one level at a
time, 2 launches a level (K6, K7).

``precision="uint8"`` is the paper's 8-bit datapath: uint8 pyramid
levels, and the kernels' uint8 variants (int32 accumulators, a uint8
blur, int16 scores, int32 moments) in the same launches.  The FeatureSet
dtypes do not change (int16 scores are cast to float32 losslessly), and
on an integer-valued frame every field equals the float32 path's.
"""

from __future__ import annotations

import torch

from repro_torch.core import fast, pyramid
from repro_torch.core.types import FeatureSet, ORBConfig, map_fields
from repro_torch.kernels import ops


def _merge_levels(parts: list[FeatureSet]) -> FeatureSet:
    return FeatureSet(*[torch.cat([getattr(p, f) for p in parts], dim=1)
                        for f in FeatureSet._fields])


def _level_features(lvl: int, cfg: ORBConfig, xy, vals, valid,
                    theta, desc) -> FeatureSet:
    b, k_l = xy.shape[0], xy.shape[1]
    scale = cfg.scale_factor ** lvl
    return FeatureSet(
        xy=xy.float() * scale,
        level=torch.full((b, k_l), lvl, dtype=torch.int32, device=xy.device),
        # int16 scores (the uint8 datapath) cast losslessly: FAST scores
        # lie in [0, 255].  FeatureSet dtypes never change.
        score=vals.float(),
        theta=theta,
        desc=desc,
        valid=valid,
    )


def features_from_levels(levels, cfg: ORBConfig) -> FeatureSet:
    """Dense FE, top-K and sparse FE on given (B, h_l, w_l) pyramid
    levels (float32, or uint8: the 8-bit datapath) -> FeatureSet with a
    leading (B,) axis on every field."""
    ks = cfg.features_per_level()
    dense = ops.fast_blur_nms_pyramid(
        levels, float(cfg.fast_threshold), nms=cfg.nms,
        quantized=cfg.quantized)
    topk = [fast.select_topk(score, k_l, cfg.border)
            for (_smoothed, score), k_l in zip(dense, ks)]
    sparse = ops.orient_describe_pyramid(
        levels, [sm for sm, _ in dense], [xy for xy, _, _ in topk])
    return _merge_levels([
        _level_features(lvl, cfg, xy, vals, valid, theta, desc)
        for lvl, ((xy, vals, valid), (theta, _mom, desc)) in enumerate(
            zip(topk, sparse))])


def extract_features_batched(images: torch.Tensor, cfg: ORBConfig, *,
                             precision: str = "f32") -> FeatureSet:
    """images: (B, H, W) uint8/float in [0, 255] — B cameras — to a
    FeatureSet of K features per camera, in exactly 2 kernel launches,
    on the ``precision`` datapath ("f32" or "uint8")."""
    return features_from_levels(
        pyramid.build_pyramid_batched(images, cfg, precision=precision), cfg)


def extract_features(image: torch.Tensor, cfg: ORBConfig, *,
                     precision: str = "f32") -> FeatureSet:
    """image: (H, W) uint8/float in [0, 255] -> FeatureSet of K
    features, the batch-of-one view of ``extract_features_batched`` (2
    launches)."""
    return map_fields(lambda x: x[0], extract_features_batched(
        image[None], cfg, precision=precision))


def extract_features_per_level(images: torch.Tensor, cfg: ORBConfig, *,
                               precision: str = "f32") -> FeatureSet:
    """The per-level schedule: 2 launches a pyramid LEVEL (the dense FE,
    K6, then top-K, then the sparse FE, K7).  The oracle the whole-frame
    path (``extract_features_batched``, K1 + K2) is pinned to bit for
    bit, and the baseline of the paper's frame-multiplexing comparison."""
    levels = pyramid.build_pyramid_batched(images, cfg, precision=precision)
    parts = []
    for lvl, (imgs_l, k_l) in enumerate(zip(levels,
                                            cfg.features_per_level())):
        smoothed, score = ops.fast_blur_nms_batched(
            imgs_l, float(cfg.fast_threshold), nms=cfg.nms,
            quantized=cfg.quantized)
        xy, vals, valid = fast.select_topk(score, k_l, cfg.border)
        theta, _mom, desc = ops.orient_describe_batched(imgs_l, smoothed, xy)
        parts.append(_level_features(lvl, cfg, xy, vals, valid, theta, desc))
    return _merge_levels(parts)
