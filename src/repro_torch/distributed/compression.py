"""8-bit feature wire format (port of the feature/match wire of
``repro.distributed.compression``).

The serving tier ships frontend outputs off the accelerator (VO
backend, fleet uplink).  Descriptors are bit patterns, not magnitudes:
they cross as a lossless 4-byte little-endian view of each 32-bit word
(256 bits stay 256 bits, Hamming distances unchanged).  Float fields
(coordinates, scores, angles, disparity, depth) go through the int8 +
scale quantizer (absolute error at most scale / 2, about max|x| / 254);
validity masks pack to one bit per entry; match indices and distances
fit uint16 with a no-match sentinel.  Poses and 3-D points ship raw.

Every tensor of a wire dict stays on the device of the output it was
made from, and every payload is byte-identical to the JAX package's
encoding of the same output.  Two rules keep it so:

* each division is tensor / tensor with a 0-d tensor on the operand's
  device: on a card, torch divides by a Python or host scalar through
  its reciprocal, which rounds differently from a true division;
* the port keeps descriptors as int32 bit-views (``FeatureSet.desc``),
  so the wire bytes are a byte view of them and decoding is the inverse
  view: no arithmetic on uint32, which torch on the CPU cannot shift.

The int8 gradient ring (``compressed_psum``) is not ported here: it
belongs to multi-device rig sharding (ROADMAP A12).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import DepthSet, FeatureSet, MatchSet, PoseSet

#: uint16 sentinel for "no match" slots (right_index == -1 or distance
#: >= the kernels' no-candidate distance).  Real Hamming distances are
#: <= 256 and real indices are < max_features, so the sentinel is
#: unambiguous while K < WIRE_NO_MATCH (``encode_matches`` checks).
WIRE_NO_MATCH = 0xFFFF


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device, filled there: a copy
    from the host would wait for the card's stream."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _quant(x: torch.Tensor):
    """int8 codes and the float32 scale max|x| / 127 + 1e-30 (a 0-d
    tensor on ``x``'s device); codes round half to even, as
    ``jnp.round``."""
    x = x.to(torch.float32)
    scale = (x.abs().max() / _scalar(127.0, x)) + _scalar(1e-30, x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def encode_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 bit-views of the rBRIEF words -> (..., 32) uint8
    wire bytes, little-endian per word.  Lossless: a byte view (of the
    flat words, which an empty set has too)."""
    flat = desc.to(torch.int32).reshape(-1)
    return flat.view(torch.uint8).reshape(tuple(desc.shape[:-1]) + (32,))


def decode_descriptors(wire: torch.Tensor) -> torch.Tensor:
    """Inverse of ``encode_descriptors``: (..., 32) uint8 -> (..., 8)
    int32 bit-views, bit-exact."""
    flat = wire.reshape(-1)
    return flat.view(torch.int32).reshape(tuple(wire.shape[:-1]) + (8,))


def quantize_f32(x: torch.Tensor):
    """Public int8 + scale quantizer for float feature fields.  Returns
    (int8 codes, float32 scale); absolute error is bounded by scale / 2
    ~= max|x| / 254."""
    return _quant(x)


def dequantize_f32(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return _dequant(q, scale)


def _bit_weights(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def _pack_mask(valid: torch.Tensor) -> torch.Tensor:
    """A bool mask of any shape -> uint8 bytes, eight entries a byte,
    the first in the lowest bit, the tail padded with zeros."""
    flat = valid.reshape(-1).to(torch.uint8)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % 8)])
    bits = flat.view(-1, 8) << _bit_weights(flat.device)
    return bits.sum(-1, dtype=torch.uint8)


def _unpack_mask(packed: torch.Tensor, shape) -> torch.Tensor:
    bits = (packed[:, None] >> _bit_weights(packed.device)) & 1
    n = int(np.prod(shape))
    return bits.reshape(-1)[:n].reshape(tuple(shape)).to(torch.bool)


def _encode_u16(x: torch.Tensor, no_value: int) -> torch.Tensor:
    """int32 field -> uint16 with WIRE_NO_MATCH for negative slots and
    slots >= ``no_value`` (so the kernels' no-candidate distance maps
    too)."""
    x = x.to(torch.int32)
    bad = (x < 0) | (x >= no_value)
    return torch.where(bad, torch.full_like(x, WIRE_NO_MATCH),
                       x).to(torch.uint16)


def _decode_u16(w: torch.Tensor, no_value: int) -> torch.Tensor:
    x = w.to(torch.int32)
    return torch.where(x == WIRE_NO_MATCH, torch.full_like(x, no_value), x)


def encode_features(feat: FeatureSet) -> dict:
    """FeatureSet -> wire dict.  Descriptors lossless (uint8 bytes);
    xy, score and theta int8 + scale; level uint8; valid packed bits."""
    qxy, sxy = _quant(feat.xy)
    qsc, ssc = _quant(feat.score)
    qth, sth = _quant(feat.theta)
    return dict(
        desc=encode_descriptors(feat.desc),
        xy=qxy, xy_scale=sxy, score=qsc, score_scale=ssc,
        theta=qth, theta_scale=sth,
        level=feat.level.to(torch.uint8),
        valid=_pack_mask(feat.valid), k=int(feat.valid.shape[-1]),
        shape=tuple(feat.valid.shape))


def decode_features(wire: dict) -> FeatureSet:
    return FeatureSet(
        xy=_dequant(wire["xy"], wire["xy_scale"]),
        level=wire["level"].to(torch.int32),
        score=_dequant(wire["score"], wire["score_scale"]),
        theta=_dequant(wire["theta"], wire["theta_scale"]),
        desc=decode_descriptors(wire["desc"]),
        valid=_unpack_mask(wire["valid"], wire["shape"]))


def encode_matches(matches: MatchSet) -> dict:
    """MatchSet -> wire dict: uint16 index and distance with the
    no-match sentinel (lossless: both are small integers), packed
    validity.

    Raises ``ValueError`` at encode time when K >= WIRE_NO_MATCH: a
    legitimate right index could then equal the sentinel and decode as
    "no match" with no error anywhere."""
    k = int(matches.right_index.shape[-1])
    if k >= WIRE_NO_MATCH:
        raise ValueError(
            f"encode_matches: matches.right_index has K = {k} "
            f">= WIRE_NO_MATCH (0x{WIRE_NO_MATCH:04X}) — a legitimate "
            "match index would collide with the uint16 no-match "
            "sentinel and decode as 'no match'.  Shrink "
            "ORBConfig.max_features or widen the wire index field "
            "before shipping this set.")
    return dict(
        right_index=_encode_u16(matches.right_index, WIRE_NO_MATCH),
        distance=_encode_u16(matches.distance, WIRE_NO_MATCH),
        valid=_pack_mask(matches.valid),
        shape=tuple(matches.valid.shape))


def decode_matches(wire: dict, *, no_match_distance: int) -> MatchSet:
    """``no_match_distance`` restores the kernels' no-candidate distance
    (``hamming_match.BIG``), so decoded sets compare equal upstream."""
    return MatchSet(
        right_index=_decode_u16(wire["right_index"], -1),
        distance=_decode_u16(wire["distance"], no_match_distance),
        valid=_unpack_mask(wire["valid"], wire["shape"]))


def encode_depth(depth: DepthSet) -> dict:
    """DepthSet -> wire dict: disparity, depth and xy_right int8 +
    scale, packed validity."""
    qd, sd = _quant(depth.disparity)
    qz, sz = _quant(depth.depth)
    qxy, sxy = _quant(depth.xy_right)
    return dict(disparity=qd, disparity_scale=sd,
                depth=qz, depth_scale=sz,
                xy_right=qxy, xy_right_scale=sxy,
                valid=_pack_mask(depth.valid),
                shape=tuple(depth.valid.shape))


def decode_depth(wire: dict) -> DepthSet:
    return DepthSet(
        disparity=_dequant(wire["disparity"], wire["disparity_scale"]),
        depth=_dequant(wire["depth"], wire["depth_scale"]),
        xy_right=_dequant(wire["xy_right"], wire["xy_right_scale"]),
        valid=_unpack_mask(wire["valid"], wire["shape"]))


def encode_pose(pose: PoseSet) -> dict:
    """PoseSet -> wire dict, lossless (raw float32 / int32 + packed
    validity): the pose is the accuracy-gated product, and 12 floats
    and an int a rig are noise beside the descriptor bytes."""
    valid = torch.atleast_1d(pose.valid.to(torch.bool))
    return dict(rotation=pose.rotation.to(torch.float32),
                translation=pose.translation.to(torch.float32),
                inliers=pose.inliers.to(torch.int32),
                valid=_pack_mask(valid),
                shape=tuple(pose.valid.shape))


def decode_pose(wire: dict) -> PoseSet:
    return PoseSet(
        rotation=wire["rotation"], translation=wire["translation"],
        inliers=wire["inliers"],
        valid=_unpack_mask(wire["valid"], wire["shape"]))


def encode_points(points: torch.Tensor) -> dict:
    """Rig-frame 3-D points -> wire dict, lossless raw float32.  Their
    validity is not repeated: the feature and depth masks on the wire
    already say which points are usable."""
    return dict(points=points.to(torch.float32),
                shape=tuple(points.shape))


def decode_points(wire: dict) -> torch.Tensor:
    return wire["points"]


def wire_bytes(wire: dict) -> int:
    """Total payload bytes of a wire dict (or a nest of them): tensor
    element sizes only; keys and shapes ride the header."""
    return sum(wire_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size()
               for v in wire.values() if isinstance(v, (dict, torch.Tensor)))
