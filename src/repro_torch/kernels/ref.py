"""Plain PyTorch oracles and constants shared by the port's kernels
(port of the parts of ``repro.kernels.ref`` that the main path needs).

Every helper here runs on any device and is the arithmetic the CUDA
kernels are held against.  Two rules keep them bit-equal to the JAX
package's jnp oracles:

  * a division by a constant is written tensor / tensor
    (``true_div``): torch turns ``tensor / python_scalar`` into a
    multiply by the reciprocal on CUDA and ``scalar / tensor`` into
    ``reciprocal(tensor) * scalar`` everywhere, and both round
    differently from IEEE division;
  * descriptors are int32 bit-views of uint32 words (torch on the CPU
    has no uint32 shifts); bit ``i`` of a descriptor is bit ``i % 32``
    of word ``i // 32``.

The integer-datapath oracles (the paper's 8-bit word length, Sec. III;
``gaussian_blur7_u8``, ``fast_score_map_int``, ``fast_blur_nms_int``,
``patch_theta_int``) take uint8 images,
accumulate in int32 and return a uint8 blur, an int16 score and int32
moments, as the JAX package's do.  On integer-valued images each is
equal in value to its float twin: every sum is an integer below 2**24.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import pattern

# Bresenham circle of radius 3 — the 16 FAST taps, in order around the
# circle, as (dx, dy) with y down.  (paper Sec. II-B1)
CIRCLE16: tuple[tuple[int, int], ...] = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC_LEN = 9  # FAST-9/16: a corner needs >= 9 contiguous bright/dark taps

# 7x7 Gaussian (sigma=2) with integer weights — the word-length-optimized
# filter of paper Sec. III-C.
GAUSS7_WEIGHTS_INT = np.array([1, 4, 8, 10, 8, 4, 1], dtype=np.int32)
GAUSS7_NORM = int(GAUSS7_WEIGHTS_INT.sum())  # 36

PATCH = 2 * pattern.PATCH_RADIUS + 1      # 31
RADIUS = pattern.PATCH_RADIUS             # 15

# theta -> steering bin: nearest bin center, bins at b * ANGLE_BIN_STEP.
INV_ANGLE_STEP = float(np.float32(pattern.N_ANGLE_BINS / (2.0 * np.pi)))


def int_threshold(threshold: float) -> int:
    """FAST threshold for an integer datapath: for integer scores
    ``score > threshold`` == ``score > floor(threshold)``."""
    return int(np.floor(threshold))


def true_div(x: torch.Tensor, value: float) -> torch.Tensor:
    """IEEE float32 ``x / value`` on every device (see module note)."""
    return x / torch.tensor(value, dtype=x.dtype, device=x.device)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression of (..., H, W) score maps, -1 outside the
    image: keep a positive score that is >= all 8 neighbours (the JAX
    package's ``ref.nms3``, and the NMS of the dense FE kernel)."""
    shape = score.shape
    s = score.reshape(-1, *shape[-2:])
    spad = F.pad(s[:, None], (1, 1, 1, 1), value=-1.0)[:, 0]
    rmax = torch.maximum(torch.maximum(spad[:, :-2], spad[:, 1:-1]),
                         spad[:, 2:])
    nmax = torch.maximum(torch.maximum(rmax[:, :, :-2], rmax[:, :, 1:-1]),
                         rmax[:, :, 2:])
    out = (torch.where(s >= nmax, s, torch.zeros_like(s))
           * (s > 0).to(s.dtype))
    return out.reshape(shape)


def clamped_index(start: torch.Tensor, size: int, limit) -> torch.Tensor:
    """(..., ) int starts -> (..., size) indices ``clamp(start + i, 0,
    limit - 1)``: edge replication of a window read is per-axis
    clamping.  ``limit`` may be an int or a tensor broadcastable to
    ``start``."""
    idx = start[..., None] + torch.arange(size, device=start.device)
    if isinstance(limit, torch.Tensor):
        return torch.minimum(idx.clamp(min=0), limit[..., None] - 1)
    return idx.clamp(0, limit - 1)


def edge_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W) of any dtype -> (..., H + 2r, W + 2r), the edge pixel
    replicated, by clamped indices (``F.pad``'s replicate mode takes no
    integer tensor on the card)."""
    h, w = x.shape[-2:]
    start = torch.tensor(-r, device=x.device)
    rows = clamped_index(start, h + 2 * r, h)
    cols = clamped_index(start, w + 2 * r, w)
    return x[..., rows[:, None], cols[None, :]]


def gaussian_blur7_u8(img: torch.Tensor) -> torch.Tensor:
    """Integer 7x7 Gaussian: (..., H, W) uint8 -> uint8, int32
    accumulators and the round-half-up quotient (v + 648) // 1296.
    v + 648 <= 255 * 1296 + 648 < 2**24, so the float blur's
    floor((v + 648) / 1296) is the same quotient."""
    h, w = img.shape[-2:]
    pad = edge_pad(img.to(torch.int32), 3)
    wts = [int(v) for v in GAUSS7_WEIGHTS_INT]
    horiz = sum(wts[k] * pad[..., :, k:k + w] for k in range(7))
    vert = sum(wts[k] * horiz[..., k:k + h, :] for k in range(7))
    norm2 = GAUSS7_NORM * GAUSS7_NORM
    return torch.div(vert + norm2 // 2, norm2,
                     rounding_mode="floor").to(torch.uint8)


def fast_score_map_int(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Integer FAST-9/16: (..., H, W) uint8 -> int16 score map.  Taps
    lie in [-255, 255], so int16 is exact; the threshold compare is
    against ``int_threshold(threshold)``."""
    h, w = img.shape[-2:]
    x = img.to(torch.int32)
    pad = edge_pad(x, 3)
    taps = [pad[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - x
            for dx, dy in CIRCLE16]
    ext = taps + taps[:ARC_LEN - 1]
    bright = dark = None
    for s in range(len(taps)):
        mn = mx = ext[s]
        for j in range(1, ARC_LEN):
            mn = torch.minimum(mn, ext[s + j])
            mx = torch.maximum(mx, ext[s + j])
        bright = mn if bright is None else torch.maximum(bright, mn)
        dark = mx if dark is None else torch.minimum(dark, mx)
    score = torch.maximum(bright, -dark)
    keep = score > int_threshold(threshold)
    return torch.where(keep, score, torch.zeros_like(score)).to(torch.int16)


def fast_blur_nms_int(img: torch.Tensor, threshold: float, *,
                      nms: bool = True):
    """uint8 oracle of the dense FE: (..., H, W) uint8 -> (blur uint8,
    score int16), the integer twins of the float outputs."""
    score = fast_score_map_int(img, threshold)
    return gaussian_blur7_u8(img), nms3(score) if nms else score


def moment_grids(device=None):
    """The circular-mask moment grids (X_GRID, Y_GRID), float32."""
    r = torch.arange(PATCH, dtype=torch.float32, device=device) - RADIUS
    yy, xx = r[:, None].expand(PATCH, PATCH), r[None, :].expand(PATCH, PATCH)
    mask = (xx * xx + yy * yy <= float(RADIUS * RADIUS)).float()
    return xx * mask, yy * mask


def moment_grids_int(device=None):
    """The moment grids as int32, for the integer moments."""
    xg, yg = moment_grids(device)
    return xg.to(torch.int32), yg.to(torch.int32)


# Elements of one torch.atan2 call: a multiple of 64, and below torch's
# 32,768-element grain, so the call runs on one thread.
ATAN2_CHUNK = 16384


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``torch.atan2`` whose value for an element does not depend on
    where the element lies in the tensor.  On the CPU torch computes
    whole SIMD vectors with one routine and the tail past the last whole
    vector with another, and the two differ by an ulp; each thread of a
    larger call has such a tail too.  So the operands are padded to a
    multiple of 64 elements and taken in ``ATAN2_CHUNK``-element calls,
    each on one thread, and every element takes the vector routine."""
    n = y.numel()
    pad = (-n) % 64
    yy = torch.cat([y.reshape(-1), y.new_zeros(pad)])
    xx = torch.cat([x.reshape(-1), x.new_ones(pad)])
    out = torch.cat([torch.atan2(a, b) for a, b in
                     zip(yy.split(ATAN2_CHUNK), xx.split(ATAN2_CHUNK))])
    return out[:n].reshape(y.shape)


def patch_theta(patches: torch.Tensor):
    """(..., 31, 31) raw patches -> (theta (...,), moments (..., 2)):
    intensity-centroid moments over the circular patch (paper Eq. 1),
    theta = atan2(m01, m10), the same for a keypoint in any batch."""
    xg, yg = moment_grids(patches.device)
    m10 = (patches * xg).sum(dim=(-2, -1))
    m01 = (patches * yg).sum(dim=(-2, -1))
    return atan2(m01, m10), torch.stack([m10, m01], dim=-1)


def patch_theta_int(patches: torch.Tensor):
    """uint8 (..., 31, 31) patches -> (theta (...,) float32, moments
    (..., 2) int32), int32 accumulators.  |m10|, |m01| <= 255 * 4,528 <
    2**24, so the moments converted to float32 are exact and theta is
    ``patch_theta``'s on the same values."""
    xg, yg = moment_grids_int(patches.device)
    p = patches.to(torch.int32)
    m10 = (p * xg).sum(dim=(-2, -1), dtype=torch.int32)
    m01 = (p * yg).sum(dim=(-2, -1), dtype=torch.int32)
    return atan2(m01.float(), m10.float()), torch.stack([m10, m01], dim=-1)


def theta_to_bin(theta: torch.Tensor) -> torch.Tensor:
    """(...,) float32 theta -> (...,) int64 steering bin in [0, 12):
    round half to even, then a Python-style (non-negative) mod."""
    return torch.remainder(torch.round(theta * INV_ANGLE_STEP).long(),
                           pattern.N_ANGLE_BINS)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 bit-views, bit i of word i // 32."""
    w = bits.reshape(*bits.shape[:-1], 8, 32).long()
    shifts = torch.arange(32, device=bits.device)
    words = (w << shifts).sum(dim=-1)                     # < 2**32, exact
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


@functools.lru_cache(maxsize=8)
def steer_lut(device: str) -> torch.Tensor:
    """The (12, 256, 2) int32 steering ROM on ``device``."""
    return torch.from_numpy(pattern.STEER_LUT.copy()).to(device)


@functools.lru_cache(maxsize=8)
def steer_lut_packed(device: str) -> torch.Tensor:
    """The steering ROM as the sparse FE kernels read it: (12, 256)
    int32, each pair's two patch indices (< 961) in one word, A in the
    low 16 bits and B in the high 16."""
    lut = steer_lut(device)
    return (lut[..., 0] | (lut[..., 1] << 16)).contiguous()


def lut_descriptor(sm_patches: torch.Tensor,
                   bins: torch.Tensor) -> torch.Tensor:
    """(..., 31, 31) smoothed patches + (...,) steering bins -> (..., 8)
    int32 rBRIEF bit-views: tau = p(A) < p(B) over the bin's
    ``STEER_LUT`` row (paper Eq. 2; ``repro.kernels.ref.lut_descriptor``)."""
    lut = steer_lut(str(sm_patches.device))[bins.long()].long()
    flat = sm_patches.flatten(-2)
    pa = torch.gather(flat, -1, lut[..., 0])
    pb = torch.gather(flat, -1, lut[..., 1])
    return pack_bits(pa < pb)


def extract_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(H, W) image + (K, 2) int centers -> (K, 31, 31) patches.

    Centers are clamped into the image and the window replicates the
    edge, exactly ``repro.kernels.ref.extract_patches``."""
    h, w = img.shape
    x = xy[:, 0].long().clamp(0, w - 1)
    y = xy[:, 1].long().clamp(0, h - 1)
    rows = clamped_index(y - RADIUS, PATCH, h)
    cols = clamped_index(x - RADIUS, PATCH, w)
    return img[rows[:, :, None], cols[:, None, :]]


def round_center(coord: torch.Tensor, limit: int) -> torch.Tensor:
    """Float center -> int64 pixel: round half to even, then clamp."""
    return torch.round(coord).long().clamp(0, limit - 1)


def gather_patches(img: torch.Tensor, xy: torch.Tensor, ph: int, pw: int):
    """(ph, pw) windows centered at the rounded, clamped float centers
    ``xy`` (K, 2) of one (H, W) image, edge-replicated — the FM stage's
    patch-read semantics (``repro.kernels.ref.gather_patches``)."""
    h, w = img.shape
    xs = round_center(xy[:, 0], w)
    ys = round_center(xy[:, 1], h)
    rows = clamped_index(ys - ph // 2, ph, h)
    cols = clamped_index(xs - pw // 2, pw, w)
    return img[rows[:, :, None], cols[:, None, :]]


def sad_search(left_patches: torch.Tensor,
               right_strips: torch.Tensor) -> torch.Tensor:
    """(K, P, P) x (K, P, P + 2R) -> (K, 2R + 1) int32 SAD table; pixels
    are truncated to int32 first, as the JAX oracle's ``astype``."""
    p = left_patches.shape[1]
    sweep = right_strips.shape[-1] - p + 1
    lp = left_patches.to(torch.int32)
    rs = right_strips.to(torch.int32)
    return torch.stack([(lp - rs[:, :, s:s + p]).abs().sum(dim=(1, 2),
                                                          dtype=torch.int32)
                        for s in range(sweep)], dim=1)
