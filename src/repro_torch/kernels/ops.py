"""Dispatch around the port's kernels (port of the fused-path part of
``repro.kernels.ops``, of its per-level FE dispatch,
``fast_blur_nms_batched`` and ``orient_describe_batched``, and of its
unfused matcher dispatch, ``hamming_match`` and ``sad_search``).

The functions below keep the JAX package's signatures (lists of
per-level (B, h, w) batches in, per-level results out) and own the
layout the kernels take: the flat slab buffer and its ``SlabTable``,
the level-sorted keypoint block and its column-level vector.  Which
implementation runs follows the tensors' device (see each kernel
module): there is no impl switch.  Which datapath runs follows the
images' dtype, as the JAX package's ``_cast_slab``: float images run as
float32, integer images as uint8 (the paper's 8-bit datapath, each
kernel's uint8 variant, counted under the kernel's own counter).

``launch_audit()`` yields a counter of every kernel launch made inside
its scope — the port's form of the JAX package's trace-time audit;
each kernel's own ``KERNEL.launches`` integer counts its launches
process-wide.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import describe_fused as _describe
from repro_torch.kernels import fast_detect as _fast
from repro_torch.kernels import frontend_fused as _frontend
from repro_torch.kernels import gaussian_blur as _blur
from repro_torch.kernels import hamming_match as _hamming
from repro_torch.kernels import match_fused as _match_only
from repro_torch.kernels import matcher_fused as _matcher
from repro_torch.kernels import sad_fused as _sad_only
from repro_torch.kernels import sad_rectify as _sad_search
from repro_torch.kernels._build import launch_audit  # noqa: F401

#: Every hand-written kernel of the port, by name: the frame's three
#: (dense FE, sparse FE, fused matcher), then the match-only matcher
#: (``stereo_match``, ``temporal_match``, localization), the SAD-only
#: matcher (``sad_rectify``), and the single-image FE modules' three:
#: the FAST score map (``fast.detect``), the 7x7 blur (``brief.smooth``)
#: and orientation only (``fast.orientations``, ``fast.detect``); then
#: the unfused FM schedule's two: the single-pair Hamming matcher and
#: the SAD sweep (``match_pair_unfused``); last the per-level FE
#: schedule's two: the dense and the sparse FE of one level
#: (``extract_features_per_level``).
KERNELS = {
    "frontend_fused_pyramid": _frontend.KERNEL,
    "describe_fused_pyramid": _describe.KERNEL,
    "match_rectify_fused": _matcher.KERNEL,
    "match_fused": _match_only.KERNEL,
    "sad_fused": _sad_only.KERNEL,
    "fast_score_map": _fast.KERNEL,
    "gaussian_blur7": _blur.KERNEL,
    "orient_fused": _describe.ORIENT_KERNEL,
    "hamming_match": _hamming.KERNEL,
    "sad_search": _sad_search.KERNEL,
    "frontend_fused": _frontend.LEVEL_KERNEL,
    "describe_fused": _describe.LEVEL_KERNEL,
}
#: The kernels of one frame, each launched once by ``process_frame``.
FRAME_KERNELS = ("frontend_fused_pyramid", "describe_fused_pyramid",
                 "match_rectify_fused")


def _slab_dtype(images: torch.Tensor) -> torch.dtype:
    """The kernels' pixel type for ``images``: float32 for float
    images, uint8 for integer ones."""
    return torch.float32 if images.dtype.is_floating_point else torch.uint8


def _slab(images: torch.Tensor) -> torch.Tensor:
    return images.to(_slab_dtype(images)).contiguous()


def flat_levels(levels) -> torch.Tensor:
    """The flat slab buffer (float32, or uint8 for integer levels) of a
    list of (B, h_l, w_l) level batches: a view when the levels already
    lie back to back in one contiguous buffer of that type
    (``pyramid.build_pyramid_batched`` allocates them so), else a
    concatenated copy."""
    first = levels[0]
    dtype = _slab_dtype(first)
    base = first.untyped_storage().data_ptr()
    off = first.storage_offset()
    for lv in levels:
        if (not lv.is_contiguous() or lv.dtype != dtype
                or lv.untyped_storage().data_ptr() != base
                or lv.storage_offset() != off):
            return torch.cat([l.reshape(-1).to(dtype) for l in levels])
        off += lv.numel()
    return first.as_strided((off - first.storage_offset(),), (1,))


def _split(flat: torch.Tensor, levels):
    outs, off = [], 0
    for lv in levels:
        n = lv.numel()
        outs.append(flat[off:off + n].view(lv.shape))
        off += n
    return outs


def _slabs_of(levels) -> _frontend.SlabTable:
    return _frontend.slab_table([tuple(lv.shape[1:]) for lv in levels],
                                levels[0].shape[0], levels[0].device)


def fast_blur_nms_pyramid(levels, threshold: float, *, nms: bool = True,
                          quantized: bool = True):
    """Whole-pyramid dense stage: L ragged (B, h_l, w_l) level batches
    -> [(blur_l, score_l)] per level (float32 and float32, or uint8 and
    int16 for integer levels), ALL cameras x ALL levels in ONE kernel
    launch."""
    flat = flat_levels(levels)
    blur, score = _frontend.frontend_fused_pyramid(
        flat, _slabs_of(levels), threshold=float(threshold), nms=bool(nms),
        quantized=bool(quantized))
    return list(zip(_split(blur, levels), _split(score, levels)))


def fast_blur_nms_batched(imgs: torch.Tensor, threshold: float, *,
                          nms: bool = True, quantized: bool = True):
    """Per-level dense stage: (B, H, W) images of one level -> (blur,
    score), each (B, H, W) (float32, or uint8 and int16 for integer
    images), in ONE kernel launch."""
    return _frontend.frontend_fused(
        _slab(imgs), threshold=float(threshold), nms=bool(nms),
        quantized=bool(quantized))


def _image_batch(img: torch.Tensor) -> torch.Tensor:
    """(H, W) image -> contiguous (1, H, W) float32, a non-float image
    cast first (the JAX package's ``_pad_tiles`` cast)."""
    return img.to(torch.float32).contiguous()[None]


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H, W) image -> (H, W) float32 FAST-9/16 corner score map, ONE
    launch."""
    return _fast.fast_score_map(_image_batch(img), float(threshold))[0]


def gaussian_blur7(img: torch.Tensor, quantized: bool = True) -> torch.Tensor:
    """(H, W) image -> (H, W) float32 7x7-Gaussian-smoothed image, ONE
    launch."""
    return _blur.gaussian_blur7(_image_batch(img), bool(quantized))[0]


def orient_describe_batched(raw: torch.Tensor, smoothed, xy: torch.Tensor):
    """Batched sparse stage for a (B, K) block of keypoints of B images
    of one shape, ONE launch: (B, H, W) raw and smoothed images (both
    float, or both integer: the uint8 datapath) and (B, K, 2) int
    keypoints (clamped into the image) -> (theta (B, K) float32, moments
    (B, K, 2) float32, desc (B, K, 8) int32), the per-level sparse FE.
    ``smoothed=None`` selects orientation only (``fast.detect``'s path)
    and gives no descriptor (None)."""
    xy = xy.to(torch.int32).contiguous()
    if smoothed is None:
        theta, mom = _describe.orient_fused(_slab(raw), xy)
        return theta, mom, None
    if raw.shape != smoothed.shape:
        raise ValueError(f"raw {tuple(raw.shape)} and smoothed "
                         f"{tuple(smoothed.shape)} must be one (B, H, W)")
    if _slab_dtype(raw) != _slab_dtype(smoothed):
        raise ValueError(f"raw ({raw.dtype}) and smoothed "
                         f"({smoothed.dtype}) must both be float or both "
                         "integer images")
    return _describe.describe_fused(_slab(raw), _slab(smoothed), xy)


@functools.lru_cache(maxsize=32)
def _col_levels(ks: tuple[int, ...], device: str) -> torch.Tensor:
    lv = [l for l, k in enumerate(ks) for _ in range(k)]
    return torch.tensor(lv, dtype=torch.int32, device=device)


def orient_describe_pyramid(raws, smootheds, xys):
    """Whole-frame sparse stage: per-level raw/smoothed (B, h_l, w_l)
    slab pairs plus per-level (B, K_l, 2) keypoint blocks -> per-level
    (theta, moments, desc) tuples, ALL cameras x ALL levels in ONE
    kernel launch."""
    ks = tuple(int(xy.shape[1]) for xy in xys)
    xy = torch.cat([x.to(torch.int32) for x in xys], dim=1).contiguous()
    theta, mom, desc = _describe.describe_fused_pyramid(
        flat_levels(raws), flat_levels(smootheds), _slabs_of(raws), xy,
        _col_levels(ks, str(xy.device)))
    outs, off = [], 0
    for k in ks:
        outs.append((theta[:, off:off + k], mom[:, off:off + k],
                     desc[:, off:off + k]))
        off += k
    return outs


def match_rectify_fused(desc_l, meta_l, desc_r, meta_r, img_l=None,
                        img_r=None, *, row_band: float, max_disparity: float,
                        max_hamming: int = 0, sad_window: int = 11,
                        sad_range: int = 5):
    """The ENTIRE FM stage of a frame in ONE kernel launch, batched over
    stereo pairs.  desc_*: (P, K, 8)/(P, M, 8) int32 bit-views; meta_*:
    (P, K, 4)/(P, M, 4) float32 rows of (x, y, level, valid); img_*:
    (P, H, W) level-0 images (float, or integer: the uint8 datapath).
    Returns (dist, idx, rxy, sad) as ``matcher_fused.match_rectify_fused``.

    MATCH-ONLY mode: with ``img_l``/``img_r`` omitted the SAD half is
    skipped and only (dist, idx) return, from the match-only kernel in
    one launch (``stereo_match``, ``temporal_match`` and the
    localization backend route here)."""
    if img_l is None:
        return _match_only.match_fused(
            desc_l.contiguous(), meta_l.contiguous(), desc_r.contiguous(),
            meta_r.contiguous(), row_band=float(row_band),
            max_disparity=float(max_disparity))
    return _matcher.match_rectify_fused(
        desc_l.contiguous(), meta_l.contiguous(), desc_r.contiguous(),
        meta_r.contiguous(), _slab(img_l), _slab(img_r),
        row_band=float(row_band),
        max_disparity=float(max_disparity), max_hamming=int(max_hamming),
        sad_window=int(sad_window), sad_range=int(sad_range))


def sad_patch_search(img_l, img_r, xy_l, xy_r, *, sad_window: int = 11,
                     sad_range: int = 5):
    """SAD sweep with in-kernel patch reads for caller-given match
    targets (``sad_rectify``'s path), ONE launch.  img_*: (P, H, W)
    level-0 images (float, or integer: the uint8 datapath); xy_*:
    (P, K, 2) float32 window centers.  Returns the (P, K, 2 * sad_range
    + 1) int32 SAD table; the caller takes the argmin."""
    return _sad_only.sad_fused(
        _slab(img_l), _slab(img_r),
        xy_l.float().contiguous(), xy_r.float().contiguous(),
        sad_window=int(sad_window), sad_range=int(sad_range))


def hamming_match(desc_l, meta_l, desc_r, meta_r, *, row_band: float,
                  max_disparity: float):
    """Fused search-region + Hamming argmin (paper's FM front half) for
    ONE pair, ONE launch.  desc_*: (K, 8)/(M, 8) int32 bit-views;
    meta_*: (K, 4)/(M, 4) float32 rows of (x, y, level, valid).  Returns
    (best_dist (K,) int32 [``BIG`` when no candidate], best_idx (K,)
    int32 [-1 when no candidate])."""
    return _hamming.hamming_match(
        desc_l.contiguous(), meta_l.contiguous(), desc_r.contiguous(),
        meta_r.contiguous(), row_band=float(row_band),
        max_disparity=float(max_disparity))


def sad_search(left_patches, right_strips):
    """(K, P, P) x (K, P, P + 2R) gathered windows -> (K, 2R + 1) int32
    SAD table, ONE launch; pixels truncate to int32 first."""
    return _sad_search.sad_search(left_patches.float().contiguous(),
                                  right_strips.float().contiguous())
