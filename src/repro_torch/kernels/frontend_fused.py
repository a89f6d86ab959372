"""Dense FE over every camera x pyramid level in one launch (port of
``repro.kernels.frontend_fused.frontend_fused_pyramid_pallas``).

For every pixel of every slab it emits the two per-pixel products the
ORB frontend needs: the 7x7 binomial blur (input to rBRIEF; quantized
with round-half-up) and the 3x3-NMS'd FAST-9/16 corner score (input to
top-K).  Pixels outside a slab's true (h, w) are -1 to NMS, and image
taps past the border replicate the edge pixel.

Slab layout: all slabs (level-major, then camera) lie back to back in
one flat float32 or uint8 buffer; ``SlabTable`` gives each slab's
(offset, h, w).
The CUDA kernel (``csrc/frontend_fused.cu``) indexes each slab in place
and clamps its reads, so there is no padded common canvas.  The plain
version below is the same function in PyTorch; the wrapper picks it
only for a CPU tensor.

``frontend_fused`` is the per-level kernel (port of
``frontend_fused_pallas``, K6; ``csrc/frontend_level.cu``): the same
blur and NMS'd score for a (B, H, W) batch of ONE level, one launch a
level, for the per-level FE schedule.  K1 and K6 run one tile body
(``frontend_common.cuh``'s ``dense_tile``), and the plain version of
K1 is K6's on each run of equal-shape slabs.

Both kernels take float32 or uint8 pixels.  uint8 is the paper's 8-bit
datapath (the JAX package's integer ``_tile_outputs``): int32
accumulators, the blur ``(v + 648) // 1296`` stored as uint8 and the
FAST score, compared against ``floor(threshold)``, as int16.  It needs
the quantized blur.  Each kernel's uint8 variant is the same template
body instantiated for ``uint8_t`` (C entry point ``<symbol>_u8``),
counted under the kernel's own counter.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ARC_LEN, CIRCLE16, GAUSS7_NORM,
                                     GAUSS7_WEIGHTS_INT, fast_blur_nms_int,
                                     nms3, true_div)

KERNEL = _build.CudaKernel("frontend_fused", "frontend_fused_pyramid",
                           "ppppiiifii", variants=("f32", "u8"))
LEVEL_KERNEL = _build.CudaKernel("frontend_level", "frontend_fused",
                                 "pppiiifii", variants=("f32", "u8"))


class SlabTable(NamedTuple):
    """Where each (h, w) slab lies in a flat buffer.  ``slabs`` is the
    host copy of ``table`` ((N, 3) int64 rows of offset, h, w on the
    slabs' device)."""

    slabs: tuple[tuple[int, int, int], ...]
    table: torch.Tensor
    total: int


@functools.lru_cache(maxsize=64)
def _slab_table(level_shapes: tuple[tuple[int, int], ...], batch: int,
                device: str) -> SlabTable:
    slabs, off = [], 0
    for h, w in level_shapes:
        for _ in range(batch):
            slabs.append((off, h, w))
            off += h * w
    table = torch.tensor(slabs, dtype=torch.int64, device=device)
    return SlabTable(tuple(slabs), table, off)


def slab_table(level_shapes, batch: int, device) -> SlabTable:
    """Level-major slab table for ``batch`` cameras per level."""
    return _slab_table(tuple((int(h), int(w)) for h, w in level_shapes),
                       int(batch), str(torch.device(device)))


def blur_plain(x: torch.Tensor, quantized: bool) -> torch.Tensor:
    """(B, H, W) float32 -> 7x7 binomial blur, horizontal then vertical
    pass, each summed tap by tap in order (the JAX package's order)."""
    _, h, w = x.shape
    pad = F.pad(x[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    wts = [float(v) for v in GAUSS7_WEIGHTS_INT]
    horiz = wts[0] * pad[:, :, 0:w]
    for k in range(1, 7):
        horiz = horiz + wts[k] * pad[:, :, k:k + w]
    vert = wts[0] * horiz[:, 0:h, :]
    for k in range(1, 7):
        vert = vert + wts[k] * horiz[:, k:k + h, :]
    norm2 = float(GAUSS7_NORM * GAUSS7_NORM)
    if quantized:
        return torch.floor(true_div(vert + norm2 / 2.0, norm2))
    return true_div(vert, norm2)


def fast_score_plain(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """(B, H, W) float32 -> thresholded FAST-9/16 score: max over arc
    starts of (min over a bright arc, -max over a dark arc)."""
    _, h, w = x.shape
    pad = F.pad(x[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    taps = [pad[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - x
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
    return torch.where(score > threshold, score, torch.zeros_like(score))


def out_dtypes(x: torch.Tensor, quantized: bool):
    """(blur, score) dtypes of the dense FE on ``x``'s pixels: float32
    and float32, or uint8 and int16 for uint8 pixels, which need the
    quantized blur (the JAX package's ``_slab_dtypes``)."""
    if x.dtype == torch.uint8:
        if not quantized:
            raise ValueError(
                "the uint8 datapath requires quantized=True (the float "
                "Gaussian is not representable in a uint8 slab)")
        return torch.uint8, torch.int16
    if x.dtype == torch.float32:
        return torch.float32, torch.float32
    raise ValueError(f"dense FE takes float32 or uint8 pixels, got {x.dtype}")


def frontend_fused_plain(x: torch.Tensor, *, threshold: float,
                         nms: bool = True, quantized: bool = True):
    """Plain PyTorch version of the per-level dense FE kernel: (B, H, W)
    float32 -> (blur, score), each (B, H, W) float32; uint8 -> (uint8
    blur, int16 score) through the integer oracles.  Without NMS the
    thresholded score is already max(score, 0)."""
    if x.dtype == torch.uint8:
        out_dtypes(x, quantized)
        return fast_blur_nms_int(x, float(threshold), nms=nms)
    sc = fast_score_plain(x, float(threshold))
    return blur_plain(x, quantized), nms3(sc) if nms else sc


def frontend_fused_pyramid_plain(flat: torch.Tensor, slabs: SlabTable, *,
                                 threshold: float, nms: bool = True,
                                 quantized: bool = True):
    """Plain PyTorch version of the dense FE kernel: same inputs, same
    outputs.  Slabs of one shape that lie back to back run as a batch,
    through the per-level plain version."""
    blur_dtype, score_dtype = out_dtypes(flat, quantized)
    blur = torch.empty_like(flat, dtype=blur_dtype)
    score = torch.empty_like(flat, dtype=score_dtype)
    i = 0
    while i < len(slabs.slabs):
        off, h, w = slabs.slabs[i]
        j = i + 1
        while j < len(slabs.slabs) and slabs.slabs[j][1:] == (h, w):
            j += 1
        n = (j - i) * h * w
        b, sc = frontend_fused_plain(flat[off:off + n].view(j - i, h, w),
                                     threshold=threshold, nms=nms,
                                     quantized=quantized)
        blur[off:off + n] = b.reshape(-1)
        score[off:off + n] = sc.reshape(-1)
        i = j
    return blur, score


def frontend_fused_pyramid_cuda(flat: torch.Tensor, slabs: SlabTable, *,
                                threshold: float, nms: bool = True,
                                quantized: bool = True):
    """Launch ``csrc/frontend_fused.cu`` once over every slab."""
    dev = _build.require_cuda(flat, slabs.table)
    blur_dtype, score_dtype = out_dtypes(flat, quantized)
    if flat.numel() != slabs.total:
        raise ValueError("dense FE takes the flat slab buffer its "
                         "SlabTable describes")
    blur = torch.empty_like(flat, dtype=blur_dtype)
    score = torch.empty_like(flat, dtype=score_dtype)
    max_h = max(h for _, h, _ in slabs.slabs)
    max_w = max(w for _, _, w in slabs.slabs)
    KERNEL(dev, flat.data_ptr(), blur.data_ptr(), score.data_ptr(),
           slabs.table.data_ptr(), len(slabs.slabs), max_h, max_w,
           float(threshold), int(bool(nms)), int(bool(quantized)),
           variant=_build.variant_of(flat))
    return blur, score


def frontend_fused_pyramid(flat: torch.Tensor, slabs: SlabTable, *,
                           threshold: float, nms: bool = True,
                           quantized: bool = True):
    """flat: every slab's pixels, float32 or uint8, laid out as
    ``slabs`` says.  Returns (blur, score) in the same layout (float32
    and float32, or uint8 and int16).  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel."""
    fn = (frontend_fused_pyramid_plain if flat.device.type == "cpu"
          else frontend_fused_pyramid_cuda)
    return fn(flat, slabs, threshold=threshold, nms=nms,
              quantized=quantized)


def frontend_fused_cuda(x: torch.Tensor, *, threshold: float,
                        nms: bool = True, quantized: bool = True):
    """Launch ``csrc/frontend_level.cu`` once over a (B, H, W) level."""
    dev = _build.require_cuda(x)
    if x.dim() != 3:
        raise ValueError("per-level dense FE takes a (B, H, W) batch, got "
                         f"{tuple(x.shape)}")
    blur_dtype, score_dtype = out_dtypes(x, quantized)
    blur = torch.empty_like(x, dtype=blur_dtype)
    score = torch.empty_like(x, dtype=score_dtype)
    b, h, w = x.shape
    if x.numel():
        LEVEL_KERNEL(dev, x.data_ptr(), blur.data_ptr(), score.data_ptr(),
                     b, h, w, float(threshold), int(bool(nms)),
                     int(bool(quantized)), variant=_build.variant_of(x))
    return blur, score


def frontend_fused(x: torch.Tensor, *, threshold: float, nms: bool = True,
                   quantized: bool = True):
    """x: (B, H, W) float32 or uint8, B images of one level.  Returns
    (blur, score), each (B, H, W): float32, or uint8 and int16.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    fn = frontend_fused_plain if x.device.type == "cpu" else frontend_fused_cuda
    return fn(x, threshold=threshold, nms=nms, quantized=quantized)
