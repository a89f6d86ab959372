"""The whole Feature Matcher stage of a frame in one launch (port of
``repro.kernels.matcher_fused.match_rectify_fused_pallas``).

Per left feature of every stereo pair: the masked Hamming argmin over
all right features of its pair (``hamming_match.masked_hamming``; ties
go to the lowest right index), the acceptance gate with the fallback
to right feature 0 when it fails, then the SAD rectification: an 11x11
window around the rounded (half to even), clamped left center against
an 11x21 strip around the effective right feature, summed in int32
over the +-5 shifts, and the first-occurrence argmin.

Returns (dist (P, K) int32 [``BIG`` when no candidate], idx (P, K)
int32 [-1], rxy (P, K, 2) float32 — the effective right feature's
coords, sad (P, K) int32 — SAD argmin in [0, 2 * sad_range]).  The CUDA
kernel is ``csrc/matcher_fused.cu``; the plain version below is the
same function in PyTorch, and the wrapper picks it only for a CPU
tensor.

The level-0 images are float32 or uint8 (the paper's 8-bit datapath);
the SAD runs in int32 either way, so on an integer-valued frame the two
variants are bit-equal.  The uint8 variant is the kernel's template
instantiated for ``uint8_t`` (C entry point ``match_rectify_fused_u8``),
counted under the kernel's own counter.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.match_fused import match_fused_plain
from repro_torch.kernels.sad_fused import sad_fused_plain

KERNEL = _build.CudaKernel("matcher_fused", "match_rectify_fused",
                           "ppppppppppiiiiiffiii", variants=("f32", "u8"))


def match_rectify_fused_plain(desc_l, meta_l, desc_r, meta_r, img_l, img_r,
                              *, row_band: float, max_disparity: float,
                              max_hamming: int, sad_window: int = 11,
                              sad_range: int = 5):
    """Plain PyTorch version of the fused matcher kernel: the match-only
    and SAD-only plain versions, joined by the gate."""
    best, idx = match_fused_plain(desc_l, meta_l, desc_r, meta_r,
                                  row_band=row_band,
                                  max_disparity=max_disparity)
    ok = (idx >= 0) & (best <= max_hamming) & (meta_l[..., 3] > 0.5)
    eff = torch.where(ok, idx, torch.zeros_like(idx)).long()
    rxy = torch.gather(meta_r[..., :2], 1,
                       eff[..., None].expand(-1, -1, 2))
    table = sad_fused_plain(img_l, img_r, meta_l[..., :2], rxy,
                            sad_window=sad_window, sad_range=sad_range)
    return best, idx, rxy, table.argmin(dim=-1).to(torch.int32)


def match_rectify_fused_cuda(desc_l, meta_l, desc_r, meta_r, img_l, img_r,
                             *, row_band: float, max_disparity: float,
                             max_hamming: int, sad_window: int = 11,
                             sad_range: int = 5):
    """Launch ``csrc/matcher_fused.cu`` once over every pair."""
    dev = _build.require_cuda(desc_l, meta_l, desc_r, meta_r, img_l, img_r)
    if (desc_l.dtype != torch.int32 or desc_r.dtype != torch.int32
            or meta_l.dtype != torch.float32 or meta_r.dtype != torch.float32
            or img_l.dtype not in (torch.float32, torch.uint8)
            or img_r.dtype != img_l.dtype):
        raise ValueError("fused matcher takes int32 descriptors, float32 "
                         "meta rows and float32 or uint8 images of one "
                         "type")
    if img_l.shape != img_r.shape:
        raise ValueError("left and right images must share one shape")
    if sad_window > 15 or sad_range > 15:
        raise ValueError("the fused matcher kernel holds windows up to "
                         "15 px and sweeps up to +-15 px")
    n_pairs, k = desc_l.shape[0], desc_l.shape[1]
    m = desc_r.shape[1]
    if m == 0:
        raise ValueError("the fused matcher needs a right feature: the "
                         "gate's fallback reads right feature 0")
    _, h, w = img_l.shape
    dist = torch.empty((n_pairs, k), dtype=torch.int32, device=dev)
    idx = torch.empty((n_pairs, k), dtype=torch.int32, device=dev)
    rxy = torch.empty((n_pairs, k, 2), dtype=torch.float32, device=dev)
    sad = torch.empty((n_pairs, k), dtype=torch.int32, device=dev)
    if n_pairs * k:
        KERNEL(dev, desc_l.data_ptr(), meta_l.data_ptr(), desc_r.data_ptr(),
               meta_r.data_ptr(), img_l.data_ptr(), img_r.data_ptr(),
               dist.data_ptr(), idx.data_ptr(), rxy.data_ptr(),
               sad.data_ptr(), n_pairs, k, m, h, w, float(row_band),
               float(max_disparity), int(max_hamming), int(sad_window),
               int(sad_range), variant=_build.variant_of(img_l))
    return dist, idx, rxy, sad


def match_rectify_fused(desc_l, meta_l, desc_r, meta_r, img_l, img_r, *,
                        row_band: float, max_disparity: float,
                        max_hamming: int, sad_window: int = 11,
                        sad_range: int = 5):
    """desc_*: (P, K, 8)/(P, M, 8) int32 bit-views; meta_*: (P, K, 4)/
    (P, M, 4) float32 rows of (x, y, level, valid); img_*: (P, H, W)
    float32 or uint8 level-0 images.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel."""
    fn = (match_rectify_fused_plain if desc_l.device.type == "cpu"
          else match_rectify_fused_cuda)
    return fn(desc_l, meta_l, desc_r, meta_r, img_l, img_r,
              row_band=row_band, max_disparity=max_disparity,
              max_hamming=max_hamming, sad_window=sad_window,
              sad_range=sad_range)
