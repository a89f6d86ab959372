"""Image pyramid (port of ``repro.core.pyramid``; paper Sec. III-C,
"Image Resizing").

Two-layer pyramid; 1280x720 -> 1067x600 at the paper's 1.2 scale
factor.  The resize is jax's ``image.resize(method="bilinear")``, which
antialiases when it shrinks: a separable triangle filter whose (in,
out) weight matrices are built here in float32 with jax's own formula
(``jax/_src/image/scale.py::compute_weight_mat``) and contracted with
two matrix products.  The products sum in another order than XLA's, so
a resized value may differ in its last bits and, after the quantizing
round, a rare level-1 pixel by one grey level; level 0 is the input
itself and never differs.

This resize is not one of the Pallas kernels: it stays two
``torch.matmul`` calls, in full float32 (TF32 must be off).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.types import ORBConfig


@functools.lru_cache(maxsize=16)
def _weight_mat(in_size: int, out_size: int, device: str) -> torch.Tensor:
    """(in_size, out_size) float32 antialiased triangle weights, built
    step by step as jax builds them (all float32)."""
    f32 = torch.float32
    scale = torch.tensor(out_size / in_size, dtype=f32)
    one = torch.tensor(1.0, dtype=f32)
    inv_scale = one / scale
    kernel_scale = torch.maximum(inv_scale, one)
    sample_f = ((torch.arange(out_size, dtype=f32) + 0.5) * inv_scale
                - torch.tensor(0.0, dtype=f32) * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs()
    x = x / kernel_scale
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    # Column sums row by row, in order: XLA's order for these shapes
    # (torch's own reduction differs in the last bit of a few columns).
    total = torch.zeros((1, out_size), dtype=f32)
    for row in weights:
        total = total + row
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, one),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(inside[None, :], weights, torch.zeros_like(weights))
    return weights.to(device)


def bilinear_resize(images: torch.Tensor, out_hw: tuple[int, int]):
    """(B, H, W) float32 -> (B, h, w) antialiased bilinear resize."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the pyramid resize needs full float32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    _, h, w = images.shape
    dev = str(images.device)
    wy = _weight_mat(h, out_hw[0], dev)           # (H, h)
    wx = _weight_mat(w, out_hw[1], dev)           # (W, w)
    # Contract H first, then W: the order jax's einsum picks (the
    # cheaper one, since h < w).
    return torch.matmul(torch.matmul(wy.t(), images), wx)


def build_pyramid(image: torch.Tensor, cfg: ORBConfig, *,
                  precision: str = "f32") -> list[torch.Tensor]:
    """(H, W) image -> ``cfg.n_levels`` (h_l, w_l) level images (float32,
    or uint8 under ``precision="uint8"``), level 0 the input: the
    batch-of-one view of ``build_pyramid_batched``."""
    return [lv[0] for lv in build_pyramid_batched(image[None], cfg,
                                                  precision=precision)]


def check_precision(precision: str) -> None:
    """Accept ``"f32"`` and ``"uint8"`` (the paper's 8-bit datapath);
    any other string is an error."""
    if precision not in ("f32", "uint8"):
        raise ValueError(
            f"precision must be 'f32' or 'uint8', got {precision!r}")


def level_shapes(cfg: ORBConfig) -> list[tuple[int, int]]:
    """Static (h, w) of every pyramid level."""
    return [cfg.level_shape(lvl) for lvl in range(cfg.n_levels)]


def build_pyramid_batched(images: torch.Tensor, cfg: ORBConfig, *,
                          precision: str = "f32"):
    """(B, H, W) -> list of (B, h_l, w_l) level batches; level 0 is the
    input.  ``precision="f32"`` gives float32 levels, every resized level
    rounded and clipped to integer values in [0, 255] with
    ``cfg.quantized``; ``precision="uint8"`` gives uint8 levels (the
    paper's 8-bit datapath): level 0 is the input as uint8, and each
    further level the float32 resize of the level above, rounded and
    clipped back to uint8.  On an integer-valued frame the two give the
    same values.

    The levels are views into ONE flat buffer, level after level, which
    is the slab layout the dense and sparse FE kernels read in place
    (``kernels.ops.flat_levels``)."""
    check_precision(precision)
    integer = precision == "uint8"
    b = images.shape[0]
    shapes = level_shapes(cfg)
    sizes = [b * h * w for h, w in shapes]
    flat = torch.empty(sum(sizes),
                       dtype=torch.uint8 if integer else torch.float32,
                       device=images.device)
    levels, off = [], 0
    for lvl, ((h, w), n) in enumerate(zip(shapes, sizes)):
        view = flat[off:off + n].view(b, h, w)
        if lvl == 0:
            view.copy_(images)
        else:
            out = bilinear_resize(levels[-1].float(), (h, w))
            if cfg.quantized or integer:
                out = torch.round(torch.clamp(out, 0.0, 255.0))
            view.copy_(out)
        levels.append(view)
        off += n
    return levels
