"""Image pyramid (port of ``repro.core.pyramid``; paper Sec. III-C,
"Image Resizing").

Two-layer pyramid; 1280x720 -> 1067x600 at the paper's 1.2 scale
factor.  The resize is jax's ``image.resize(method="bilinear")``, which
antialiases when it shrinks: a separable triangle filter whose (in,
out) weight matrices are built here in float32 with jax's own formula
(``jax/_src/image/scale.py::compute_weight_mat``).  Each output sums
only its band of nonzero weights (3 taps at the 1.2 factor), first tap
first, one elementwise multiply and add at a time, down the rows and
then along the columns.  XLA sums the full matrix products in another
order, so a resized value may differ in its last bits and, after the
quantizing round, a rare level-1 pixel by one grey level; level 0 is
the input itself and never differs.

Every output is computed alone, in one fixed order, so an image's
levels do not depend on the batch it comes in (a rig's frame and the
same rig inside a fleet give the same bits) nor on the device.

This resize is not one of the Pallas kernels: it stays plain PyTorch.
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


# A call uses 2 (n_levels - 1) entries; the pipelined schedule reads them
# on a side stream, so one call must never evict its own (pipeline.py).
@functools.lru_cache(maxsize=64)
def _band(in_size: int, out_size: int, device: str):
    """Each output's band of ``_weight_mat``: (out_size, taps) input
    indices (from the first nonzero weight up) and their weights, zero
    past the band's end, ``taps`` the widest band."""
    wm = _weight_mat(in_size, out_size, "cpu")        # (in, out)
    nz = wm != 0
    first = torch.where(nz.any(0), nz.int().argmax(0), 0)
    last = in_size - 1 - nz.flip(0).int().argmax(0)
    taps = max(int((last - first).max()) + 1, 1)
    rows = first[:, None] + torch.arange(taps)
    idx = rows.clamp(max=in_size - 1)
    w = torch.where((rows <= last[:, None]) & nz.any(0)[:, None],
                    wm.t().gather(1, idx), torch.zeros(()))
    return idx.to(device), w.to(device)


def _resample(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """Resize axis ``dim`` (-2 or -1) of (B, H, W) ``x`` to
    ``out_size``: gather each output's band, weight it, and add the
    taps one at a time in index order."""
    idx, w = _band(x.shape[dim], out_size, str(x.device))
    taps = idx.shape[1]
    g = x.index_select(dim, idx.reshape(-1))
    if dim == -2:
        p = g.view(x.shape[0], out_size, taps, x.shape[2]) * w[:, :, None]
        parts = [p[:, :, t] for t in range(taps)]
    else:
        p = g.view(x.shape[0], x.shape[1], out_size, taps) * w
        parts = [p[..., t] for t in range(taps)]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def bilinear_resize(images: torch.Tensor, out_hw: tuple[int, int]):
    """(B, H, W) float32 -> (B, h, w) antialiased bilinear resize, each
    image on its own: the same bits in any batch, on any device."""
    if torch.backends.cuda.matmul.allow_tf32:
        # The resize takes no matrix product, but every frame starts
        # here, and the rig points and the pose solve after it need
        # full float32 products.
        raise RuntimeError(
            "the pipeline needs full float32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    # Rows first, then columns: the order jax's einsum picks (the
    # cheaper one, since h < w).
    return _resample(_resample(images, -2, out_hw[0]), -1, out_hw[1])


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
