"""Pyramid (``repro_torch.core.pyramid``) against the JAX package's
``build_pyramid_batched``.  Level 0 is the input and is identical.  The
level-1 resize sums its matrix products in another order than XLA's, so
a resized value can differ in its last bits and, after the quantizing
round, a pixel by one grey level: level 1 is held to 1 grey level, and
to at most 1 differing pixel in 10,000 (measured on CPU: at most 1 of
34,240 on these float scene frames at 96x128; rounding the frames to
integers raises that to 13, which the whole-slice test covers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pyramid as jpyramid
from repro.core.types import ORBConfig as JORBConfig
from repro_torch.core import pyramid
from repro_torch.core.types import ORBConfig

from parity import scene_frames


@pytest.mark.parametrize("hw", [(96, 128), (120, 160)])
def test_pyramid_matches_jax(hw):
    frame, _ = scene_frames(*hw)
    cfg = dict(height=hw[0], width=hw[1], n_levels=2)
    want = jpyramid.build_pyramid_batched(jnp.asarray(frame),
                                          JORBConfig(**cfg))
    got = pyramid.build_pyramid_batched(torch.from_numpy(frame.copy()),
                                        ORBConfig(**cfg))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    a, b = got[1].numpy(), np.asarray(want[1])
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1.0
    n_diff = int((a != b).sum())
    print(f"level-1 pixels that differ: {n_diff} of {a.size}")
    assert n_diff * 10_000 <= a.size


def test_levels_share_one_flat_buffer():
    frame, _ = scene_frames()
    levels = pyramid.build_pyramid_batched(torch.from_numpy(frame.copy()),
                                           ORBConfig(height=96, width=128))
    assert levels[1].untyped_storage().data_ptr() == \
        levels[0].untyped_storage().data_ptr()
    assert levels[1].storage_offset() == levels[0].numel()


@pytest.mark.parametrize("hw", [(96, 128), (720, 1280), (59, 85)])
def test_resize_is_the_weight_matrix_product(hw):
    """The banded sum is jax's filter: the products with the same
    (float32) weight matrices, taken in float64, within the rounding of
    two passes of 3 products and 2 adds of values in [0, 255] whose
    nonnegative weights sum to 1 (2.5 float32 ulp of 255 a pass)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.random((2, *hw)) * 255).astype(np.float32))
    out_hw = ORBConfig(height=hw[0], width=hw[1]).level_shape(1)
    got = pyramid.bilinear_resize(x, out_hw).double()
    wy = pyramid._weight_mat(hw[0], out_hw[0], "cpu").double()
    wx = pyramid._weight_mat(hw[1], out_hw[1], "cpu").double()
    want = wy.t() @ x.double() @ wx
    ulp = float(np.spacing(np.float32(255.0)))
    assert float((got - want).abs().max()) <= 5 * ulp


def test_resize_refuses_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="tf32"):
            pyramid.bilinear_resize(torch.zeros(1, 12, 12), (10, 10))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
