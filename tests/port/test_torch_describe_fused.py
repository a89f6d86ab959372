"""Sparse FE (K2): the plain version behind ``repro_torch.kernels.ops.
orient_describe_pyramid`` against the JAX package's
``ops.orient_describe_pyramid(impl="ref")`` on identical levels, blurs
and keypoints (top-K picks and out-of-image coordinates, which both
clamp).  Tolerances are the sparse-FE rule of ``parity.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.ref import extract_patches, moment_grids

from parity import assert_sparse_parity, textured_levels

SHAPES = [(96, 128), (80, 107)]


def _keypoints(rng, shapes, b, k):
    out = []
    for h, w in shapes:
        xy = np.stack([rng.randint(-8, w + 8, (b, k)),
                       rng.randint(-8, h + 8, (b, k))], -1)
        out.append(xy.astype(np.int32))
    return out


def _abs_moment_sums(levels, xys):
    xg, yg = moment_grids()
    sums = []
    for lv, xy in zip(levels, xys):
        per_cam = []
        for cam in range(lv.shape[0]):
            p = extract_patches(torch.from_numpy(lv[cam]),
                                torch.from_numpy(xy[cam]))
            per_cam.append(torch.stack([(p * xg).abs().sum((-2, -1)),
                                        (p * yg).abs().sum((-2, -1))], -1))
        sums.append(torch.stack(per_cam).numpy())
    return sums


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "float"])
def test_sparse_fe_matches_jax(integer):
    rng = np.random.RandomState(11)
    levels = textured_levels(3, SHAPES, integer=integer)
    jlv = [jnp.asarray(l) for l in levels]
    dense = jops.fast_blur_nms_pyramid(jlv, 20.0, impl="ref")
    blurs = [np.asarray(b) for b, _ in dense]
    xys = _keypoints(rng, SHAPES, 4, 24)
    want = jops.orient_describe_pyramid(jlv, [jnp.asarray(b) for b in blurs],
                                        [jnp.asarray(x) for x in xys],
                                        impl="ref")
    got = ops.orient_describe_pyramid(
        [torch.from_numpy(l.copy()) for l in levels],
        [torch.from_numpy(b.copy()) for b in blurs],
        [torch.from_numpy(x) for x in xys])
    near = 0
    for (jt, jm, jd), (tt, tm, td), s in zip(want, got,
                                             _abs_moment_sums(levels, xys)):
        assert tt.dtype == torch.float32 and td.dtype == torch.int32
        assert tuple(td.shape) == tuple(jd.shape)
        near += assert_sparse_parity(np.asarray(jt), np.asarray(jm), jd,
                                     tt, tm, td, s, integer)
    print(f"keypoints near a bin edge: {near}")
