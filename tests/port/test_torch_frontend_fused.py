"""Dense FE (K1): the plain version behind ``repro_torch.kernels.ops.
fast_blur_nms_pyramid`` against the JAX package's
``ops.fast_blur_nms_pyramid(impl="ref")`` (pinned bit-exact to its
Pallas kernel by the JAX tests) on identical inputs.  Blur and score
are bit-equal: the blur keeps the reference's tap order and divides
tensor by tensor; FAST and NMS are min/max and compares."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pyramid as jpyramid
from repro.core.types import ORBConfig as JORBConfig
from repro.kernels import ops as jops
from repro_torch.kernels import _build, frontend_fused, ops

from parity import scene_frames, textured_levels

SHAPES = [(96, 128), (80, 107)]


def _compare(levels_np, threshold=20.0, nms=True, quantized=True):
    want = jops.fast_blur_nms_pyramid([jnp.asarray(l) for l in levels_np],
                                      threshold, nms=nms, quantized=quantized,
                                      impl="ref")
    with ops.launch_audit() as audit:
        got = ops.fast_blur_nms_pyramid(
            [torch.from_numpy(l.copy()) for l in levels_np], threshold,
            nms=nms, quantized=quantized)
    assert audit.count == 0            # the CPU runs the plain version
    for (jb, js), (tb, ts) in zip(want, got):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    return got


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
@pytest.mark.parametrize("nms,quantized", [(True, True), (False, True),
                                           (True, False)])
def test_dense_fe_matches_jax_on_textured_levels(integer, nms, quantized):
    got = _compare(textured_levels(7, SHAPES, integer=integer), nms=nms,
                   quantized=quantized)
    assert any(int((s > 0).sum()) > 50 for _, s in got)


def test_dense_fe_matches_jax_on_scene_pyramid():
    frame, _ = scene_frames()
    levels = jpyramid.build_pyramid_batched(
        jnp.asarray(frame), JORBConfig(height=96, width=128))
    _compare([np.asarray(l) for l in levels])


def test_slab_layout_and_views():
    levels = [torch.zeros(4, h, w) for h, w in SHAPES]
    slabs = ops._slabs_of(levels)
    assert slabs.slabs[:2] == ((0, 96, 128), (96 * 128, 96, 128))
    assert slabs.slabs[4] == (4 * 96 * 128, 80, 107)
    assert slabs.total == 4 * (96 * 128 + 80 * 107)
    flat = torch.arange(slabs.total, dtype=torch.float32)
    views = [flat[:4 * 96 * 128].view(4, 96, 128),
             flat[4 * 96 * 128:].view(4, 80, 107)]
    assert ops.flat_levels(views).data_ptr() == flat.data_ptr()
    copy = ops.flat_levels([v.clone() for v in views])
    assert torch.equal(copy, flat) and copy.data_ptr() != flat.data_ptr()


def test_non_cpu_tensor_launches_the_kernel_or_raises():
    flat = torch.zeros(16, device="meta")
    slabs = frontend_fused.slab_table([(4, 4)], 1, "meta")
    before = frontend_fused.KERNEL.launches
    with pytest.raises((ValueError, RuntimeError)):
        frontend_fused.frontend_fused_pyramid(flat, slabs, threshold=20.0)
    assert frontend_fused.KERNEL.launches == before
    assert _build.CSRC.joinpath("frontend_fused.cu").is_file()
