"""The per-level FE schedule — ``core.orb.extract_features_per_level``
and its two kernels' dispatch, ``kernels.ops.fast_blur_nms_batched``
(K6) and ``ops.orient_describe_batched`` with a smoothed image (K7) —
against the JAX package's (``impl="ref"``) on identical inputs made
with numpy from a seed, on the JAX tests' shapes (a level smaller than
one 32-pixel tile among them), and against the port's own whole-frame
schedule (``extract_features_batched``, K1 + K2), which the JAX package
pins to the per-level one bit for bit.  Against the JAX package the
port's schedule runs on the JAX pyramid's levels, so every level is
compared; the two pyramids are held together by ``test_torch_pyramid``.

Tolerances are ``parity.py``'s: blur, score, keypoints, levels, scores
and valid flags bit-equal; on integer-valued images theta within 1 ulp
(the moments are exact integers, only atan2 differs between XLA and
torch) and descriptors equal; on float images theta and moments under
the sparse-FE rule, descriptors equal wherever the steering bins agree.
The port's two schedules run the same plain arithmetic, so they are
bit-equal in every field."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import orb as jorb
from repro.core.types import ORBConfig as JORBConfig
from repro.kernels import ops as jops
from repro_torch.core import (ORBConfig, extract_features_batched,
                              extract_features_per_level)
from repro_torch.kernels import ops
from repro_torch.kernels.describe_fused import level_patches
from repro_torch.kernels.ref import moment_grids

from parity import (assert_sparse_parity, bins, desc_u32,
                    feed_jax_pyramid, np_of, textured_levels, ulp_diff)

# (B, (H, W), levels) of the JAX package's whole-frame-vs-per-level test
CASES = [(1, (64, 96), 1), (2, (70, 111), 3), (4, (96, 128), 2),
         (3, (37, 53), 5)]
IDS = ["1x64x96-L1", "2x70x111-L3", "4x96x128-L2", "3x37x53-L5"]
EXACT = ("xy", "level", "score", "valid")


def _imgs(seed, b, shape, integer=True):
    """The JAX test's images (uniform integers in [0, 255]), or float
    images of the same texture with a uniform fraction added."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (b, *shape)).astype(np.float32)
    if not integer:
        imgs = np.clip(imgs + rng.uniform(-0.5, 0.5, imgs.shape),
                       0.0, 255.0).astype(np.float32)
    return imgs


def _cfgs(shape, n_levels):
    kw = dict(height=shape[0], width=shape[1], max_features=48,
              n_levels=n_levels)
    return JORBConfig(**kw), ORBConfig(**kw)


def _jax_per_level(imgs, jcfg):
    fn = jax.jit(functools.partial(jorb.extract_features_per_level,
                                   cfg=jcfg, impl="ref"))
    return fn(jnp.asarray(imgs))


def _abs_sums(raw, xy):
    """(B, K, 2) sum|x * p| and sum|y * p| of each keypoint's patch."""
    p = level_patches(raw, xy)
    xg, yg = moment_grids()
    return torch.stack([(p * xg).abs().sum((-2, -1)),
                        (p * yg).abs().sum((-2, -1))], -1).numpy()


def _rows(ks, lvl):
    return slice(sum(ks[:lvl]), sum(ks[:lvl + 1]))


@pytest.mark.parametrize("b,shape,n_levels", CASES, ids=IDS)
def test_per_level_matches_jax_on_integer_images(b, shape, n_levels,
                                                  monkeypatch):
    """Every row of every level, on the JAX package's pyramid levels;
    then level 0 (the input itself) through the port's own pyramid."""
    imgs = _imgs(7, b, shape)
    jcfg, cfg = _cfgs(shape, n_levels)
    want = _jax_per_level(imgs, jcfg)
    own = extract_features_per_level(torch.from_numpy(imgs), cfg)
    fed = feed_jax_pyramid(monkeypatch, jcfg)
    with ops.launch_audit() as audit:
        got = extract_features_per_level(torch.from_numpy(imgs), cfg)
    assert audit.count == 0               # the CPU runs the plain versions
    assert len(fed) == 1
    assert tuple(got.desc.shape) == (b, 48, 8)
    for name in EXACT:
        np.testing.assert_array_equal(np_of(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert ulp_diff(np.asarray(want.theta), np_of(got.theta)).max() <= 1
    np.testing.assert_array_equal(desc_u32(got.desc), np.asarray(want.desc))
    rows = _rows(cfg.features_per_level(), 0)
    for name in own._fields:
        assert torch.equal(getattr(own, name)[:, rows],
                           getattr(got, name)[:, rows]), name
    assert int(got.valid.sum()) > 0


def test_per_level_matches_jax_on_float_images(monkeypatch):
    """Keypoints, scores and flags bit-equal; theta and moments under
    the sparse-FE rule, against the moments of the same patches from
    the JAX package's sparse stage (jitted, as its schedule runs)."""
    b, shape, n_levels = CASES[2]
    imgs = _imgs(12, b, shape, integer=False)
    jcfg, cfg = _cfgs(shape, n_levels)
    want = _jax_per_level(imgs, jcfg)
    calls = []
    dispatch = ops.orient_describe_batched

    def record(raw, smoothed, xy):
        out = dispatch(raw, smoothed, xy)
        calls.append(((raw, smoothed, xy), out))
        return out

    fed = feed_jax_pyramid(monkeypatch, jcfg)
    monkeypatch.setattr(ops, "orient_describe_batched", record)
    got = extract_features_per_level(torch.from_numpy(imgs), cfg)
    assert len(fed) == 1 and len(calls) == n_levels
    jsparse = jax.jit(functools.partial(jops.orient_describe_batched,
                                        impl="ref"))
    ks = cfg.features_per_level()
    for lvl, ((raw, sm, xy), (theta, mom, desc)) in enumerate(calls):
        rows = _rows(ks, lvl)
        assert torch.equal(theta, got.theta[:, rows])
        assert torch.equal(desc, got.desc[:, rows])
        for name in EXACT:
            np.testing.assert_array_equal(
                np_of(getattr(got, name))[:, rows],
                np.asarray(getattr(want, name))[:, rows],
                err_msg=f"{name} level {lvl}")
        _, jmom, _ = jsparse(*(jnp.asarray(t.numpy()) for t in (raw, sm, xy)))
        assert_sparse_parity(
            np.asarray(want.theta)[:, rows], np.asarray(jmom),
            np.asarray(want.desc)[:, rows], theta, mom, desc,
            _abs_sums(raw, xy), integer=False)


@pytest.mark.parametrize("b,shape,n_levels", CASES + [(2, (64, 96), 3)],
                         ids=IDS + ["blank-2x64x96-L3"])
def test_per_level_equals_whole_frame(b, shape, n_levels):
    """The JAX package's pin (``tests/test_whole_frame_fused.py``), on
    the port: every field bit-equal.  Blank images have no corner: no
    valid feature, and a finite theta on the top-K padding rows."""
    blank = n_levels == 3 and shape == (64, 96)
    imgs = (np.zeros((b, *shape), np.float32) if blank
            else _imgs(7, b, shape))
    _, cfg = _cfgs(shape, n_levels)
    per = extract_features_per_level(torch.from_numpy(imgs), cfg)
    whole = extract_features_batched(torch.from_numpy(imgs), cfg)
    for name in per._fields:
        assert torch.equal(getattr(per, name), getattr(whole, name)), name
    assert torch.isfinite(per.theta).all()
    assert (int(per.valid.sum()) == 0) == blank


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("nms", [True, False])
def test_fast_blur_nms_batched_matches_jax(nms, quantized):
    """Float images (so the unquantized blur is no integer) of (37, 53),
    one 32-pixel tile and a partial one along each axis.
    The JAX side runs eagerly: under ``jax.jit`` XLA on the CPU may
    contract the blur's multiply-adds into FMAs, which the reference
    (and the kernels, by ``__fmul_rn``/``__fadd_rn``) round apart."""
    imgs = textured_levels(13, [(37, 53)], b=3)[0]
    jb, js = jops.fast_blur_nms_batched(jnp.asarray(imgs), 20.0, nms=nms,
                                        quantized=quantized, impl="ref")
    with ops.launch_audit() as audit:
        tb, ts = ops.fast_blur_nms_batched(torch.from_numpy(imgs), 20.0,
                                           nms=nms, quantized=quantized)
    assert audit.count == 0
    assert tb.dtype == ts.dtype == torch.float32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int((ts > 0).sum()) > 10


@pytest.mark.parametrize("k", [37, 0])
@pytest.mark.parametrize("kind", ["integer", "float"])
def test_orient_describe_with_smoothed_matches_jax(kind, k):
    """K = 37 (no multiple of any block) on 3 images of (70, 100), the
    keypoints up to 8 px past every edge (clamped into the image); and
    K = 0."""
    h, w = 70, 100
    raw = textured_levels(14, [(h, w)], b=3, integer=kind == "integer")[0]
    sm = np.array(jax.jit(functools.partial(
        jops.fast_blur_nms_batched, threshold=20.0, impl="ref"))(
            jnp.asarray(raw))[0])
    rng = np.random.RandomState(15)
    xy = np.stack([rng.randint(-8, w + 8, (3, k)),
                   rng.randint(-8, h + 8, (3, k))], -1).astype(np.int32)
    jt, jm, jd = jax.jit(functools.partial(
        jops.orient_describe_batched, impl="ref"))(
            jnp.asarray(raw), jnp.asarray(sm), jnp.asarray(xy))
    traw, txy = torch.from_numpy(raw), torch.from_numpy(xy)
    with ops.launch_audit() as audit:
        tt, tm, td = ops.orient_describe_batched(traw, torch.from_numpy(sm),
                                                 txy)
    assert audit.count == 0
    assert tuple(tt.shape) == (3, k) and tuple(tm.shape) == (3, k, 2)
    assert tuple(td.shape) == (3, k, 8) and td.dtype == torch.int32
    assert_sparse_parity(np.asarray(jt), np.asarray(jm), np.asarray(jd), tt,
                         tm, td, _abs_sums(traw, txy), kind == "integer")
    if k:
        assert len(np.unique(bins(np.asarray(jt)))) > 3


def test_orient_describe_shape_mismatch_is_an_error():
    raw = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="smoothed"):
        ops.orient_describe_batched(raw, torch.zeros(2, 16, 15),
                                    torch.zeros(2, 4, 2, dtype=torch.int32))
