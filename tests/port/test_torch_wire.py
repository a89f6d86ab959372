"""The feature wire format (``repro_torch.distributed.compression``) and
the service's ``wire_encode``/``wire_decode`` against the JAX package's,
on the CPU.

Seeded numpy fields go through each JAX encoder and its port
counterpart.  Every payload array must match in dtype, shape and bytes,
every scale bit for bit, and every decoded field must be bit-equal
(descriptors compared as uint32 words: the port keeps int32 bit-views).
The quantizer divides tensor / tensor, as ``jnp`` does, so its codes
are the same bytes; ``torch.round`` and ``jnp.round`` both round half
to even, which the .5-tie cases pin.  Then a port ``process_frame``
output at 96 x 128, plain and localized, goes through the port's
``wire_encode`` and, converted to jnp, through the JAX one."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.distributed import compression as jcomp
from repro.kernels import ops as jops
from repro.serving import wire_decode as jwire_decode
from repro.serving import wire_encode as jwire_encode
from repro_torch.core import ORBConfig, PipelineConfig, RigConfig, VisualSystem
from repro_torch.core import types
from repro_torch.distributed import compression
from repro_torch.kernels import hamming_match
from repro_torch.serving import wire_decode, wire_encode

from parity import desc_u32, np_of, scene_frames


def _assert_same_payload(got, want, path="wire"):
    """A port wire dict against the JAX one: the same keys; arrays of
    one dtype and shape with the same bytes; ints and shapes equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _assert_same_payload(got[key], want[key], f"{path}.{key}")
        return
    if isinstance(want, (int, tuple)):
        assert got == want, path
        return
    a, b = np_of(got), np.asarray(want)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), path


def _assert_same_fields(got, want, path="out"):
    """Decoded port and JAX outputs bit-equal field by field
    (descriptors as uint32 words)."""
    for name, g, w in zip(want._fields, got, want):
        if isinstance(w, tuple):
            _assert_same_fields(g, w, f"{path}.{name}")
        elif name == "desc":
            np.testing.assert_array_equal(desc_u32(g), desc_u32(w), path)
        else:
            a, b = np_of(g), np.asarray(w)
            assert a.dtype == b.dtype and a.shape == b.shape, (path, name)
            assert a.tobytes() == b.tobytes(), f"{path}.{name}"


def _to_jax(tup):
    """A port output NamedTuple as the JAX package's type, jnp leaves
    (descriptors as uint32)."""
    jtype = getattr(jtypes, type(tup).__name__)
    fields = []
    for name, f in zip(tup._fields, tup):
        if isinstance(f, tuple):
            fields.append(_to_jax(f))
        elif name == "desc":
            fields.append(jnp.asarray(desc_u32(f)))
        else:
            fields.append(jnp.asarray(np_of(f)))
    return jtype(*fields)


def _fields(kind: str, seed: int, shape=(2, 37)):
    """Seeded float, integer and mask fields of ``shape``: ``random``;
    ``zeros`` (every float field all-zero: the scale is 1e-30);
    ``ties`` (max |x| = 127, so the scale is 1 and .5 values land on
    rounding ties)."""
    rng = np.random.RandomState(seed)

    def floats(*tail, lo=-300.0, hi=300.0):
        s = shape + tail
        if kind == "zeros":
            return np.zeros(s, np.float32)
        if kind == "ties":
            x = rng.randint(-126, 127, s) + 0.5
            x.reshape(-1)[0] = 127.0
            return x.astype(np.float32)
        return rng.uniform(lo, hi, s).astype(np.float32)

    return dict(
        xy=floats(2, lo=-5.0, hi=1300.0), score=floats(lo=0.0, hi=900.0),
        theta=floats(lo=-3.2, hi=3.2),
        level=rng.randint(0, 2, shape).astype(np.int32),
        desc=rng.randint(0, 2**32, shape + (8,),
                         dtype=np.uint64).astype(np.uint32),
        valid=rng.rand(*shape) < 0.6,
        right_index=np.where(rng.rand(*shape) < 0.2, -1,
                             rng.randint(0, shape[-1], shape)).astype(np.int32),
        distance=np.where(rng.rand(*shape) < 0.2, hamming_match.BIG,
                          rng.randint(0, 257, shape)).astype(np.int32),
        disparity=floats(lo=0.0, hi=96.0), depth=floats(lo=0.1, hi=80.0),
        xy_right=floats(2, lo=-5.0, hi=1300.0))


def _feature_sets(f):
    names = ("xy", "level", "score", "theta", "desc", "valid")
    port = types.FeatureSet(*[torch.from_numpy(
        f[n].view(np.int32) if n == "desc" else f[n]) for n in names])
    return port, jtypes.FeatureSet(*[jnp.asarray(f[n]) for n in names])


KINDS = ["random", "zeros", "ties"]


@pytest.mark.parametrize("kind", KINDS)
def test_quantizer_bytes_and_scale_equal_jax(kind):
    f = _fields(kind, 1, shape=(3, 50))
    for name in ("xy", "score", "theta", "depth"):
        q, s = compression.quantize_f32(torch.from_numpy(f[name]))
        jq, js = jcomp.quantize_f32(jnp.asarray(f[name]))
        _assert_same_payload(q, jq, name)
        _assert_same_payload(s, js, f"{name} scale")
        _assert_same_payload(compression.dequantize_f32(q, s),
                             jcomp.dequantize_f32(jq, js), f"{name} dequant")
    if kind == "zeros":
        assert float(s) == float(np.float32(1e-30))
    if kind == "ties":
        assert float(s) == 1.0
        # round half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
        q, _ = compression.quantize_f32(torch.tensor(
            [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]))
        assert q.tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("kind", KINDS)
def test_features_wire_equals_jax(kind):
    port, jax_set = _feature_sets(_fields(kind, 2))
    wire, jwire = compression.encode_features(port), \
        jcomp.encode_features(jax_set)
    _assert_same_payload(wire, jwire)
    assert compression.wire_bytes(wire) == jcomp.wire_bytes(jwire)
    _assert_same_fields(compression.decode_features(wire),
                        jcomp.decode_features(jwire))
    np.testing.assert_array_equal(
        desc_u32(compression.decode_features(wire).desc),
        desc_u32(port.desc))


@pytest.mark.parametrize("shape", [(2, 37), (5,), (1, 2, 8), (0,)])
def test_descriptors_and_masks_round_trip(shape):
    f = _fields("random", 3, shape=shape)
    desc = torch.from_numpy(f["desc"].view(np.int32))
    wire = compression.encode_descriptors(desc)
    jwire = jcomp.encode_descriptors(jnp.asarray(f["desc"]))
    _assert_same_payload(wire, jwire, "desc")
    assert torch.equal(compression.decode_descriptors(wire), desc)
    packed = compression._pack_mask(torch.from_numpy(f["valid"]))
    _assert_same_payload(packed, jcomp._pack_mask(jnp.asarray(f["valid"])))
    np.testing.assert_array_equal(
        compression._unpack_mask(packed, shape).numpy(), f["valid"])


@pytest.mark.parametrize("kind", ["random", "zeros"])
def test_matches_and_depth_wire_equal_jax(kind):
    f = _fields(kind, 4)
    names = ("right_index", "distance", "valid")
    m = types.MatchSet(*[torch.from_numpy(f[n]) for n in names])
    jm = jtypes.MatchSet(*[jnp.asarray(f[n]) for n in names])
    wire, jwire = compression.encode_matches(m), jcomp.encode_matches(jm)
    _assert_same_payload(wire, jwire)
    got = compression.decode_matches(wire,
                                     no_match_distance=hamming_match.BIG)
    _assert_same_fields(got, jcomp.decode_matches(
        jwire, no_match_distance=jops.NO_MATCH_DIST))
    # lossless: every slot comes back as it went in
    _assert_same_fields(got, m)
    names = ("disparity", "depth", "xy_right", "valid")
    d = types.DepthSet(*[torch.from_numpy(f[n]) for n in names])
    jd = jtypes.DepthSet(*[jnp.asarray(f[n]) for n in names])
    wire, jwire = compression.encode_depth(d), jcomp.encode_depth(jd)
    _assert_same_payload(wire, jwire)
    _assert_same_fields(compression.decode_depth(wire),
                        jcomp.decode_depth(jwire))


def test_match_index_sentinel_limit():
    assert compression.WIRE_NO_MATCH == jcomp.WIRE_NO_MATCH
    assert hamming_match.BIG == jops.NO_MATCH_DIST
    for k, raises in ((0xFFFE, False), (0xFFFF, True)):
        idx = np.arange(k, dtype=np.int32)[None]
        m = types.MatchSet(torch.from_numpy(idx),
                           torch.zeros((1, k), dtype=torch.int32),
                           torch.ones((1, k), dtype=torch.bool))
        jm = jtypes.MatchSet(jnp.asarray(idx), jnp.zeros((1, k), jnp.int32),
                             jnp.ones((1, k), bool))
        if raises:
            with pytest.raises(ValueError, match="WIRE_NO_MATCH"):
                compression.encode_matches(m)
            with pytest.raises(ValueError, match="WIRE_NO_MATCH"):
                jcomp.encode_matches(jm)
            continue
        wire = compression.encode_matches(m)
        _assert_same_payload(wire, jcomp.encode_matches(jm))
        got = compression.decode_matches(wire, no_match_distance=1)
        assert torch.equal(got.right_index, m.right_index)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_pose_and_points_wire_equal_jax(lead):
    rng = np.random.RandomState(5)
    rot = rng.normal(size=lead + (3, 3)).astype(np.float32)
    tr = rng.normal(size=lead + (3,)).astype(np.float32)
    inl = rng.randint(0, 500, lead).astype(np.int32)
    val = np.asarray(rng.rand(*lead) < 0.5)
    pose = types.PoseSet(*[torch.from_numpy(np.asarray(x))
                           for x in (rot, tr, inl, val)])
    jpose = jtypes.PoseSet(*[jnp.asarray(x) for x in (rot, tr, inl, val)])
    wire, jwire = compression.encode_pose(pose), jcomp.encode_pose(jpose)
    _assert_same_payload(wire, jwire)
    _assert_same_fields(compression.decode_pose(wire),
                        jcomp.decode_pose(jwire))
    _assert_same_fields(compression.decode_pose(wire), pose)
    pts = rng.normal(size=lead + (2, 37, 3)).astype(np.float32)
    wire = compression.encode_points(torch.from_numpy(pts))
    jwire = jcomp.encode_points(jnp.asarray(pts))
    _assert_same_payload(wire, jwire)
    assert compression.wire_bytes(wire) == jcomp.wire_bytes(jwire)
    np.testing.assert_array_equal(compression.decode_points(wire).numpy(),
                                  pts)


@functools.lru_cache(maxsize=2)
def _frame_output(localize: bool):
    """A port ``process_frame`` output on the quad scene at 96 x 128
    (the second frame of a localized session, so its pose solves)."""
    frame, intr = scene_frames()
    vs = VisualSystem(RigConfig.quad(intr),
                      PipelineConfig(orb=ORBConfig(
                          height=96, width=128, max_features=64,
                          max_disparity=64), localize=localize),
                      device="cpu")
    out = vs.process_frame(np.round(frame))
    if localize:
        out = vs.process_frame(np.round(np.roll(frame, 2, axis=-1)))
    return out


@pytest.mark.parametrize("localize", [False, True])
def test_wire_encode_decode_equal_jax(localize):
    out = _frame_output(localize)
    assert isinstance(out, types.LocalizationOutput) == localize
    jout = _to_jax(out)
    wire, jwire = wire_encode(out), jwire_encode(jout)
    _assert_same_payload(wire, jwire)
    assert compression.wire_bytes(wire) == jcomp.wire_bytes(jwire)
    got, want = wire_decode(wire), jwire_decode(jwire)
    assert type(got).__name__ == type(want).__name__
    _assert_same_fields(got, want)
    # lossless fields bit-exact; quantized ones within scale / 2 plus
    # the dequantizing product's rounding (an ulp of max|x|)
    stereo = got.stereo if localize else got
    src = out.stereo if localize else out
    for side in ("features_l", "features_r"):
        g, s = getattr(stereo, side), getattr(src, side)
        for name in ("level", "desc", "valid"):
            assert torch.equal(getattr(g, name), getattr(s, name))
        for name in ("xy", "score", "theta"):
            x = getattr(s, name)
            bound = (float(wire[side][f"{name}_scale"]) / 2
                     + float(x.abs().max()) * 2.0 ** -23)
            assert float((getattr(g, name) - x).abs().max()) <= bound
    for name in ("right_index", "distance", "valid"):
        assert torch.equal(getattr(stereo.matches, name),
                           getattr(src.matches, name))
    assert torch.equal(stereo.depth.valid, src.depth.valid)
    if localize:
        assert torch.equal(got.points, out.points)
        for a, b in zip(got.pose, out.pose):
            assert torch.equal(a, b)
        assert bool(out.pose.valid)
