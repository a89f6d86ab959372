"""The hand-written CUDA kernels against their plain versions, on the
card.  Marked ``gpu``: on a host without a card they skip (a CUDA kernel
has no interpret mode).  Run them on a card with

    PYTHONPATH=src python -m pytest tests/port/test_torch_cuda.py -q

(the other files of ``tests/port`` import jax, which a card host may
not have)

Tolerances as in ``parity.py``: dense FE (whole frame and per level),
the FAST score map, the 7x7 blur and the five matchers (fused,
match-only, SAD-only, and the unfused schedule's Hamming matcher and SAD
sweep) bit-equal; the sparse FE (whole frame and per level) and
orientation only under the sparse-FE rule (integer-valued inputs here,
so moments equal and theta within 1 ulp); orientation only and the
per-level sparse FE bit-equal to the whole-frame sparse FE, and the
per-level dense FE to the whole-frame one (shared device code), so the
per-level schedule equals the whole-frame one; a localized frame's pose
within the CPU tests' pose tolerance (the SVD runs in another library on
the card); a fleet frame's rig slices bit-equal to the rigs' frames in 3
launches (4 localized, with poses within 1e-5 / 1e-4 of the per-rig
loop's: one batched SVD against one a rig).  The uint8 variants (K1-K3,
K5-K8) are held to their plain versions by the same rules, and
bit-equal to the float kernels on the same integer-valued input, theta
included (the same ``atan2f`` on the same exact moments).  On
adversarial frames (plateaus, ties, signed zeros, values one ulp about
centre +- threshold, large and subnormal magnitudes, uint8 0 and 255)
and shapes about the 62 x 62 dense tile, the dense kernels are
bit-equal as float32 bit patterns, so signed zeros count."""

import numpy as np
import pytest
import torch

from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                              VisualSystem, extract_features,
                              extract_features_batched,
                              extract_features_per_level, fast, matching,
                              pyramid)
from repro_torch.core.types import map_fields
from repro_torch.data import scenes
from repro_torch.kernels import (describe_fused, fast_detect, frontend_fused,
                                 gaussian_blur, hamming_match, match_fused,
                                 matcher_fused, ops, sad_fused, sad_rectify)
from repro_torch.kernels.ref import nms3

from parity import (abs_moment_sums, adversarial_matcher_cases,
                    assert_sparse_parity, matcher_case, near_bin_edge,
                    scene_frames, textured_levels, ulp_diff)

pytestmark = pytest.mark.gpu
SHAPES = [(96, 128), (80, 107)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("integer", [False, True])
def test_dense_kernel_equals_plain(cuda, integer):
    levels = [torch.from_numpy(l).to(cuda)
              for l in textured_levels(1, SHAPES, integer=integer)]
    flat, slabs = ops.flat_levels(levels), ops._slabs_of(levels)
    for nms, quantized in ((True, True), (False, True), (True, False)):
        kw = dict(threshold=20.0, nms=nms, quantized=quantized)
        got = frontend_fused.frontend_fused_pyramid_cuda(flat, slabs, **kw)
        want = frontend_fused.frontend_fused_pyramid_plain(flat, slabs, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# Shapes about the dense tile (62 x 62 outputs, a 64 x 64 FAST rim):
# smaller than one tile, one edge shorter than a tile, partial tiles on
# both edges, three tile rows on a 61-wide level.
DENSE_SHAPES = [(7, 7), (18, 26), (33, 65), (37, 53), (130, 61)]


def adversarial_frames(seed: int, h: int, w: int, integer: bool) -> dict:
    """(3, h, w) float32 frames that stress the dense FE's exactness:
    plateaus and ties, values one ulp about centre +- threshold (20),
    uint8 0 and 255 edges; on float frames also signed zeros,
    non-integer values, and large and subnormal magnitudes (a blur sum
    stays finite)."""
    rng = np.random.RandomState(seed)
    shape = (3, h, w)
    ties = np.round(rng.uniform(0, 255, shape) / 64) * 64
    ties[:, h // 4:h // 2 + 1, w // 4:w // 2 + 1] = 77.0
    edges = rng.choice([0.0, 255.0, 1.0, 254.0, 128.0], size=shape)
    edges[0, :h // 2, :w // 2] = 255.0
    edges[1, h // 2:, w // 2:] = 0.0
    ulp = []
    for v in np.float32([80.3, 100.3, 120.3]):
        ulp += [v, np.nextafter(v, np.float32(np.inf)),
                np.nextafter(v, np.float32(-np.inf))]
    frames = {"plateaus and ties": ties, "0 and 255 edges": edges,
              "one ulp about centre +- threshold": rng.choice(
                  np.float32(ulp), size=shape)}
    if integer:
        frames = {k: np.round(v) for k, v in frames.items()}
    else:
        zeros = rng.choice([0.0, -0.0, 25.0, -25.0], size=shape)
        zeros[0, :h // 2] = -0.0
        frames.update({
            "signed zeros": zeros,
            "non-integer": rng.uniform(-40.0, 300.0, shape),
            "large and subnormal magnitudes": rng.choice(
                np.float32([3e36, -3e36, 1e30, 1.5e-38, 1e-40, 0.0]),
                size=shape)})
    return {k: np.ascontiguousarray(v, np.float32) for k, v in frames.items()}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal: float32 compared as int32, so signed zeros count."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("integer", [False, True])
def test_dense_kernels_on_adversarial_frames(cuda, integer):
    """K1 over every shape's slab at once, K6 on each shape and K11,
    on the adversarial frames, both datapaths (uint8 variants on the
    integer frames), every (nms, quantized) case and thresholds 20 and
    0: bit-equal to the plain versions, K6 to K1's slab, nms3(K11) to
    K1's score."""
    for name in adversarial_frames(0, 7, 7, integer):
        levels = [torch.from_numpy(adversarial_frames(
            seed, h, w, integer)[name]).to(cuda)
            for seed, (h, w) in enumerate(DENSE_SHAPES)]
        kinds = [levels]
        if integer:
            kinds.append([lv.to(torch.uint8) for lv in levels])
        for lv in kinds:
            flat, slabs = ops.flat_levels(lv), ops._slabs_of(lv)
            u8 = flat.dtype == torch.uint8
            for threshold in (20.0, 0.0):
                for nms, quantized in ((True, True), (False, True),
                                       (True, False)):
                    if u8 and not quantized:
                        continue
                    kw = dict(threshold=threshold, nms=nms,
                              quantized=quantized)
                    k1 = frontend_fused.frontend_fused_pyramid_cuda(
                        flat, slabs, **kw)
                    want = frontend_fused.frontend_fused_pyramid_plain(
                        flat, slabs, **kw)
                    for a, b in zip(k1, want):
                        assert same_bits(a, b), (name, threshold, nms)
                    for x, (off, h, w) in zip(lv, slabs.slabs[::3]):
                        k6 = frontend_fused.frontend_fused_cuda(x, **kw)
                        want = frontend_fused.frontend_fused_plain(x, **kw)
                        for a, b, c in zip(k6, want, k1):
                            assert same_bits(a, b), (name, (h, w), nms)
                            assert same_bits(
                                a.reshape(-1), c[off:off + 3 * h * w])
                if not u8:
                    k1 = frontend_fused.frontend_fused_pyramid_cuda(
                        flat, slabs, threshold=threshold)[1]
                    for x, (off, h, w) in zip(lv, slabs.slabs[::3]):
                        k11 = fast_detect.fast_score_map_cuda(x, threshold)
                        assert same_bits(k11, frontend_fused.fast_score_plain(
                            x, threshold)), (name, (h, w))
                        assert same_bits(nms3(k11).reshape(-1),
                                         k1[off:off + 3 * h * w])


def test_sparse_kernel_equals_plain(cuda):
    """K2 on integer-valued, float and uint8 levels, keypoints up to 8 px
    past every edge (the clamp), (40, 40) and (21, 16) a level: 4 x 37
    keypoints, no multiple of the 8-keypoint block."""
    rng = np.random.RandomState(0)
    for integer, ks in ((True, (40, 40)), (True, (21, 16)), (False, (21, 16))):
        levels = [torch.from_numpy(l).to(cuda) for l in
                  textured_levels(2, SHAPES, integer=integer)]
        dense = ops.fast_blur_nms_pyramid(levels, 20.0)
        xys = [torch.from_numpy(np.stack(
            [rng.randint(-8, w + 8, (4, k)), rng.randint(-8, h + 8, (4, k))],
            -1).astype(np.int32)).to(cuda) for (h, w), k in zip(SHAPES, ks)]
        xy = torch.cat(xys, 1).contiguous()
        col = ops._col_levels(ks, str(xy.device))
        raw = ops.flat_levels(levels)
        sm = ops.flat_levels([b for b, _ in dense])
        slabs = ops._slabs_of(levels)
        pixels = [(raw, sm)] + ([(raw.to(torch.uint8), sm.to(torch.uint8))]
                                if integer else [])
        for r, s in pixels:
            got = describe_fused.describe_fused_pyramid_cuda(r, s, slabs, xy,
                                                             col)
            want = describe_fused.describe_fused_pyramid_plain(r, s, slabs,
                                                               xy, col)
            s_abs = None
            if not integer:
                b = xy.shape[0]
                slab = col.long()[None, :] * b + torch.arange(
                    b, device=cuda)[:, None]
                s_abs = abs_moment_sums(describe_fused._slab_patches(
                    r, slab, slabs.table, xy)).cpu()
            assert_sparse_parity(*[t.cpu() for t in want],
                                 *[t.cpu() for t in got], s_abs,
                                 integer=integer)


def test_matcher_kernel_equals_plain(cuda):
    """K3 on float and uint8 images, and K4 and K9 on the same features,
    bit-equal to their plain versions: random cases, planted ties,
    half-pixel centers, and ``parity.adversarial_matcher_cases`` (a
    crowded row band past one staging chunk, ties across lanes and
    chunks, distances at max_hamming, no candidate, invalid left
    features, centers at the clamps, ragged K and M, K = 0; M = 0 for the
    match-only kernels, which the fused one refuses), and meta rows and
    descriptors that lie 4 but not 16 bytes aligned."""
    kw = dict(row_band=2.0, max_disparity=24.0, max_hamming=64)
    kw4 = dict(row_band=2.0, max_disparity=24.0)
    cases = [(str(c), matcher_case(**c)) for c in (
        dict(seed=0), dict(seed=1, ties=True), dict(seed=2, half_centers=True),
        dict(seed=3, k=5, m=130))] + adversarial_matcher_cases()
    for name, (dl, ml, dr, mr, il, ir) in cases:
        args = [torch.from_numpy(a).to(cuda) for a in
                (dl.view(np.int32), ml, dr.view(np.int32), mr, il, ir)]
        if not dr.shape[1]:
            # the gate's fallback reads right feature 0: M = 0 is refused
            with pytest.raises(ValueError, match="right feature"):
                matcher_fused.match_rectify_fused_cuda(*args, **kw)
        else:
            for imgs in (args[4:], [a.round().clamp(0, 255).to(torch.uint8)
                                    for a in args[4:]]):
                got = matcher_fused.match_rectify_fused_cuda(*args[:4], *imgs,
                                                             **kw)
                want = matcher_fused.match_rectify_fused_plain(*args[:4],
                                                               *imgs, **kw)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (name, imgs[0].dtype)
        got = match_fused.match_fused_cuda(*args[:4], **kw4)
        want = match_fused.match_fused_plain(*args[:4], **kw4)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
        for p in range(dl.shape[0]):
            one = [a[p].contiguous() for a in args[:4]]
            got = hamming_match.hamming_match_cuda(*one, **kw4)
            want = hamming_match.hamming_match_plain(*one, **kw4)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (name, p)
    # meta rows and descriptors 4 but not 16 bytes aligned (the kernels
    # then stage them with scalar loads)
    dl, ml, dr, mr, il, ir = matcher_case(seed=7, k=33, m=70)
    args = []
    for a in (dl.view(np.int32), ml, dr.view(np.int32), mr):
        buf = torch.zeros(a.size + 1, dtype=torch.from_numpy(a).dtype,
                          device=cuda)
        buf[1:] = torch.from_numpy(a).reshape(-1).to(cuda)
        args.append(buf[1:].view(a.shape))
    assert args[1].data_ptr() % 16 == 4
    imgs = [torch.from_numpy(a).to(cuda) for a in (il, ir)]
    for a, b in zip(matcher_fused.match_rectify_fused_cuda(*args, *imgs, **kw),
                    matcher_fused.match_rectify_fused_plain(*args, *imgs,
                                                            **kw)):
        assert torch.equal(a, b), "unaligned"
    for a, b in zip(match_fused.match_fused_cuda(*args, **kw4),
                    match_fused.match_fused_plain(*args, **kw4)):
        assert torch.equal(a, b), "unaligned"


def test_process_frame_is_three_launches_and_matches_cpu(cuda):
    frame, intr = scene_frames()
    frame = np.round(frame)
    cfg = ORBConfig(height=96, width=128, max_features=64, max_disparity=64)
    pipe = PipelineConfig(orb=cfg)
    vs = VisualSystem(RigConfig.quad(intr), pipe)
    assert vs.device.type == "cuda"
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    with ops.launch_audit() as audit:
        out = vs.process_frame(frame)
        torch.cuda.synchronize()
    assert audit.count == 3
    assert all(ops.KERNELS[n].launches == before[n] + 1
               for n in ops.FRAME_KERNELS)
    assert all(ops.KERNELS[n].launches == before[n] for n in ops.KERNELS
               if n not in ops.FRAME_KERNELS)
    top = fast.select_topk(torch.zeros(1, 8, 8, device=cuda), 4, 1)
    assert top[0].device.type == "cuda"
    ref = VisualSystem(RigConfig.quad(intr), pipe, device="cpu")
    feats_cpu = ref.extract(frame)
    assert min(out.depth.valid.sum(-1).tolist()) > 0
    assert torch.equal(out.features_l.xy.cpu()[:, :cfg.features_per_level()[0]],
                       feats_cpu.xy[[0, 2]][:, :cfg.features_per_level()[0]])


@pytest.mark.parametrize("shift", [0.0, 48.0], ids=["stereo", "temporal"])
def test_match_only_kernel_equals_plain(cuda, shift):
    for case in (dict(seed=0), dict(seed=1, ties=True),
                 dict(seed=3, k=5, m=130)):
        dl, ml, dr, mr, _, _ = matcher_case(**case)
        ml = ml.copy()
        ml[..., 0] += np.float32(shift)
        args = [torch.from_numpy(a).to(cuda) for a in
                (dl.view(np.int32), ml, dr.view(np.int32), mr)]
        kw = dict(row_band=2.0 if shift == 0 else shift,
                  max_disparity=24.0 if shift == 0 else 2 * shift)
        got = match_fused.match_fused_cuda(*args, **kw)
        want = match_fused.match_fused_plain(*args, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int((got[1] >= 0).sum()) > 0


def test_sad_only_kernel_equals_plain(cuda):
    dl, ml, dr, mr, il, ir = matcher_case(seed=2, half_centers=True)
    for xy_l, xy_r in ((ml[..., :2], mr[:, :ml.shape[1], :2]),
                       (ml[..., :2] * 1.4 - 6.0, ml[..., :2] + 0.5)):
        args = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            cuda) for a in (il, ir, xy_l, xy_r)]
        got = sad_fused.sad_fused_cuda(*args, sad_window=11, sad_range=5)
        want = sad_fused.sad_fused_plain(*args, sad_window=11, sad_range=5)
        assert torch.equal(got, want)


def test_localized_frame_is_four_launches_and_matches_cpu(cuda):
    seq = scenes.render_sequence(scenes.SceneConfig(
        height=96, width=128, baseline=0.5, seed=1), 3,
        step_t=(0.25, 0.0, 0.1), yaw_per_frame=0.0)
    cfg = ORBConfig(height=96, width=128, max_features=96,
                    fast_threshold=15)
    pipe = PipelineConfig(orb=cfg, localize=True)
    rig = RigConfig.quad(seq.intrinsics)
    card, cpu = VisualSystem(rig, pipe), VisualSystem(rig, pipe, "cpu")
    frames = np.round(seq.frames)
    for t in range(3):
        with ops.launch_audit() as audit:
            got = card.process_frame(frames[t])
            torch.cuda.synchronize()
        assert audit.count == 4
        want = cpu.process_frame(frames[t])
        assert bool(got.pose.valid) == bool(want.pose.valid) == (t > 0)
        assert torch.isfinite(got.pose.rotation).all()
        assert torch.allclose(got.pose.rotation.cpu(), want.pose.rotation,
                              atol=1e-4)
        assert torch.allclose(got.pose.translation.cpu(),
                              want.pose.translation, atol=1e-3)


@pytest.mark.parametrize("integer", [False, True])
def test_fast_score_and_blur_kernels_equal_plain_and_dense_fe(cuda, integer):
    for lv in textured_levels(3, SHAPES + [(70, 100)], integer=integer):
        x = torch.from_numpy(lv).to(cuda)
        score = fast_detect.fast_score_map_cuda(x, 20.0)
        assert torch.equal(score,
                           frontend_fused.fast_score_plain(x, 20.0))
        for quantized in (True, False):
            blur = gaussian_blur.gaussian_blur7_cuda(x, quantized)
            assert torch.equal(blur,
                               frontend_fused.blur_plain(x, quantized))
            flat, slabs = ops.flat_levels([x]), ops._slabs_of([x])
            k1_blur, k1_score = frontend_fused.frontend_fused_pyramid_cuda(
                flat, slabs, threshold=20.0, quantized=quantized)
            assert torch.equal(blur.reshape(-1), k1_blur)
            assert torch.equal(nms3(score).reshape(-1), k1_score)


def test_orient_kernel_equals_plain_and_sparse_fe(cuda):
    h, w = SHAPES[1]
    raw = torch.from_numpy(textured_levels(4, [(h, w)],
                                           integer=True)[0]).to(cuda)
    rng = np.random.RandomState(1)
    xy = torch.from_numpy(np.stack(
        [rng.randint(-8, w + 8, (4, 37)), rng.randint(-8, h + 8, (4, 37))],
        -1).astype(np.int32)).to(cuda)
    th_k, mom_k = describe_fused.orient_fused_cuda(raw, xy)
    th_p, mom_p = describe_fused.orient_fused_plain(raw, xy)
    zeros = torch.zeros(4, 37, 8, dtype=torch.int32)
    assert_sparse_parity(th_p.cpu(), mom_p.cpu(), zeros, th_k.cpu(),
                         mom_k.cpu(), zeros, None, integer=True)
    sm = ops.fast_blur_nms_pyramid([raw], 20.0)[0][0]
    th2, mom2, _ = describe_fused.describe_fused_pyramid_cuda(
        ops.flat_levels([raw]), ops.flat_levels([sm]), ops._slabs_of([raw]),
        xy, ops._col_levels((37,), str(xy.device)))
    assert torch.equal(th_k, th2) and torch.equal(mom_k, mom2)


@pytest.mark.parametrize("integer", [False, True])
def test_detect_is_two_launches_and_equals_extract_features(cuda, integer):
    frame, _ = scene_frames()
    img = torch.from_numpy(np.round(frame[0]) if integer
                           else frame[0]).to(cuda)
    cfg = ORBConfig(height=96, width=128, max_features=64, n_levels=1)
    k = cfg.features_per_level()[0]
    before = {n: kern.launches for n, kern in ops.KERNELS.items()}
    with ops.launch_audit() as audit:
        xy, _, theta, valid = fast.detect(img, cfg, k)
        torch.cuda.synchronize()
    assert audit.count == 2
    assert ops.KERNELS["fast_score_map"].launches == \
        before["fast_score_map"] + 1
    assert ops.KERNELS["orient_fused"].launches == before["orient_fused"] + 1
    feats = extract_features(img, cfg)
    assert torch.equal(xy.float(), feats.xy)
    assert torch.equal(theta, feats.theta)
    assert torch.equal(valid, feats.valid)


def test_hamming_match_kernel_equals_plain(cuda):
    """One pair at a time: K and M not multiples of anything, planted
    ties (``matcher_case(ties=True)``) and an empty right set."""
    for case, m_used in ((dict(seed=0), None), (dict(seed=1, ties=True), None),
                         (dict(seed=3, k=5, m=130), None),
                         (dict(seed=4, k=64, m=64), 0)):
        dl, ml, dr, mr, _, _ = matcher_case(p=1, **case)
        dr, mr = dr[:, :m_used], mr[:, :m_used]
        args = [torch.from_numpy(np.ascontiguousarray(a[0])).to(cuda) for a in
                (dl.view(np.int32), ml, dr.view(np.int32), mr)]
        kw = dict(row_band=2.0, max_disparity=24.0)
        got = hamming_match.hamming_match_cuda(*args, **kw)
        want = hamming_match.hamming_match_plain(*args, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        found = int((got[1] >= 0).sum())
        assert found == 0 if m_used == 0 else found > 0


@pytest.mark.parametrize("integer", [False, True])
def test_sad_search_kernel_equals_plain(cuda, integer):
    rng = np.random.RandomState(6)
    for window, sad_range, k in ((11, 5, 37), (7, 3, 130), (15, 15, 9)):
        shapes = ((k, window, window), (k, window, window + 2 * sad_range))
        lp, rs = (rng.uniform(-20.0, 255.0, s).astype(np.float32)
                  for s in shapes)
        if integer:
            lp, rs = np.round(lp), np.round(rs)
        lp, rs = (torch.from_numpy(a).to(cuda) for a in (lp, rs))
        got = sad_rectify.sad_search_cuda(lp, rs)
        assert torch.equal(got, sad_rectify.sad_search_plain(lp, rs))


@pytest.mark.parametrize("integer", [False, True])
def test_match_pair_unfused_is_two_launches_and_equals_fused(cuda, integer):
    frame, intr = scene_frames()
    frame = torch.from_numpy(np.round(frame) if integer else frame).to(cuda)
    cfg = ORBConfig(height=96, width=128, max_features=64, max_disparity=64)
    vs = VisualSystem(RigConfig.quad(intr), PipelineConfig(orb=cfg))
    feats = vs.extract(frame)
    li, ri = [0, 2], [1, 3]
    fl, fr = (map_fields(lambda x: x[c], feats) for c in (li, ri))
    mf, df = matching.match_pair_fused(frame[li], frame[ri], fl, fr, cfg,
                                       intr)
    for p in range(2):
        before = {n: kern.launches for n, kern in ops.KERNELS.items()}
        with ops.launch_audit() as audit:
            mu, du = matching.match_pair_unfused(
                frame[li[p]], frame[ri[p]], map_fields(lambda x: x[p], fl),
                map_fields(lambda x: x[p], fr), cfg, intr)
            torch.cuda.synchronize()
        assert audit.count == 2
        assert all(ops.KERNELS[n].launches == before[n] + 1
                   for n in ("hamming_match", "sad_search"))
        for got, want in ((mf, mu), (df, du)):
            for a, b in zip(want, got):
                assert torch.equal(b[p], a)
    assert int(df.valid.sum()) > 0


@pytest.mark.parametrize("integer", [False, True])
def test_frontend_level_kernel_equals_plain_and_dense_fe(cuda, integer):
    """K6 on levels down to one smaller than a 32-pixel tile, bit-equal
    to its plain version and to K1 on the same level."""
    for lv in textured_levels(5, SHAPES + [(37, 53), (18, 26)],
                              integer=integer):
        x = torch.from_numpy(lv).to(cuda)
        for nms, quantized in ((True, True), (False, True), (True, False)):
            kw = dict(threshold=20.0, nms=nms, quantized=quantized)
            got = frontend_fused.frontend_fused_cuda(x, **kw)
            want = frontend_fused.frontend_fused_plain(x, **kw)
            k1 = frontend_fused.frontend_fused_pyramid_cuda(
                ops.flat_levels([x]), ops._slabs_of([x]), **kw)
            for a, b, c in zip(got, want, k1):
                assert torch.equal(a, b)
                assert torch.equal(a.reshape(-1), c)


def test_describe_level_kernel_equals_plain_and_sparse_fe(cuda):
    """K7 at K = 37 (no multiple of the 4-warp block), keypoints up to
    8 px past every edge, against its plain version and K2; K = 0 makes
    no launch."""
    h, w = SHAPES[1]
    raw = torch.from_numpy(textured_levels(6, [(h, w)],
                                           integer=True)[0]).to(cuda)
    sm = frontend_fused.frontend_fused_cuda(raw, threshold=20.0)[0]
    rng = np.random.RandomState(2)
    xy = torch.from_numpy(np.stack(
        [rng.randint(-8, w + 8, (4, 37)), rng.randint(-8, h + 8, (4, 37))],
        -1).astype(np.int32)).to(cuda)
    got = describe_fused.describe_fused_cuda(raw, sm, xy)
    want = describe_fused.describe_fused_plain(raw, sm, xy)
    assert_sparse_parity(*[t.cpu() for t in want], *[t.cpu() for t in got],
                         None, integer=True)
    k2 = describe_fused.describe_fused_pyramid_cuda(
        ops.flat_levels([raw]), ops.flat_levels([sm]), ops._slabs_of([raw]),
        xy, ops._col_levels((37,), str(xy.device)))
    for a, b in zip(got, k2):
        assert torch.equal(a, b)
    before = describe_fused.LEVEL_KERNEL.launches
    empty = describe_fused.describe_fused_cuda(raw, sm,
                                               xy[:, :0].contiguous())
    assert [tuple(t.shape) for t in empty] == [(4, 0), (4, 0, 2), (4, 0, 8)]
    assert describe_fused.LEVEL_KERNEL.launches == before


@pytest.mark.parametrize("integer", [False, True])
def test_per_level_is_two_launches_a_level_and_equals_whole_frame(cuda,
                                                                   integer):
    frame, _ = scene_frames()
    small = np.random.RandomState(3).randint(0, 256, (3, 37, 53))
    for imgs, cfg in (
            (frame, ORBConfig(height=96, width=128, max_features=64)),
            (small, ORBConfig(height=37, width=53, max_features=48,
                              n_levels=5))):
        imgs = torch.from_numpy((np.round(imgs) if integer else imgs)
                                .astype(np.float32)).to(cuda)
        before = {n: kern.launches for n, kern in ops.KERNELS.items()}
        with ops.launch_audit() as audit:
            per = extract_features_per_level(imgs, cfg)
            torch.cuda.synchronize()
        assert audit.count == 2 * cfg.n_levels
        for n, kern in ops.KERNELS.items():
            step = cfg.n_levels if n in ("frontend_fused",
                                         "describe_fused") else 0
            assert kern.launches == before[n] + step, n
        whole = extract_features_batched(imgs, cfg)
        for name in per._fields:
            assert torch.equal(getattr(per, name), getattr(whole, name)), name


def _u8_pyramid(cuda):
    """The odd 5-level 37 x 53 uint8 pyramid of 3 cameras, and an 18 x 26
    level (smaller than one tile) of 4."""
    cfg = ORBConfig(height=37, width=53, max_features=48, n_levels=5)
    imgs = torch.from_numpy(np.random.RandomState(8).randint(
        0, 256, (3, 37, 53)).astype(np.uint8)).to(cuda)
    levels = pyramid.build_pyramid_batched(imgs, cfg, precision="uint8")
    tiny = torch.from_numpy(np.round(textured_levels(
        9, [(18, 26)], integer=True)[0]).astype(np.uint8)).to(cuda)
    return levels, tiny


def _variant_step(name):
    """The (f32, u8) launches of kernel ``name`` so far."""
    v = ops.KERNELS[name].variant_launches
    return v["f32"], v["u8"]


def test_u8_dense_kernels_equal_plain_and_float(cuda):
    """K1 over the 5-level pyramid and K6 on each level and on the
    18 x 26 level: uint8 blur and int16 score bit-equal to the plain
    version and, in value, to the float kernels on the float copy."""
    levels, tiny = _u8_pyramid(cuda)
    for nms in (True, False):
        kw = dict(threshold=20.0, nms=nms, quantized=True)
        flat, slabs = ops.flat_levels(levels), ops._slabs_of(levels)
        assert flat.dtype == torch.uint8
        before = _variant_step("frontend_fused_pyramid")
        got = frontend_fused.frontend_fused_pyramid_cuda(flat, slabs, **kw)
        assert _variant_step("frontend_fused_pyramid") == (before[0],
                                                           before[1] + 1)
        want = frontend_fused.frontend_fused_pyramid_plain(flat, slabs, **kw)
        flt = frontend_fused.frontend_fused_pyramid_cuda(flat.float(), slabs,
                                                         **kw)
        assert [t.dtype for t in got] == [torch.uint8, torch.int16]
        for a, b, c in zip(got, want, flt):
            assert torch.equal(a, b) and torch.equal(a.float(), c)
        for x in list(levels) + [tiny]:
            got = frontend_fused.frontend_fused_cuda(x, **kw)
            want = frontend_fused.frontend_fused_plain(x, **kw)
            flt = frontend_fused.frontend_fused_cuda(x.float(), **kw)
            for a, b, c in zip(got, want, flt):
                assert torch.equal(a, b) and torch.equal(a.float(), c)
    with pytest.raises(ValueError, match="quantized=True"):
        frontend_fused.frontend_fused_cuda(tiny, threshold=20.0,
                                           quantized=False)


@pytest.mark.parametrize("k", [37, 0])
def test_u8_sparse_kernels_equal_plain_and_float(cuda, k):
    """K2 over the 5-level pyramid, K7 and K8 on each level and on the
    18 x 26 level, keypoints up to 8 px past every edge: held to the
    plain version by the sparse rule, bit-equal to the float kernels.
    K = 0 gives empty outputs and no launch."""
    levels, tiny = _u8_pyramid(cuda)
    dense = ops.fast_blur_nms_pyramid(levels, 20.0)
    assert dense[0][0].dtype == torch.uint8
    rng = np.random.RandomState(k)

    def keypoints(b, h, w):
        return torch.from_numpy(np.stack(
            [rng.randint(-8, w + 8, (b, k)), rng.randint(-8, h + 8, (b, k))],
            -1).astype(np.int32)).to(cuda)

    xys = [keypoints(*lv.shape) for lv in levels]
    xy = torch.cat(xys, 1).contiguous()
    col = ops._col_levels((k,) * len(levels), str(xy.device))
    raw, sm = ops.flat_levels(levels), ops.flat_levels([b for b, _ in dense])
    slabs = ops._slabs_of(levels)
    before = _variant_step("describe_fused_pyramid")
    got = describe_fused.describe_fused_pyramid_cuda(raw, sm, slabs, xy, col)
    assert _variant_step("describe_fused_pyramid")[1] == before[1] + (k > 0)
    want = describe_fused.describe_fused_pyramid_plain(raw, sm, slabs, xy,
                                                       col)
    flt = describe_fused.describe_fused_pyramid_cuda(raw.float(), sm.float(),
                                                     slabs, xy, col)
    assert_sparse_parity(*[t.cpu() for t in want], *[t.cpu() for t in got],
                         None, integer=True)
    for a, c in zip(got, flt):
        assert torch.equal(a, c)
    blur_tiny = frontend_fused.frontend_fused_cuda(tiny, threshold=20.0)[0]
    for x, smx, xy_l in [(lv, sm_l, xy_l) for lv, (sm_l, _), xy_l in
                         zip(levels, dense, xys)] + [
                             (tiny, blur_tiny, keypoints(*tiny.shape))]:
        got = describe_fused.describe_fused_cuda(x, smx, xy_l)
        want = describe_fused.describe_fused_plain(x, smx, xy_l)
        flt = describe_fused.describe_fused_cuda(x.float(), smx.float(),
                                                 xy_l)
        assert_sparse_parity(*[t.cpu() for t in want],
                             *[t.cpu() for t in got], None, integer=True)
        for a, c in zip(got, flt):
            assert torch.equal(a, c)
        th, mom = describe_fused.orient_fused_cuda(x, xy_l)
        th_p, mom_p = describe_fused.orient_fused_plain(x, xy_l)
        zeros = torch.zeros(*th.shape, 8, dtype=torch.int32)
        assert_sparse_parity(th_p.cpu(), mom_p.cpu(), zeros, th.cpu(),
                             mom.cpu(), zeros, None, integer=True)
        assert torch.equal(th, got[0]) and torch.equal(mom, got[1])


def test_u8_matcher_kernels_equal_plain_and_float(cuda):
    """K3 and K5 on uint8 images: every output bit-equal to the plain
    version and to the float kernels on the same integer values."""
    for case in (dict(seed=0), dict(seed=1, ties=True),
                 dict(seed=2, half_centers=True)):
        dl, ml, dr, mr, il, ir = matcher_case(**case)
        il, ir = np.round(il).astype(np.uint8), np.round(ir).astype(np.uint8)
        args = [torch.from_numpy(a).to(cuda) for a in
                (dl.view(np.int32), ml, dr.view(np.int32), mr, il, ir)]
        kw = dict(row_band=2.0, max_disparity=24.0, max_hamming=64)
        got = matcher_fused.match_rectify_fused_cuda(*args, **kw)
        want = matcher_fused.match_rectify_fused_plain(*args, **kw)
        flt = matcher_fused.match_rectify_fused_cuda(
            *args[:4], args[4].float(), args[5].float(), **kw)
        for a, b, c in zip(got, want, flt):
            assert torch.equal(a, b) and torch.equal(a, c)
        xy_l = args[1][..., :2].contiguous()
        xy_r = args[3][:, :ml.shape[1], :2].contiguous()
        got = sad_fused.sad_fused_cuda(args[4], args[5], xy_l, xy_r)
        assert torch.equal(got, sad_fused.sad_fused_plain(args[4], args[5],
                                                          xy_l, xy_r))
        assert torch.equal(got, sad_fused.sad_fused_cuda(
            args[4].float(), args[5].float(), xy_l, xy_r))


def test_u8_process_frame_is_three_u8_launches_and_equals_f32(cuda):
    frame, intr = scene_frames()
    frame = np.round(frame)
    cfg = ORBConfig(height=96, width=128, max_features=64, max_disparity=64)
    rig = RigConfig.quad(intr)
    u8 = VisualSystem(rig, PipelineConfig(orb=cfg, precision="uint8"))
    f32 = VisualSystem(rig, PipelineConfig(orb=cfg))
    before = {n: _variant_step(n) for n in ops.FRAME_KERNELS}
    with ops.launch_audit() as audit:
        got = u8.process_frame(frame.astype(np.uint8))
        torch.cuda.synchronize()
    assert audit.count == 3
    for n in ops.FRAME_KERNELS:
        assert _variant_step(n) == (before[n][0], before[n][1] + 1), n
    want = f32.process_frame(frame)
    for grp_got, grp_want in zip(got, want):
        for x, y in zip(grp_got, grp_want):
            assert torch.equal(x, y)
    assert min(got.depth.valid.sum(-1).tolist()) > 0


def _fleet_frames(n_rigs):
    seq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=96, width=128, n_points=300, baseline=0.3), 1, n_rigs)
    return np.round(seq.frames), seq.intrinsics


@pytest.mark.parametrize("n_rigs", [1, 2, 5])
def test_process_fleet_is_three_launches_and_equals_frames(cuda, n_rigs):
    """The rig axis folds into K1-K3's batch axes: one launch of each
    for the whole fleet, masked or not, and each rig's slice bit-equal
    to that rig's ``process_frame`` on the card."""
    frames, intr = _fleet_frames(n_rigs)
    cfg = ORBConfig(height=96, width=128, max_features=64, max_disparity=64)
    vs = VisualSystem(RigConfig.quad(intr), PipelineConfig(orb=cfg))
    mask = np.ones((n_rigs, 4), bool)
    mask[-1, 2:] = False
    for cm in (None, mask):
        before = {n: k.launches for n, k in ops.KERNELS.items()}
        with ops.launch_audit() as audit:
            out = vs.process_fleet(frames[0], camera_mask=cm)
            torch.cuda.synchronize()
        assert audit.count == 3
        assert all(ops.KERNELS[n].launches == before[n] + 1
                   for n in ops.FRAME_KERNELS)
        for r in range(n_rigs):
            want = vs.process_frame(frames[0, r],
                                    camera_mask=None if cm is None
                                    else cm[r])
            for grp_got, grp_want in zip(out, want):
                for x, y in zip(grp_got, grp_want):
                    assert torch.equal(x[r], y)
    assert not out.matches.valid[-1, 1].any()


def test_localized_fleet_is_four_launches_and_equals_frames(cuda):
    seq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=96, width=128, baseline=0.5, seed=1), 2, 3,
        step_t=(0.25, 0.0, 0.1), yaw_per_frame=0.0)
    frames = np.round(seq.frames)
    cfg = ORBConfig(height=96, width=128, max_features=96,
                    fast_threshold=15)
    pipe = PipelineConfig(orb=cfg, localize=True)
    rig = RigConfig.quad(seq.intrinsics)
    fleet = VisualSystem(rig, pipe)
    loop = [VisualSystem(rig, pipe) for _ in range(3)]
    for t in range(2):
        with ops.launch_audit() as audit:
            got = fleet.process_fleet(frames[t])
            torch.cuda.synchronize()
        assert audit.count == 4
        for r in range(3):
            want = loop[r].process_frame(frames[t, r])
            assert torch.equal(got.points[r], want.points)
            assert bool(got.pose.valid[r]) == bool(want.pose.valid) == (t > 0)
            assert torch.allclose(got.pose.rotation[r], want.pose.rotation,
                                  rtol=0, atol=1e-5)
            assert torch.allclose(got.pose.translation[r],
                                  want.pose.translation, rtol=0, atol=1e-4)
    with ops.launch_audit() as audit:
        run = fleet.run_fleet(frames)
        torch.cuda.synchronize()
    assert audit.count == 3 * 2 + 1
    assert run.pose.valid.tolist() == [[False] * 3, [True] * 3]


# -- the pipelined schedule and the pose backend ----------------------------------

def _tensors(tup):
    out = []
    for x in tup:
        out += _tensors(x) if isinstance(x, tuple) else [x]
    return out


def _assert_same(got, want):
    for x, y in zip(_tensors(got), _tensors(want)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("n_rigs,t", [(None, 3), (4, 2)],
                         ids=["quad-720p-T3", "fleet-4-rigs-720p-T2"])
def test_pipelined_equals_sequential_at_720p(cuda, n_rigs, t):
    """FE on one stream and FM on another, yet every field bit-equal to
    the sequential schedule, in the same 3T launches (3T + 1
    localized)."""
    scene = scenes.SceneConfig(height=720, width=1280, n_points=1600)
    if n_rigs is None:
        seq = scenes.render_sequence(scene, t)
        frames, entry = torch.from_numpy(seq.frames).to(cuda), "run"
    else:
        seq = scenes.render_fleet_sequence(scene, t, n_rigs)
        frames, entry = torch.from_numpy(seq.frames).to(cuda), "run_fleet"
    for localize in (False, True):
        vs = [VisualSystem(RigConfig.quad(seq.intrinsics),
                           PipelineConfig(schedule=s, localize=localize))
              for s in ("sequential", "pipelined")]
        want = getattr(vs[0], entry)(frames)
        with ops.launch_audit() as audit:
            got = getattr(vs[1], entry)(frames)
            torch.cuda.synchronize()
        assert audit.count == 3 * t + localize
        if localize:
            _assert_same(got.stereo, want.stereo)
            assert torch.equal(got.points, want.points)
            assert torch.equal(got.pose.inliers, want.pose.inliers)
            assert torch.equal(got.pose.valid, want.pose.valid)
            for a, b in ((got.pose.rotation, want.pose.rotation),
                         (got.pose.translation, want.pose.translation)):
                assert torch.allclose(a, b, rtol=0, atol=1e-5)
        else:
            _assert_same(got, want)


def test_pipelined_fe_and_fm_run_on_two_streams(cuda):
    """In a profiler trace of a pipelined ``run``, the dense and sparse
    FE kernels (K1, K2) and the fused matcher (K3) run on distinct
    streams."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    frames, intr = _fleet_frames(1)
    cfg = ORBConfig(height=96, width=128, max_features=64, max_disparity=64)
    vs = VisualSystem(RigConfig.quad(intr),
                      PipelineConfig(orb=cfg, schedule="pipelined"))
    seq = torch.from_numpy(np.concatenate([frames[:, 0]] * 3)).to(cuda)
    vs.run(seq)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vs.run(seq)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    streams = {sym: {ev["args"]["stream"] for ev in events
                     if ev.get("cat") == "kernel" and sym in ev["name"]}
               for sym in ("frontend_kernel", "describe_kernel",
                           "match_kernel")}
    fe_streams = streams["frontend_kernel"] | streams["describe_kernel"]
    assert fe_streams and streams["match_kernel"]
    assert not fe_streams & streams["match_kernel"]
    assert vs._streams is not None


@pytest.mark.parametrize("refine,iters", [(True, 3), (False, 1), (True, 6)],
                         ids=["slam", "vio", "registration"])
def test_backend_on_the_card_matches_the_cpu(cuda, refine, iters):
    """``estimate_relative_pose`` on the card against the CPU on the same
    points with gross outliers: R and t within 1e-4 and the inliers
    equal (the tests' VO tolerance); ``triangulate`` bit-equal."""
    from repro_torch.core import backend
    from repro_torch.core.types import (CameraIntrinsics, DepthSet,
                                        FeatureSet)
    rng = np.random.RandomState(5)
    k = 200
    intr = CameraIntrinsics(fx=300.0, fy=300.0, cx=160.0, cy=120.0)
    pts = np.stack([rng.uniform(-1, 1, k), rng.uniform(-1, 1, k),
                    rng.uniform(3, 8, k)], 1).astype(np.float32)
    ang = 0.03
    rot = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    cur = (pts @ rot.T + np.asarray([0.1, 0.0, -0.05], np.float32)).astype(
        np.float32)
    xy = np.stack([300 * cur[:, 0] / cur[:, 2] + 160,
                   300 * cur[:, 1] / cur[:, 2] + 120], 1).astype(np.float32)
    cur[:20] += rng.uniform(2, 4, (20, 3)).astype(np.float32)
    w = (rng.rand(k) > 0.1).astype(np.float32)
    args = [torch.from_numpy(x) for x in (pts, cur, w, xy)]
    want = backend.estimate_relative_pose(*args, intr, refine=refine,
                                          robust_iters=iters)
    got = backend.estimate_relative_pose(*(a.to(cuda) for a in args), intr,
                                         refine=refine, robust_iters=iters)
    assert int(got.inliers) == int(want.inliers)
    for a, b in ((got.rotation, want.rotation),
                 (got.translation, want.translation)):
        assert torch.allclose(a.cpu(), b, rtol=0, atol=1e-4)
    z = torch.from_numpy(pts[:, 2].copy())
    feats = FeatureSet(torch.from_numpy(xy), torch.zeros(k, dtype=torch.int32),
                       z, z, torch.zeros(k, 8, dtype=torch.int32),
                       torch.ones(k, dtype=torch.bool))
    depth = DepthSet(z, z, torch.from_numpy(xy),
                     torch.ones(k, dtype=torch.bool))
    on_card = backend.triangulate(
        map_fields(lambda x: x.to(cuda), feats),
        map_fields(lambda x: x.to(cuda), depth), intr)
    assert torch.equal(on_card.cpu(), backend.triangulate(feats, depth, intr))


# -- the serving tier --------------------------------------------------------------

SERVE_DT = 1.0 / 30.0
SERVE_SPECS = [dict(kind="dead_camera", rig=1, camera=3),
               dict(kind="corrupt_frame", rig=2, start=1, stop=3, camera=0),
               dict(kind="desync", rig=3, camera=1, magnitude=0.5),
               dict(kind="stalled_rig", rig=4, start=1),
               dict(kind="arrival_jitter", rig=5, magnitude=0.3 * SERVE_DT)]


def _serve(device, localize=False):
    """The fault episode (a dead camera, a corrupt frame, desync, a
    stall healed by the restart hook and arrival jitter, each on its own
    rig of 6) at 96 x 128 on a session on ``device``: (result, the
    launches counted during it, the service)."""
    from repro_torch import serving
    seq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=96, width=128, n_points=300, baseline=0.3), 4, 6)
    cfg = ORBConfig(height=96, width=128, max_features=64, max_disparity=64)
    vs = VisualSystem(RigConfig.quad(seq.intrinsics, desync_policy="degrade",
                                     max_desync=1e-3),
                      PipelineConfig(orb=cfg, localize=localize), device)
    inj = serving.FaultInjector([serving.FaultSpec(**s) for s in SERVE_SPECS],
                                seed=9)
    svc = serving.FleetService(
        vs, serving.QueueConfig(),
        serving.SupervisorConfig(heartbeat_timeout_s=2.5 * SERVE_DT,
                                 backoff_base_s=SERVE_DT,
                                 backoff_max_s=4 * SERVE_DT,
                                 restart_budget=2, flap_window_s=1.0),
        inj.clear_rig)
    with ops.launch_audit() as audit:
        res = serving.run_episode(svc, np.round(seq.frames), dt=SERVE_DT,
                                  injector=inj, settle_steps=4)
        if device != "cpu":
            torch.cuda.synchronize()
    return res, audit.count, svc


def _hold_card_vs_cpu(got, want):
    """A card ``StereoOutput`` against the CPU's on the same integer
    frames: xy, level, score and valid bit-equal, theta within 2 ulp
    (the card's ``atan2f`` against the CPU's), descriptors equal away
    from a steering-bin edge; matches and depth equal where no
    descriptor differs.  Returns the number of descriptors that
    differ."""
    got = map_fields(lambda x: x.cpu(), got)
    n_diff = 0
    for side in ("features_l", "features_r"):
        fg, fc = getattr(got, side), getattr(want, side)
        for name in ("xy", "level", "score", "valid"):
            assert torch.equal(getattr(fg, name), getattr(fc, name)), name
        assert ulp_diff(fg.theta.numpy(), fc.theta.numpy()).max(initial=0) <= 2
        edge = near_bin_edge(fc.theta.numpy(),
                             4.0 * np.spacing(np.abs(fc.theta.numpy())))
        diff = (fg.desc != fc.desc).any(-1).numpy()
        assert not (diff & ~edge).any()
        n_diff += int(diff.sum())
    if n_diff == 0:
        _assert_same(got.matches, want.matches)
        _assert_same(got.depth, want.depth)
    return n_diff


@pytest.mark.parametrize("localize", [False, True])
def test_fault_episode_on_the_card_equals_the_cpu(cuda, localize):
    """The same fault episode on a card session and a CPU session: equal
    events, status and report metadata (they depend only on the specs
    and the clock), 3 launches a served batch (4 localized), and every
    served output equal to the CPU's by the card-against-CPU rule.  A
    localized rig whose descriptors have matched the CPU's on every
    frame so far has the CPU's inliers and a pose within 1e-4."""
    card, launches, svc = _serve("cuda", localize)
    cpu, _, _ = _serve("cpu", localize)
    assert [tuple(e) for e in card.events] == [tuple(e) for e in cpu.events]
    assert card.status == cpu.status
    meta = [[(r.rig_id, r.t, r.t_arrival, r.status, r.camera_mask.tolist(),
              r.late) for r in res.reports] for res in (card, cpu)]
    assert meta[0] == meta[1]
    assert launches == svc.counters["batches"] * (3 + localize) > 0
    assert {(4, "restart")} <= {(e.rig_id, e.kind) for e in card.events}
    diverged, held = set(), 0
    for got, want in zip(card.reports, cpu.reports):
        assert got.output.features_l.xy.device.type == "cuda"
        if not localize:
            _hold_card_vs_cpu(got.output, want.output)
            continue
        if _hold_card_vs_cpu(got.output.stereo, want.output.stereo):
            diverged.add(got.rig_id)
        pg, pc = (map_fields(lambda x: x.cpu(), got.output.pose),
                  want.output.pose)
        assert torch.isfinite(pg.translation).all()
        assert bool(pg.valid) == bool(pc.valid)
        if got.rig_id in diverged:
            continue
        assert int(pg.inliers) == int(pc.inliers)
        for name in ("rotation", "translation"):
            assert torch.allclose(getattr(pg, name), getattr(pc, name),
                                  rtol=0, atol=1e-4), name
        held += int(pc.valid)
    assert not localize or held > 0


@pytest.mark.parametrize("localize", [False, True])
def test_card_wire_payloads_equal_cpu_encoding(cuda, localize):
    """``wire_encode`` of every served card output is byte-identical to
    ``wire_encode`` of the same output moved to the CPU (the quantizer
    divides tensor by tensor on the card), and the lossless fields
    round-trip on the card bit for bit."""
    from repro_torch import serving
    card, _, _ = _serve("cuda", localize)

    def same(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for key in b:
                same(a[key], b[key])
        elif isinstance(b, torch.Tensor):
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert a.cpu().numpy().tobytes() == b.numpy().tobytes()
        else:
            assert a == b

    for rep in card.reports:
        wire = serving.wire_encode(rep.output)
        same(wire, serving.wire_encode(map_fields(lambda x: x.cpu(),
                                                  rep.output)))
        back = serving.wire_decode(wire)
        stereo = back.stereo if localize else back
        src = rep.output.stereo if localize else rep.output
        for name in ("desc", "level", "valid"):
            assert torch.equal(getattr(stereo.features_l, name),
                               getattr(src.features_l, name))
        _assert_same(stereo.matches, src.matches)
        if localize:
            assert torch.equal(back.points, rep.output.points)
            _assert_same(back.pose, rep.output.pose)


# -- failover and snapshots ----------------------------------------------------------

def test_guarded_step_launches_on_the_callers_stream(cuda):
    """A guarded step inside a non-default stream: the worker thread runs
    on the caller's device and stream, the caller's ``launch_audit``
    counts its 3 launches, as many as an unguarded step's, and the
    reports are bit-equal."""
    from repro_torch import serving
    seq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=96, width=128, n_points=300, baseline=0.3), 1, 2)
    cfg = ORBConfig(height=96, width=128, max_features=64, max_disparity=64)
    vs = VisualSystem(RigConfig.quad(seq.intrinsics),
                      PipelineConfig(orb=cfg), "cuda")
    guard = serving.DispatchGuard(serving.DispatchGuardConfig(timeout_s=120.0))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        out = guard.run("stream", torch.cuda.current_stream)
    assert out.ok and out.value == side
    results = []
    for g in (None, guard):
        svc = serving.FleetService(vs, serving.QueueConfig(), guard=g)
        for r in range(2):
            svc.submit(r, np.round(seq.frames[0, r]), 0.0)
        with torch.cuda.stream(side), ops.launch_audit() as audit:
            reports = svc.step(1.0, force=True)
        side.synchronize()
        results.append((audit.count, reports))
    (n0, plain), (n1, guarded) = results
    assert n0 == n1 == 3
    for a, b in zip(guarded, plain):
        _assert_same(a.output, b.output)


def _kill_and_recover(device, tmp_path, torn: bool):
    """The localized fault-free episode at 96 x 128 with snapshots every
    tick and a crash after tick 1 (with a torn newest snapshot when
    ``torn``): (result, launches counted during it, batches served:
    one a service step that reported)."""
    from repro_torch import serving
    seq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=96, width=128, n_points=300, baseline=0.3), 4, 3)
    cfg = ORBConfig(height=96, width=128, max_features=64, max_disparity=64)
    vs = VisualSystem(RigConfig.quad(seq.intrinsics),
                      PipelineConfig(orb=cfg, localize=True), device)
    def fresh():
        return serving.FleetService(vs, serving.QueueConfig())

    inj = serving.FaultInjector(
        [serving.FaultSpec("corrupt_snapshot", start=1)] if torn else [],
        seed=11)
    with ops.launch_audit() as audit:
        res = serving.run_episode(fresh(), np.round(seq.frames),
                                  dt=SERVE_DT, injector=inj, settle_steps=4,
                                  snapshot_dir=str(tmp_path / device),
                                  crash_at=1, restore=fresh)
        if device != "cpu":
            torch.cuda.synchronize()
    return res, audit.count, len({r.t for r in res.reports})


@pytest.mark.parametrize("torn", [False, True])
def test_kill_and_recover_on_the_card_equals_the_cpu(cuda, tmp_path, torn):
    """Kill and recover on a card session and a CPU session: equal
    events, status, recovery record (less its wall clock) and report
    metadata; 4 launches a served batch; the restored service's first
    report of each rig is identity with ``valid=False``."""
    card, launches, batches = _kill_and_recover("cuda", tmp_path, torn)
    cpu, _, _ = _kill_and_recover("cpu", tmp_path, torn)
    assert [tuple(e) for e in card.events] == [tuple(e) for e in cpu.events]
    assert card.status == cpu.status
    strip = [{k: v for k, v in r.recovery.items() if k != "recovery_wall_s"}
             for r in (card, cpu)]
    assert strip[0] == strip[1]
    assert strip[0]["restored_step"] == (0 if torn else 1)
    assert [(r.rig_id, r.t, r.t_arrival, r.status) for r in card.reports] == \
        [(r.rig_id, r.t, r.t_arrival, r.status) for r in cpu.reports]
    assert launches == 4 * batches > 0
    crash_time = 1.5 * SERVE_DT + 1e-9
    first = {}
    for r in card.reports:
        if r.t > crash_time:
            first.setdefault(r.rig_id, r)
    assert len(first) == 3
    for r in first.values():
        assert not bool(r.output.pose.valid.any())
