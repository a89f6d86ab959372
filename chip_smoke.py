"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``).  It imports
nothing of jax or of the JAX package.  Phases, each of which raises on
failure (the script then exits non-zero and prints no result):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every hand-written kernel from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, in parallel) and print the seconds taken;
  3. hold each kernel (dense FE, sparse FE, fused matcher) against its
     plain PyTorch version on the card, at the main path's shapes, on a
     720p quad scene — once with integer-valued frames (as a uint8
     camera delivers them) and once with the float frames as rendered —
     and time both with CUDA events (median of 20 runs after warm-up);
  4. drive ``VisualSystem.process_frame`` on a 4 x 720 x 1280 quad frame
     at the paper's configuration (``PipelineConfig()`` defaults) with
     every launch count set to 0 just before: exactly one launch of each
     kernel (3 in all), finite outputs of the expected shapes, valid
     depths on both pairs; then the median frame latency over 20
     frames, each stage's median time, a profile of device time by
     kernel with the device's idle share; and the card's session
     against the CPU session (plain versions) on a small integer-valued
     frame;
  5. print the kernels' JSON line, then ``{"ok": true, "device": ...}``
     as the last line.

Tolerances: integer and bool outputs, blur and score are bit-equal.
theta and the moments are equal on integer-valued frames (every sum is
an integer below 2**24, so exact in any order) with theta within 1 ulp
(atan2); on float frames the moment sums run in another order, so each
moment is held to 2 * gamma_961 * sum|x * p| (the worst-case float32
summation error of two 961-term sums, gamma_n = n u / (1 - n u)), and
theta to atan2 of the kernel's own moments within 1 ulp.  Descriptors
are equal wherever the two steering bins agree; the bins may differ only
for keypoints whose theta lies within the theta difference (4 ulp on
integer frames) of a bin edge, and that count is printed.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and float32
# rate outside the tensor cores; the kernels' bounds are taken against
# them, beside the card's power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each timed
    with CUDA events, after two warm-up runs."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max().item()) if ia.numel() else 0


def near_bin_edge(theta: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """Keypoints whose theta lies within ``tol`` (radians) of a bin edge
    (edges at (k + 1/2) * 30 degrees)."""
    from repro_torch.kernels.ref import INV_ANGLE_STEP
    t = theta.double() * INV_ANGLE_STEP
    dist = (t - (torch.floor(t) + 0.5)).abs() / INV_ANGLE_STEP
    return dist <= tol.double()


def footprint(shape_hw, xs, ys, kh: int, kw: int, device) -> int:
    """Pixels of an (h, w) image covered by (kh, kw) windows centered at
    the (already clamped) integer centers — what a kernel must read."""
    h, w = shape_hw
    m = torch.zeros((1, 1, h, w), device=device)
    m[0, 0, ys.long(), xs.long()] = 1.0
    cover = F.max_pool2d(m, (kh, kw), stride=1, padding=(kh // 2, kw // 2))
    return int(cover.sum().item())


# Float operations a pixel of the dense FE needs, counted on the JAX
# package's algorithm: blur 2 x (7 mul + 6 add) + add, div, floor (29);
# FAST 16 tap differences + van Herk arc extrema (42 + 42 + 28) + 30
# running max/min + 2 + threshold 2 (162); separable NMS 4 max + 3 (7).
DENSE_OPS_PER_PIXEL = 29 + 162 + 7
# Sparse FE a keypoint: 709 masked pixels x (2 mul + 2 add), atan2
# (~20), bin (4), 256 compares.
SPARSE_OPS_PER_KP = 709 * 4 + 20 + 4 + 256


def check_dense(levels, cfg, kind: str):
    from repro_torch.kernels import frontend_fused as fe, ops
    flat = ops.flat_levels(levels)
    slabs = ops._slabs_of(levels)
    kw = dict(threshold=float(cfg.fast_threshold), nms=cfg.nms,
              quantized=cfg.quantized)
    blur_k, score_k = fe.frontend_fused_pyramid_cuda(flat, slabs, **kw)
    blur_p, score_p = fe.frontend_fused_pyramid_plain(flat, slabs, **kw)
    torch.cuda.synchronize()
    nb = int((blur_k != blur_p).sum())
    ns = int((score_k != score_p).sum())
    err = max(float((blur_k - blur_p).abs().max()),
              float((score_k - score_p).abs().max()))
    log(f"[dense FE/{kind}] blur mismatches {nb}, score mismatches {ns} "
        f"of {flat.numel()}")
    if nb or ns:
        raise AssertionError(f"dense FE kernel disagrees on {kind} frames")
    stats = dict(
        ms=time_ms(lambda: fe.frontend_fused_pyramid_cuda(flat, slabs, **kw)),
        plain_ms=time_ms(lambda: fe.frontend_fused_pyramid_plain(
            flat, slabs, **kw)),
        max_abs_err=err)
    n = flat.numel()
    stats["bound_ms"], stats["bound_by"] = bound_ms(
        n * 4 + 2 * n * 4, n * DENSE_OPS_PER_PIXEL)
    return stats


def check_sparse(levels, dense, cfg, kind: str, integer: bool):
    from repro_torch.core import fast
    from repro_torch.kernels import describe_fused as de, ops
    from repro_torch.kernels.ref import INV_ANGLE_STEP
    ks = cfg.features_per_level()
    xys = [fast.select_topk(sc, k, cfg.border)[0]
           for (_, sc), k in zip(dense, ks)]
    raw = ops.flat_levels(levels)
    sm = ops.flat_levels([b for b, _ in dense])
    slabs = ops._slabs_of(levels)
    xy = torch.cat(xys, dim=1).contiguous()
    col = ops._col_levels(tuple(ks), str(xy.device))
    th_k, mom_k, desc_k = de.describe_fused_pyramid_cuda(raw, sm, slabs, xy,
                                                         col)
    th_p, mom_p, desc_p = de.describe_fused_pyramid_plain(raw, sm, slabs, xy,
                                                          col)
    torch.cuda.synchronize()
    bins_k = torch.remainder(torch.round(th_k * INV_ANGLE_STEP).long(), 12)
    bins_p = torch.remainder(torch.round(th_p * INV_ANGLE_STEP).long(), 12)
    # theta of the kernel is atan2 of its own moments, within 1 ulp
    own = torch.atan2(mom_k[..., 1], mom_k[..., 0])
    if ulps(th_k, own) > 1:
        raise AssertionError("sparse FE theta is not atan2 of its moments")
    dmom = (mom_k - mom_p).abs()
    if integer:
        if bool((dmom != 0).any()) or ulps(th_k, th_p) > 1:
            raise AssertionError(
                "sparse FE moments/theta disagree on integer-valued frames")
        tol = 4.0 * torch.from_numpy(np.spacing(
            np.abs(th_p.cpu().numpy()))).to(th_p.device)
    else:
        from repro_torch.kernels.describe_fused import _slab_patches
        from repro_torch.kernels.ref import moment_grids
        b = xy.shape[0]
        slab = col.long()[None, :] * b + torch.arange(
            b, device=xy.device)[:, None]
        p = _slab_patches(raw, slab, slabs.table, xy)
        xg, yg = moment_grids(p.device)
        s_abs = torch.stack([(p * xg).abs().sum((-2, -1)),
                             (p * yg).abs().sum((-2, -1))], -1)
        u = 2.0 ** -24
        gamma = 961 * u / (1 - 961 * u)
        if bool((dmom > 2 * gamma * s_abs).any()):
            raise AssertionError("sparse FE moments exceed the float "
                                 "summation bound on float frames")
        hyp = torch.hypot(mom_p[..., 0], mom_p[..., 1]).clamp(min=1e-30)
        tol = (dmom.sum(-1) / hyp) * 1.01 + 4.0 * torch.from_numpy(
            np.spacing(np.abs(th_p.cpu().numpy()))).to(th_p.device)
    edge = near_bin_edge(th_p, tol)
    bins_differ = bins_k != bins_p
    if bool((bins_differ & ~edge).any()):
        raise AssertionError("sparse FE steering bins differ away from a "
                             "bin edge")
    desc_bad = (desc_k != desc_p).any(-1) & ~bins_differ
    if bool(desc_bad.any()):
        raise AssertionError("sparse FE descriptors differ where the bins "
                             "agree")
    err = float(dmom.max().item())
    log(f"[sparse FE/{kind}] {xy.shape[0] * xy.shape[1]} keypoints: max "
        f"|d moment| {err}, max theta diff {ulps(th_k, th_p)} ulp, "
        f"{int(edge.sum())} keypoints within the theta tolerance of a bin "
        f"edge, {int(bins_differ.sum())} bins differ, descriptors equal "
        "wherever bins agree")
    stats = dict(
        ms=time_ms(lambda: de.describe_fused_pyramid_cuda(raw, sm, slabs, xy,
                                                          col)),
        plain_ms=time_ms(lambda: de.describe_fused_pyramid_plain(
            raw, sm, slabs, xy, col)),
        max_abs_err=err)
    px = 0
    for lv, x_l in zip(levels, xys):
        h, w = lv.shape[1:]
        for cam in range(lv.shape[0]):
            xc = x_l[cam, :, 0].clamp(0, w - 1)
            yc = x_l[cam, :, 1].clamp(0, h - 1)
            px += footprint((h, w), xc, yc, 31, 31, lv.device)
    n_kp = xy.shape[0] * xy.shape[1]
    stats["bound_ms"], stats["bound_by"] = bound_ms(
        2 * px * 4 + n_kp * (8 + 4 + 44) + 12 * 256 * 2 * 4,
        n_kp * SPARSE_OPS_PER_KP)
    return stats, xys


def check_matcher(images, cfg, intr, kind: str):
    from repro_torch.core import matching, orb
    from repro_torch.core.types import map_fields
    from repro_torch.kernels import matcher_fused as mf
    from repro_torch.kernels.hamming_match import masked_hamming
    feats = orb.extract_features_batched(images, cfg)
    li = torch.tensor([0, 2], device=images.device)
    ri = torch.tensor([1, 3], device=images.device)
    fl = map_fields(lambda x: x[li], feats)
    fr = map_fields(lambda x: x[ri], feats)
    args = (fl.desc.contiguous(), matching._meta(fl).contiguous(),
            fr.desc.contiguous(), matching._meta(fr).contiguous(),
            images[li].contiguous(), images[ri].contiguous())
    kw = dict(row_band=float(cfg.row_band),
              max_disparity=float(cfg.max_disparity),
              max_hamming=int(cfg.max_hamming), sad_window=cfg.sad_window,
              sad_range=cfg.sad_range)
    out_k = mf.match_rectify_fused_cuda(*args, **kw)
    out_p = mf.match_rectify_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    names = ("dist", "idx", "rxy", "sad")
    bad = {n: int((a != b).sum()) for n, a, b in zip(names, out_k, out_p)}
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(out_k, out_p))
    log(f"[matcher/{kind}] mismatches {bad}; "
        f"{int((out_k[1] >= 0).sum())} candidates found")
    if any(bad.values()):
        raise AssertionError(f"fused matcher disagrees on {kind} frames")
    stats = dict(ms=time_ms(lambda: mf.match_rectify_fused_cuda(*args, **kw)),
                 plain_ms=time_ms(lambda: mf.match_rectify_fused_plain(
                     *args, **kw)),
                 max_abs_err=err)
    p, k = args[1].shape[0], args[1].shape[1]
    m = args[3].shape[1]
    in_region = int((masked_hamming(*args[:4], row_band=kw["row_band"],
                                    max_disparity=kw["max_disparity"])
                     < (1 << 20)).sum())
    h, w = images.shape[1:]
    px = 0
    for q in range(p):
        xl = torch.round(args[1][q, :, 0]).clamp(0, w - 1)
        yl = torch.round(args[1][q, :, 1]).clamp(0, h - 1)
        xr = torch.round(out_k[2][q, :, 0]).clamp(0, w - 1)
        yr = torch.round(out_k[2][q, :, 1]).clamp(0, h - 1)
        px += footprint((h, w), xl, yl, cfg.sad_window, cfg.sad_window,
                        images.device)
        px += footprint((h, w), xr, yr, cfg.sad_window,
                        cfg.sad_window + 2 * cfg.sad_range, images.device)
    sweep = 2 * cfg.sad_range + 1
    n_bytes = p * (k + m) * (32 + 16) + px * 4 + p * k * 20
    n_ops = (p * k * m * 10 + in_region * 26
             + p * k * sweep * cfg.sad_window ** 2 * 3)
    stats["bound_ms"], stats["bound_by"] = bound_ms(n_bytes, n_ops)
    return stats


def stage_times(vs, images, reps: int = REPS):
    """Median host ms of each stage of ``process_frame``, each closed
    by ``torch.cuda.synchronize()`` (so a stage's ms includes its own
    dispatch and device time, not its neighbours')."""
    from repro_torch.core import fast, matching, pyramid
    from repro_torch.core.orb import _level_features, _merge_levels
    from repro_torch.core.types import map_fields
    from repro_torch.kernels import ops
    cfg = vs.pipe.orb
    ks = cfg.features_per_level()
    times = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps + 2):
        levels = step("pyramid", lambda: pyramid.build_pyramid_batched(
            images, cfg))
        dense = step("dense FE (K1)", lambda: ops.fast_blur_nms_pyramid(
            levels, float(cfg.fast_threshold), nms=cfg.nms,
            quantized=cfg.quantized))
        topk = step("top-K", lambda: [
            fast.select_topk(sc, k, cfg.border)
            for (_, sc), k in zip(dense, ks)])
        sparse = step("sparse FE (K2)", lambda: ops.orient_describe_pyramid(
            levels, [b for b, _ in dense], [t[0] for t in topk]))
        feats = step("merge + pair gather", lambda: _merge_levels([
            _level_features(l, cfg, xy, v, ok, th, d)
            for l, ((xy, v, ok), (th, _m, d)) in enumerate(
                zip(topk, sparse))]))
        li, ri = vs._li, vs._ri
        fl = map_fields(lambda x: x[li], feats)
        fr = map_fields(lambda x: x[ri], feats)
        step("FM (K3) + depth", lambda: matching.match_pair_fused(
            images[li], images[ri], fl, fr, cfg, vs._intr))
    return {k: statistics.median(v[2:]) for k, v in times.items()}


def profile_frames(vs, images, n: int = 5) -> dict:
    """Device time by kernel over ``n`` frames (torch.profiler) and the
    device's idle share of the frame.  Returns {kernel name: device ms
    per frame}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            vs.process_frame(images)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = (getattr(e, "self_device_time_total", 0)
               or getattr(e, "self_cuda_time_total", 0))
        if dev > 0:
            rows.append((dev / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("[profile] the profiler recorded no device time")
        return {}
    log(f"[profile] wall {wall:.4f} ms/frame, device busy {busy:.4f} "
        f"ms/frame, idle share {1 - busy / wall:.4f}, "
        f"{sum(r[1] for r in rows):.0f} device kernels/frame")
    for ms, cnt, key in rows[:12]:
        log(f"[profile]   {ms:.4f} ms/frame  x{cnt:.0f}  {key[:100]}")
    return {key: ms for ms, _, key in rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs the port on the card only",
              file=sys.stderr)
        return 2
    from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                                  VisualSystem, pyramid)
    from repro_torch.core.orb import features_from_levels
    from repro_torch.core.matching import match_pair_fused
    from repro_torch.core.types import map_fields
    from repro_torch.data import scenes
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind_name = torch.cuda.get_device_name(0)

    # 1. card
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    secs = _build.build_all()
    log(f"[build] {len(_build.BUILD_LOG)} kernels compiled in {secs:.1f} s")
    for stem, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {stem}] {line.strip()}")

    # 3. kernels against their plain versions, 720p quad scene
    cfg = ORBConfig()
    scene = scenes.SceneConfig(height=cfg.height, width=cfg.width,
                               n_points=1600, seed=0)
    frame, intr = scenes.render_frame(scene)
    results = {}
    for kind, integer in (("integer", True), ("float", False)):
        imgs_np = np.round(frame) if integer else frame
        images = torch.from_numpy(imgs_np).to(dev).contiguous()
        levels = pyramid.build_pyramid_batched(images, cfg)
        dense_stats = check_dense(levels, cfg, kind)
        dense = ops.fast_blur_nms_pyramid(levels, float(cfg.fast_threshold),
                                          nms=cfg.nms,
                                          quantized=cfg.quantized)
        sparse_stats, _ = check_sparse(levels, dense, cfg, kind, integer)
        match_stats = check_matcher(images, cfg, intr, kind)
        results[kind] = (dense_stats, sparse_stats, match_stats)
        log(f"[{kind}] dense {dense_stats['ms']:.4f} ms (plain "
            f"{dense_stats['plain_ms']:.4f}), sparse {sparse_stats['ms']:.4f}"
            f" ms (plain {sparse_stats['plain_ms']:.4f}), matcher "
            f"{match_stats['ms']:.4f} ms (plain {match_stats['plain_ms']:.4f})")

    # 4. the main path through the session entry point
    vs = VisualSystem(RigConfig.quad(intr), PipelineConfig(), device="cuda")
    images = torch.from_numpy(frame).to(dev)
    for k in ops.KERNELS.values():
        k.launches = 0
    with ops.launch_audit() as audit:
        out = vs.process_frame(images)
        torch.cuda.synchronize()
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    log(f"[main path] launches {launches}, audit {audit.count}")
    if audit.count != 3 or any(v != 1 for v in launches.values()):
        raise AssertionError("process_frame must launch each kernel once")
    k_feat = cfg.max_features
    for f in (out.features_l, out.features_r):
        if tuple(f.xy.shape) != (2, k_feat, 2) or tuple(f.desc.shape) != (
                2, k_feat, 8):
            raise AssertionError("unexpected feature shapes")
    for t in (out.features_l.xy, out.features_l.theta, out.depth.depth,
              out.depth.disparity, out.depth.xy_right):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite output")
    nf = out.features_l.valid.sum(-1).tolist()
    nm = out.matches.valid.sum(-1).tolist()
    nd = out.depth.valid.sum(-1).tolist()
    z = [float(out.depth.depth[p][out.depth.valid[p]].median()) if nd[p]
         else float("nan") for p in range(2)]
    log(f"[main path] features per pair {nf}, matches {nm}, depths {nd}, "
        f"median depth {z} m")
    if min(nd) < 1:
        raise AssertionError("a stereo pair produced no valid depth")
    frame_ms = []
    for _ in range(3):
        vs.process_frame(images)
    torch.cuda.synchronize()
    for _ in range(REPS):
        t0 = time.perf_counter()
        vs.process_frame(images)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[main path] frame latency median {statistics.median(frame_ms):.4f}"
        f" ms over {REPS} frames (min {min(frame_ms):.4f}, max "
        f"{max(frame_ms):.4f})")

    for name, ms in stage_times(vs, images).items():
        log(f"[stages] {name}: {ms:.4f} ms (median of {REPS})")
    device_ms = profile_frames(vs, images)

    # the card against the CPU plain versions on a small integer frame,
    # both fed the same pyramid levels
    small = ORBConfig(height=96, width=128, max_features=64,
                      max_disparity=64)
    sframe, _ = scenes.render_frame(scenes.SceneConfig(
        height=96, width=128, n_points=300, baseline=0.3))
    levels_cpu = pyramid.build_pyramid_batched(
        torch.from_numpy(np.round(sframe)), small)
    outs = {}
    for d in ("cpu", "cuda"):
        lv = [l.to(d) for l in levels_cpu]
        feats = features_from_levels(lv, small)
        fl = map_fields(lambda x: x[[0, 2]], feats)
        fr = map_fields(lambda x: x[[1, 3]], feats)
        m, dep = match_pair_fused(lv[0][[0, 2]], lv[0][[1, 3]], fl, fr,
                                  small, intr)
        outs[d] = tuple(map_fields(lambda x: x.cpu(), t)
                        for t in (feats, m, dep))
    (fc, mc, dc), (fg, mg, dg) = outs["cpu"], outs["cuda"]
    if ulps(fc.theta, fg.theta) > 1:
        raise AssertionError("card and CPU theta differ by more than 1 ulp")
    edge = near_bin_edge(fc.theta, 4.0 * torch.from_numpy(
        np.spacing(np.abs(fc.theta.numpy()))))
    desc_diff = (fc.desc != fg.desc).any(-1)
    if bool((desc_diff & ~edge).any()):
        raise AssertionError("card and CPU descriptors differ away from a "
                             "bin edge")
    same = [torch.equal(getattr(fc, n), getattr(fg, n))
            for n in ("xy", "level", "score", "valid")]
    if not desc_diff.any():
        same += [torch.equal(a, b) for a, b in zip(list(mc) + list(dc),
                                                   list(mg) + list(dg))]
    if not all(same):
        raise AssertionError("card and CPU sessions disagree on the small "
                             "integer-valued frame")
    log("[small frame] card == CPU plain versions (theta within 1 ulp, "
        f"{int(desc_diff.sum())} descriptors differ at a bin edge"
        f"{'' if not desc_diff.any() else '; matches not compared'})")

    # 5. result lines
    kernels = []
    meta = {
        "frontend_fused_pyramid": (
            "src/repro_torch/kernels/csrc/frontend_fused.cu",
            "src/repro/kernels/frontend_fused.py:276", 0),
        "describe_fused_pyramid": (
            "src/repro_torch/kernels/csrc/describe_fused.cu",
            "src/repro/kernels/describe_fused.py:262", 1),
        "match_rectify_fused": (
            "src/repro_torch/kernels/csrc/matcher_fused.cu",
            "src/repro/kernels/matcher_fused.py:177", 2),
    }
    symbol = {"frontend_fused_pyramid": "frontend_kernel",
              "describe_fused_pyramid": "describe_kernel",
              "match_rectify_fused": "match_kernel"}
    for name, (source, replaces, i) in meta.items():
        st = results["float"][i]
        prof = [ms for key, ms in device_ms.items() if symbol[name] in key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None,
            "ms_integer_frames": results["integer"][i]["ms"],
            "profiled_device_ms": prof[0] if prof else None,
        })
    print(json.dumps({"kernels": kernels,
                      "frame_ms_median": statistics.median(frame_ms)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
