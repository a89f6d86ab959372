"""Time one checkout's redesigned kernels and its frame on the card.

    python3 tools/kernel_turns.py ROOT [LABEL]

imports ``repro_torch`` from ``ROOT/src`` (building ROOT's kernels there
at first use) and renders ``chip_smoke.py``'s 720p quad scene and its
``textured_frames``.  On the scene (rounded to integers) and on each
textured frame, float and uint8, it holds the dense FE (K1), the sparse
FE (K2) and the fused matcher (K3) to their plain versions and times
them (``chip_smoke.check_dense``, ``check_sparse``, ``check_matcher``:
CUDA events and device ms under ``torch.profiler``); then the per-level
sparse FE (K7) on the scene's level 0 and the match-only matcher (K4) on
the inputs a localized frame gives it (the second frame of a rendered
sequence); the host time to issue one K1 launch (median of FRAMES calls
back to back); ``process_frame`` on the scene (median of FRAMES frames,
host clock around the call and a synchronize), its device busy time a
frame and each kernel's device ms inside the frame, and the same device
times for a uint8 session's frame (the scene rounded to uint8).  It
prints one JSON line.

To compare two checkouts, unpack each (``git archive``) and run this
script from one of them on each in turns, one process a turn, on the
same card: parent, change, change, parent, ...  The helpers come from
the ``chip_smoke.py`` beside this directory; only ``repro_torch`` comes
from ROOT.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

FRAMES = 100
KEYS = ("ms", "device_ms", "bound_ms")
# Kernels whose device ms inside a frame are reported, by symbol.
FRAME_SYMBOLS = ("frontend_kernel", "describe_kernel", "match_kernel")


def main(argv: list[str]) -> int:
    root = os.path.abspath(argv[1])
    label = argv[2] if len(argv) > 2 else os.path.basename(root)
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch  # noqa: F401  (ROOT's package, before chip_smoke's)
    if not repro_torch.__file__.startswith(root):
        raise RuntimeError(f"repro_torch not imported from {root}")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    import numpy as np
    import torch
    from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                                  VisualSystem, fast, pyramid)
    from repro_torch.data import scenes
    from repro_torch.kernels import _build, match_fused, ops
    from repro_torch.kernels import describe_fused as de
    from repro_torch.kernels import frontend_fused as fe

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    cfg = ORBConfig()
    frame, intr = scenes.render_frame(scenes.SceneConfig(
        height=cfg.height, width=cfg.width, n_points=1600, seed=0))
    frames = {"scene": np.round(frame).astype(np.float32),
              **cs.textured_frames(frame)}
    dense, sparse, matcher = {}, {}, {}
    for name, img in frames.items():
        images = torch.from_numpy(img).to(dev)
        for variant, prec, x in (("f32", "f32", images),
                                 ("u8", "uint8", images.to(torch.uint8))):
            what = f"{name}_{variant}"
            levels = pyramid.build_pyramid_batched(x, cfg, precision=prec)
            st = cs.check_dense(levels, cfg, what)
            dense[what] = {k: st[k] for k in KEYS + ("fast_live_share",)}
            blurs = ops.fast_blur_nms_pyramid(
                levels, float(cfg.fast_threshold), nms=cfg.nms,
                quantized=cfg.quantized)
            st, _ = cs.check_sparse(levels, blurs, cfg, what, True)
            sparse[what] = {k: st[k] for k in KEYS}
            st = cs.check_matcher(images, cfg, intr, what, pixels=x)
            matcher[what] = {k: st[k] for k in KEYS}

    # K7 on the scene's level 0, float
    scene = torch.from_numpy(frames["scene"]).to(dev)
    levels = pyramid.build_pyramid_batched(scene, cfg)
    blurs = ops.fast_blur_nms_pyramid(levels, float(cfg.fast_threshold),
                                      nms=cfg.nms, quantized=cfg.quantized)
    xy0 = fast.select_topk(blurs[0][1], cfg.features_per_level()[0],
                           cfg.border)[0].contiguous()
    sm0 = blurs[0][0]

    def k7():
        return de.describe_fused_cuda(levels[0], sm0, xy0)
    k7_level0 = dict(ms=cs.time_ms(k7),
                     device_ms=cs.device_ms(k7, "describe_level_kernel"),
                     bound_ms=cs.sparse_bound([(levels[0], xy0)])[0])

    # K4 on a localized frame's temporal rows
    seq = scenes.render_sequence(scenes.SceneConfig(
        height=cfg.height, width=cfg.width, n_points=1600, seed=0), 2)
    vs_loc = VisualSystem(RigConfig.quad(seq.intrinsics),
                          PipelineConfig(orb=cfg, localize=True),
                          device="cuda")
    seq_frames = torch.from_numpy(seq.frames).to(dev)
    with cs.recorded(match_fused) as k4:
        for t in range(2):
            vs_loc.process_frame(seq_frames[t])
    st = cs.check_match_only(*k4[-1][:2], "temporal, localized frame 720p")
    k4_localized = {k: st[k] for k in KEYS}

    # Host time to issue one K1 launch on the scene's float levels,
    # calls back to back with no synchronize between them.
    flat, slabs = ops.flat_levels(levels), ops._slabs_of(levels)
    kw = dict(threshold=float(cfg.fast_threshold), nms=cfg.nms,
              quantized=cfg.quantized)
    fe.frontend_fused_pyramid_cuda(flat, slabs, **kw)
    torch.cuda.synchronize()
    issue_us = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        fe.frontend_fused_pyramid_cuda(flat, slabs, **kw)
        issue_us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()

    vs = VisualSystem(RigConfig.quad(intr), PipelineConfig(), device="cuda")
    images = torch.from_numpy(frame).to(dev)
    for _ in range(3):
        vs.process_frame(images)
    torch.cuda.synchronize()
    frame_ms = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        vs.process_frame(images)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    prof = cs.profile_frames(vs, images)
    in_frame = {sym: sum(ms for key, ms in prof.items() if sym in key)
                for sym in FRAME_SYMBOLS}
    # the uint8 datapath's frame: the scene rounded to uint8
    vs_u8 = VisualSystem(RigConfig.quad(intr),
                         PipelineConfig(precision="uint8"), device="cuda")
    images_u8 = scene.to(torch.uint8)
    for _ in range(3):
        vs_u8.process_frame(images_u8)
    prof_u8 = cs.profile_frames(vs_u8, images_u8)
    in_frame_u8 = {sym: sum(ms for key, ms in prof_u8.items() if sym in key)
                   for sym in FRAME_SYMBOLS}
    print(json.dumps({
        "label": label, "card": cs.card_line(), "dense": dense,
        "sparse": sparse, "matcher": matcher, "k7_level0": k7_level0,
        "k4_localized": k4_localized,
        "k1_issue_us_median": statistics.median(issue_us),
        "frame_ms_median": statistics.median(frame_ms),
        "frame_ms_min": min(frame_ms), "frame_ms_max": max(frame_ms),
        "frame_device_busy_ms": sum(prof.values()),
        "frame_kernel_device_ms": in_frame,
        "u8_frame_device_busy_ms": sum(prof_u8.values()),
        "u8_frame_kernel_device_ms": in_frame_u8}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
