"""Time one checkout's dense FE (K1, float and uint8) and frame on the card.

    python3 tools/dense_turns.py ROOT [LABEL]

imports ``repro_torch`` from ``ROOT/src`` (building ROOT's kernels there
at first use), renders ``chip_smoke.py``'s 720p quad scene and its
``textured_frames``, holds K1 and K1-u8 to their plain versions on each
frame and times them (``chip_smoke.check_dense``: CUDA events and device
ms under ``torch.profiler``), the host time to issue one K1 launch
(median of FRAMES calls back to back), then times ``process_frame`` on
the scene (median of FRAMES frames, host clock around the call and a
synchronize) and its device busy time a frame.  It prints one JSON line.

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
                                  VisualSystem, pyramid)
    from repro_torch.data import scenes
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import frontend_fused as fe

    if not torch.cuda.is_available():
        print("dense_turns: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    cfg = ORBConfig()
    frame, intr = scenes.render_frame(scenes.SceneConfig(
        height=cfg.height, width=cfg.width, n_points=1600, seed=0))
    keys = ("ms", "device_ms", "bound_ms", "fast_live_share")
    dense = {}
    scene = torch.from_numpy(np.round(frame)).to(dev)
    for variant, prec, x in (("f32", "f32", scene),
                             ("u8", "uint8", scene.to(torch.uint8))):
        levels = pyramid.build_pyramid_batched(x, cfg, precision=prec)
        st = cs.check_dense(levels, cfg, f"scene {variant}")
        dense[f"scene_{variant}"] = {k: st[k] for k in keys}
    for name, st in cs.check_dense_textured(frame, cfg, dev).items():
        dense[name] = {k: st[k] for k in keys}

    # Host time to issue one K1 launch on the scene's float levels,
    # calls back to back with no synchronize between them.
    levels = pyramid.build_pyramid_batched(scene, cfg)
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
    busy = sum(cs.profile_frames(vs, images).values())
    print(json.dumps({
        "label": label, "card": cs.card_line(), "dense": dense,
        "k1_issue_us_median": statistics.median(issue_us),
        "frame_ms_median": statistics.median(frame_ms),
        "frame_ms_min": min(frame_ms), "frame_ms_max": max(frame_ms),
        "frame_device_busy_ms": busy}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
