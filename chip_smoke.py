"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``).  It imports
nothing of jax or of the JAX package.  Phases, each of which raises on
failure (the script then exits non-zero and prints no result):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every hand-written kernel from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, in parallel) and print the seconds taken,
     each kernel's registers and spills (``ptxas -v``) and each dense FE
     instantiation's SASS instruction mix (``cuobjdump -sass``: FMNMX,
     IMNMX, VIMNMX, VIMNMX3, LDS);
  3. hold each frame kernel against its plain PyTorch version on the
     card, at the main path's shapes, on a 720p quad scene — once with
     integer-valued frames (as a uint8 camera delivers them) and once
     with the float frames as rendered — and time both with CUDA events
     (median of 20 runs after warm-up): the dense FE (K1), the sparse FE
     (K2) and the fused matcher (K3).  Every bound counts each
     instruction class at its pipe's rate (``bound_ms``), the work that
     depends on the data as this run's data needs it: the dense FE
     family's (K1, K6, K11) FAST arc extrema only on the pixels that pass
     the kernels' exact pre-test, whose count is printed, the matchers'
     search on a row band.  K1, then K2 and K3, float and uint8, also on
     two textured 720p frames (``textured_frames``); K3 and K3-u8 also on
     a crowded row band (``crowded_matcher_args``: every right feature
     inside every left feature's band, equal distances throughout);
     then the device ms of an empty kernel (``csrc/empty.cu``) at one
     warp and at K3's and K2's grids, the practical floor under the
     bounds;
  4. drive ``VisualSystem.process_frame`` on a 4 x 720 x 1280 quad frame
     at the paper's configuration (``PipelineConfig()`` defaults) with
     every launch count set to 0 just before: exactly one launch of each
     frame kernel (3 in all), finite outputs of the expected shapes,
     valid depths on both pairs; then the median frame latency over 20
     frames, each stage's median time, a profile of device time by
     kernel with the device's idle share; and the card's session
     against the CPU session (plain versions) on a small integer-valued
     frame;
  5. the single-image FE API at full width, on the 8 level images of
     phase 4's quad frame (4 cameras x 720 x 1280 and 600 x 1067),
     integer-valued and float: the FAST score map (K11) and the 7x7
     blur (K12, quantized and not) bit-equal to their plain versions
     and to the dense FE's score (after ``nms3``) and blur;
     ``fast.detect`` with k = ``features_per_level()[l]`` exactly 1
     launch of K11 and 1 of orientation only (K8), its xy, score and
     valid equal to the same call on CPU tensors and its moments to
     that call's by the rule below, its theta held by that rule to the
     plain version on the card (atan2 differs between the card's
     library and the CPU's; the largest difference is printed); K8's theta and moments bit-equal to the sparse FE's (K2) on
     the same keypoints, and ``brief.describe(brief.smooth(level))``
     equal to K2's descriptors (``smooth`` 1 launch of K12, ``describe``
     and ``build_pyramid`` none, ``fast.orientations`` 1);
     ``fast.detect`` on level 0 with a 1-level config equal to
     ``extract_features`` (xy and theta); ``extract_features`` exactly 1
     launch of K1 and 1 of K2, equal to the batched extraction.  Then
     K8, K11 and K12 timed (CUDA events, ``torch.profiler``, plain
     version, bound, and for K12 the library call ``F.conv2d``) on the
     level-0 inputs their wrappers received, and the paper's module
     split (resize, FAST, orientation, smoothing, descriptor: Tab. II);
  6. the localized path at full width: a ``render_sequence`` of T = 6
     quad frames at 720p (the renderer's default twist, at most ~35 px
     of motion at 2 m) through ``process_frame`` with
     ``PipelineConfig(localize=True)`` — exactly 4 launches a frame,
     one of each of K1-K4 — and through ``run`` — exactly 3T + 1, with
     the loop's pose ``valid`` and poses within 1e-5; ATE, RPE-t and
     RPE-r against the ground truth under limits set at about twice
     what the card measured, as the JAX package sets its accuracy gates
     (``benchmarks/run.py``, ``table_localization``); the median
     latency of a localized frame, the pose solve's share of it and
     the host synchronisations.  The match-only matcher (K4) is then
     held against its plain version, and timed, on exactly the inputs
     its wrapper received on that path: a localized frame's 2 temporal
     rows and the run's (T - 1) * 2;
  7. the session's matcher entry points at full width: the sequence's
     first frame's features from the card session, on both stereo
     pairs — ``stereo_match``, ``temporal_match`` (to the second
     frame), ``sad_rectify`` (on the card's own stereo matches) and
     ``match_pair``, each one launch with the counts set to 0 just
     before, and each equal to the CPU session on the same inputs;
     then K4 and the SAD-only matcher (K5) against their plain
     versions, timed, on the inputs ``stereo_match`` and
     ``sad_rectify`` gave them, stacked over the two pairs
     (2 x 1000 x 1000 and 2 x 1000 centers);
  8. the unfused Feature Matcher schedule at full width, on phase 7's
     features and both stereo pairs, the frame as rendered and rounded
     to integers: ``stereo_match_unfused`` exactly 1 launch of the
     single-pair Hamming matcher (K9), ``sad_rectify_unfused`` 1 of the
     SAD sweep (K10), ``match_pair_unfused`` 1 of each (counts set to 0
     just before each call); its MatchSet and DepthSet bit-equal to row
     p of ``match_pair_fused`` (K3, the JAX package's own pin), to the
     session's ``stereo_match`` (K4) and ``sad_rectify`` (K5) and to the
     same calls on CPU tensors; K9 and K10 bit-equal to their plain
     versions on every input their wrappers received there, and timed
     (CUDA events, ``torch.profiler``, plain version, bound) on pair
     0's float inputs (1000 x 1000 features, 1000 windows); then the
     legacy ``core.frontend.process_quad_frame`` on phase 4's frame:
     3 launches, a ``DeprecationWarning``, equal to ``process_frame``;
  9. the card's localized session against the CPU session (plain
     versions) on the JAX tests' small sequence (96 x 128, T = 4,
     K = 96, baseline 0.5 m, 0.25 m lateral steps), rounded to integer
     values: the runs' temporal dist/idx and pose ``valid`` equal,
     poses within 1e-4, and both under the JAX tests' ATE/RPE limits
     (0.4 m, 0.25 m, 1.0 deg); the four entry points as in phase 7 on
     the first pair;
  10. the per-level FE schedule at full width, on phase 4's quad frame
      rounded to integers and as rendered: ``extract_features_per_level``
      exactly 2 launches of the per-level dense FE (K6) and 2 of the
      per-level sparse FE (K7), none of K1 or K2, with the counts set
      to 0 just before; its FeatureSet bit-equal to
      ``extract_features_batched`` (K1 + K2: the JAX package's own
      pin) and equal to the same call on CPU tensors (xy, level, score,
      valid bit-equal; moments by the rule below and theta within the
      moment difference carried through atan2 plus 4 ulp, since the two
      atan2 are different libraries; descriptors equal wherever the
      bins agree); K6 bit-equal to its plain version and K7 held to its
      plain version by the sparse FE's rule on every input their
      wrappers received; both timed (CUDA events, ``torch.profiler``,
      plain version, bound) on each level's float inputs, the row's
      own numbers being level 0's;
      then the paper's frame-multiplexing comparison: the host ms of
      either schedule on the float frame (median of 20, each call
      closed by a synchronize), the device ms of its FE kernels and its
      launches (4 against 2);
  11. the uint8 datapath (``PipelineConfig(precision="uint8")``) at full
      width, on phase 4's quad frame and phase 6's sequence rounded to
      uint8: ``process_frame`` exactly 3 launches, each the uint8 variant
      of K1, K2, K3, with every ``StereoOutput`` field bit-equal to a
      quantized-f32 session's on the same integer-valued frame;
      ``extract`` 2, ``match_pair`` 1 (K3) and ``sad_rectify`` 1 (K5) a
      pair, ``fast.detect`` on the 8 uint8 level images 2 (K11 on the
      float cast, K8's uint8 variant), ``extract_features_per_level`` 2
      a level (K6, K7), each equal to the f32 call; the localized
      sequence 4 launches a frame and ``run`` 3T + 1, poses within 1e-5
      of the f32 run's and ATE/RPE under phase 6's limits; every input
      each variant's wrapper received held against its plain version
      (dense, K3 and K5 bit-equal; K2, K7 and K8 by the rule below,
      theta within 1 ulp, one library) and against its float kernel on
      the float copy (bit-equal, theta too: the same ``atan2f`` on the
      same exact moments); each variant and its float kernel timed on
      the same inputs (events, ``torch.profiler``, plain version,
      bound: bytes at each tensor's element size, the variants'
      integer instructions at the int32 pipe's rate), the uint8 and f32
      frames' latency, median of 20 in turns, and each session's device
      time by kernel over 5 frames (``torch.profiler``);
  12. fleet frames at full width (``fleet_phase``), from
      ``render_fleet_sequence`` of phase 4's scene: ``process_fleet`` on
      8 rigs exactly 1 launch each of K1, K2, K3, every rig's slice
      bit-equal to that rig's ``process_frame``, and so on 16 and 32
      rigs (the 8 repeated); with a ``camera_mask``
      (rig 1's back pair and rig 2 dead) 3 again, equal to the per-rig
      masked frames; on the frames rounded to uint8 in a uint8 session
      3 launches of the uint8 variants, bit-equal to the f32 fleet;
      localized, two steps of 4 launches each (K4 once for the fleet),
      points bit-equal and poses within 1e-5 / 1e-4 of a per-rig
      ``process_frame`` loop, and ``run_fleet`` over T = 6 steps of 4
      rigs 3T + 1, each rig's trajectory under phase 6's ATE/RPE limits;
      the card's ``process_fleet`` against the CPU session's on 2 rigs at
      96 x 128 (integer-valued frames, the CPU's pyramid levels); every
      input that K1-K4 received in the counted fleet calls held against
      its plain version on the card (dense FE and matchers bit-equal,
      sparse FE by the rule below); then
      the fleet frame's latency at 1, 2, 4 and 8 rigs (median of 20, in
      turns) and the 8-rig fleet frame's device profile;
  13. the pipelined schedule (``PipelineConfig(schedule="pipelined")``,
      paper Fig. 4: FE(t) on one CUDA stream overlapping FM(t - 1) on
      another) at full width (``pipelined_phase``): ``run`` on phase 6's
      T = 6 sequence, f32, rounded to uint8 in a uint8 session, and
      localized; ``run_fleet`` on 8 rigs x T = 4 of
      ``render_fleet_sequence``, f32 and localized; the legacy
      ``run_sequence_pipelined``: each bit-equal to the sequential
      schedule field by field (poses within 1e-5, points and inliers
      equal), 3T launches (3T + 1 localized), no more host syncs than
      the sequential call, every K1-K4 input held to its plain version;
      K1/K2 and K3 on distinct streams in a ``torch.profiler`` trace of
      the 8-rig ``run_fleet``, with the device ms of FE/FM overlap; 10
      back-to-back 8-rig runs, each freed before the next, bit-equal to
      the first; peak device memory, latency of both schedules in turns
      (median of 20) at 1 and 8 rigs, and both 8-rig device profiles;
  14. the pose backend and the paper's Tab. I split at full width
      (``backend_phase``): a 2-camera ``RigConfig.stereo`` session on
      phase 6's sequence, pair 0: ``process_frame`` 3 launches a frame,
      ``temporal_match`` 1 (K4), ``triangulate`` and
      ``estimate_relative_pose`` none, in the slam / vio / registration
      modes of ``benchmarks/run.py``, at least 8 inliers a transition;
      the quad-fused VO of ``tests/test_system.py`` on that test's
      scene and motion at 720p (5 frames) within 30% of the
      ground-truth travel, and its drift on phase 6's sequence; the frontend's and each mode's backend ms and
      the frontend's share (median of 20 in turns) beside the paper's
      54.8 / 86.7 / 84.6%, the backend's host syncs; the card's backend
      against the CPU's on the same points at ``tests/test_system.py``'s
      160 x 240 (points bit-equal, poses within 1e-4, inliers equal);
  15. the fleet service at full width (``service_phase``): a
      ``FleetService`` over card sessions serving 8 rigs of
      ``render_fleet_sequence`` (T = 6, ``QueueConfig()`` buckets 1, 2,
      4, 8) through ``run_episode``, every step counted (3 launches a
      served batch, 4 localized, none otherwise) and every K1-K4 input
      held to its plain version: a fault-free f32 episode bit-equal to
      ``process_fleet`` on each batch and to ``process_frame``; a fault
      episode (dead camera, corrupt frame, desync, a stall healed by a
      restart, arrival jitter, each on its own rig) whose healthy rigs
      equal the fault-free ones and whose events, counters and status
      equal a CPU session's at 96 x 128; the same in a uint8 session,
      equal to f32 on the rounded frames, and a uint8 intake with no
      copy; the localized episode (finite poses) and the quarantine
      drive (the quarantined rig's pose state dropped); ``wire_encode``
      on the card byte-identical to the CPU encoding.  Then tick, step
      and bare ``process_fleet`` ms in turns, submit ms (f32, uint8),
      batch upload ms, a tick's idle share, encode/decode ms and
      ``wire_bytes`` against the tensors' bytes;
  16. failover and crash-consistent snapshots at full width
      (``failover_phase``), on phase 15's 8-rig fleet, every step counted
      and every K1-K4 input held to plain, the services a restore makes
      too: kill and recover (a crash after tick 2, a fresh service from
      the newest snapshot; every report bit-equal to the uninterrupted
      episode's but each rig's first pose after the restore, identity
      with ``valid=False``); the same through a torn snapshot (recovery
      from step 1); ``host_down`` over ``HostMap(host_fault_domains(
      {"data": 2}))`` (every frame served, moved rigs' chains gapped);
      a ``dispatch_error`` recovered (bit-equal to the fault-free
      episode) and a ``stuck_dispatch`` dropped under a
      ``DispatchGuard``, in a non-default stream, 3 launches a guarded
      batch and every fault one the injector scheduled; each episode's
      events, status, recovery and report metadata equal to a CPU
      session's at 96 x 128, and the card's snapshot leaves at 96 x 128
      held to the CPU's.  Then ``snapshot.save`` and ``snapshot.restore``
      ms at 8 rigs, localized, and a guarded step against an unguarded
      one, in turns;
  17. print the kernels' JSON line (the uint8 variants as rows
      ``<kernel>_u8``, each with its float kernel's ``float_*`` numbers
      from the same inputs; the sparse FE's and fused matcher's rows with
      their ``textured`` and ``crowded`` runs; K1-K4 and their uint8
      variants with their launches on phase 12's path under
      ``fleet_launches``, on phase 13's under ``pipelined_launches``, on
      phase 14's under ``vo_launches`` and on phases 15 and 16 under
      ``service_launches`` (phase 15's alone under ``service``); the
      fleet's timings under ``fleet``, the pipelined schedule's under
      ``pipelined``, the Tab. I split under ``tab1``, the service's under
      ``service``, the failover's under ``failover``; the empty launch
      under ``empty_launch``), then ``{"ok": true, "device": ...}`` as the
      last line.

Tolerances: integer and bool outputs, blur and score are bit-equal.
theta and the moments are equal on integer-valued frames (every sum is
an integer below 2**24, so exact in any order) with theta within 1 ulp
(atan2); on float frames the moment sums run in another order, so each
moment is held to 2 * gamma_961 * sum|x * p| (the worst-case float32
summation error of two 961-term sums, gamma_n = n u / (1 - n u)), and
theta to atan2 of the kernel's own moments within 1 ulp and to the
other theta within the moment difference carried through atan2 (plus
4 ulp).  Orientation only (K8) runs the sparse FE's (K2) device code,
so on the same keypoints the two are bit-equal; so do the per-level
dense and sparse FE (K6, K7) K1's and K2's, so the two schedules are
bit-equal at full width.  Descriptors
are equal wherever the two steering bins agree; the bins may differ only
for keypoints whose theta lies within the theta difference (4 ulp on
integer frames) of a bin edge, and that count is printed.  The
match-only and SAD-only matchers, the single-pair Hamming matcher and
the SAD sweep are bit-equal (integer arithmetic, first-occurrence
argmins).  Poses come from a 3 x 3 SVD whose library differs between
the card and the CPU, so they are held to a tolerance.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM published HBM rate (NVIDIA data sheet); the kernels' bounds
# are taken against it and the instruction rates below, beside the
# card's power limit.
HBM_BYTES_PER_S = 3.35e12
# Every kernel's work is counted instruction by instruction, each at its
# pipe's rate: results a clock per SM for compute capability 9.0 (CUDA
# C++ Programming Guide, "Arithmetic Instructions" throughput table) x 132
# SMs x 1.98 GHz boost clock (H100 SXM data sheet).  Four classes, the
# ``pipes`` of ``bound_ms``, in this order:
#   FP32    128: 32-bit floating-point add, multiply, multiply-add (FADD,
#                FMUL, FFMA: one instruction each);
#   min/max  64: 32-bit floating-point compare, minimum, maximum (FSETP,
#                FMNMX, FSEL, FCHK);
#   MUFU     16: reciprocal and the other special functions, and the
#                16-a-clock rows: conversions between 32-bit float and
#                integer types (F2I, I2F) and population count (POPC);
#   int32    64: 32-bit integer add, multiply-add, compare, min, max,
#                logical operations, shifts and sum of absolute difference
#                (IADD3, IMAD, ISETP, IMNMX, LOP3, SHF; a SAD term |a - b|
#                + c counts once).  NVIDIA publishes no rate for the DPX
#                min/max (sm_90); the counts take it as this rate, which
#                bounds every kernel that runs DPX no faster than IMNMX.
# The classes' times are summed; the pipes overlap, so the strict floor
# is their maximum.
FP32_INSTR_PER_S = 128 * 132 * 1.98e9
MINMAX_PER_S = 64 * 132 * 1.98e9
MUFU_PER_S = 16 * 132 * 1.98e9
INT32_OPS_PER_S = 64 * 132 * 1.98e9
REPS = 20
# gamma_961 = n u / (1 - n u) of a 961-term float32 sum, u = 2**-24.
GAMMA_961 = 961 * 2.0 ** -24 / (1 - 961 * 2.0 ** -24)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# The instructions whose static counts show the dense FE's design in its
# SASS: float min/max (the van Herk arc extrema), integer and DPX min/max
# (the uint8 datapath's packed 16-bit lanes) and shared-memory loads.
SASS_OPS = ("FMNMX", "IMNMX", "VIMNMX", "VIMNMX3", "LDS")
DENSE_SOURCES = ("frontend_fused", "frontend_level", "fast_detect")


def sass_mix() -> None:
    """Log each dense FE instantiation's static instruction mix (counts
    of SASS_OPS in ``cuobjdump -sass`` of its built library).  Nothing
    passes or fails on it; without ``cuobjdump`` it logs that."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        log("[sass] cuobjdump not found: instruction mix not logged")
        return
    for stem in DENSE_SOURCES:
        out = subprocess.run([tool, "-sass", _build._LIBS[stem]._name],
                             capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            log(f"[sass {stem}] cuobjdump failed: {out.stderr.strip()[:200]}")
            continue
        counts, fn = {}, None
        for line in out.stdout.splitlines():
            head = re.search(r"Function : (\S+)", line)
            if head:
                m = re.search(r"([a-z_]+_kernel)(?:I([fh])E)?", head.group(1))
                fn = (f"{m.group(1)}<{dict(f='float', h='uint8')[m.group(2)]}>"
                      if m and m.group(2) else m.group(1) if m
                      else head.group(1))
                counts[fn] = {}
                continue
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                           r"([A-Z][A-Z0-9_]*)", line)
            if ins and fn is not None:
                op = ins.group(1)
                if op != "NOP":
                    counts[fn][op] = counts[fn].get(op, 0) + 1
        for fn, c in counts.items():
            log(f"[sass {stem}] {fn}: "
                + ", ".join(f"{op} {c.get(op, 0)}" for op in SASS_OPS)
                + f" of {sum(c.values())} instructions")


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


def bound_ms(n_bytes: float, *, pipes: tuple = (0, 0, 0, 0)):
    """(ms, "bytes" or "operations"): the larger of ``n_bytes`` at the
    HBM rate and ``pipes``, the (FP32, min/max, MUFU, int32) instruction
    counts, each at its pipe's rate, summed."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    fp32, minmax, mufu, int32 = pipes
    t_ops = (fp32 / FP32_INSTR_PER_S + minmax / MINMAX_PER_S
             + mufu / MUFU_PER_S + int32 / INT32_OPS_PER_S) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def add_pipes(*counts) -> tuple:
    """The sum of (FP32, min/max, MUFU, int32) instruction counts."""
    return tuple(sum(c) for c in zip(*counts))


def scale_pipes(n: float, per: tuple) -> tuple:
    """``n`` times the (FP32, min/max, MUFU, int32) counts ``per``."""
    return tuple(n * c for c in per)


# The masked Hamming argmin, by pipe, on the cheapest schedule known
# (``band_search_pipes``): the row-band test of a right feature, its
# disparity difference and two compares (1 FP32, 2 compare); the Hamming
# distance of a pair in the search region, 8 XOR (LOP3) and 8 POPC, their
# sum (3 IADD3) and the running minimum and its index (2: int32 13, MUFU
# class 8).
BAND_PAIR_PIPES = (1, 2, 0, 0)
REGION_PAIR_PIPES = (0, 0, 8, 8 + 3 + 2)


def band_search_pipes(meta_l: torch.Tensor, meta_r: torch.Tensor, *,
                      row_band: float, max_disparity: float, **_) -> tuple:
    """(FP32, min/max, MUFU, int32) instructions of the cheapest known
    masked Hamming argmin on (..., K, 4) x (..., M, 4) meta rows (x, y,
    level, valid), counted on this run's data: sort each right set by
    (level, y) once (M log2 M compare-and-moves, 2 int32 each), two
    binary searches a valid left feature for its row band's ends (2 log2
    M int32), the disparity test of each right feature at its level
    inside the band (BAND_PAIR_PIPES), and the Hamming distance and
    running minimum of each pair in the search region
    (REGION_PAIR_PIPES)."""
    log_m = math.ceil(math.log2(max(meta_r.shape[-2], 2)))
    n_right = meta_r[..., 0].numel()
    n_left = int((meta_l[..., 3] > 0.5).sum())
    band = ((meta_l[..., :, None, 3] > 0.5) & (meta_r[..., None, :, 3] > 0.5)
            & (meta_l[..., :, None, 2] == meta_r[..., None, :, 2])
            & ((meta_l[..., :, None, 1] - meta_r[..., None, :, 1]).abs()
               <= row_band))
    dx = meta_l[..., :, None, 0] - meta_r[..., None, :, 0]
    region = band & (dx >= 0.0) & (dx <= max_disparity)
    return add_pipes(
        (0, 0, 0, n_right * log_m * 2 + n_left * log_m * 2),
        scale_pipes(int(band.sum()), BAND_PAIR_PIPES),
        scale_pipes(int(region.sum()), REGION_PAIR_PIPES))


def sad_pipes(n_terms: int, n_converted: int, n_argmin: int = 0) -> tuple:
    """(FP32, min/max, MUFU, int32) instructions of SAD sweeps: one int32
    instruction a term (|a - b| + c), each of ``n_converted`` float pixels
    truncated to int32 once (F2I), and 2 int32 a shift for the
    first-occurrence argmin over ``n_argmin`` shifts."""
    return (0, 0, n_converted, n_terms + 2 * n_argmin)


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


def footprint(shape_hw, xs, ys, kh: int, kw: int, device,
              reach2: int | None = None) -> int:
    """Pixels of an (h, w) image covered by (kh, kw) windows centered at
    the (already clamped) integer centers — what a kernel must read; with
    ``reach2``, only each window's disc dx^2 + dy^2 <= reach2."""
    h, w = shape_hw
    m = torch.zeros((1, 1, h, w), device=device)
    m[0, 0, ys.long(), xs.long()] = 1.0
    if reach2 is None:
        cover = F.max_pool2d(m, (kh, kw), stride=1,
                             padding=(kh // 2, kw // 2))
    else:
        dy = torch.arange(kh, device=device)[:, None] - kh // 2
        dx = torch.arange(kw, device=device)[None, :] - kw // 2
        disc = (dx * dx + dy * dy <= reach2).float()[None, None]
        cover = F.conv2d(m, disc, padding=(kh // 2, kw // 2))
    return int((cover > 0).sum().item())


# FAST-9/16 a pixel, by pipe, on the cheaper of two bit-equal schedules
# for each part.  The arc extrema: the JAX package's (frontend_fused.py
# arc_extrema and fast_score_from_taps: van Herk prefix 21 + 21, suffix
# 21 + 21 and 14 + 14 joins, then the 15 + 15 running extrema over the
# arcs, 142 in all) or this port's (frontend_common.cuh arc_extrema: 59
# a side, 118), so 118 two-input min/max.  The differences: 16 tap
# subtractions on the reference's schedule, or 2 on the raw-tap extrema
# (the centre subtracted once a side, bit-equal because rounding is
# monotone; tests/port/test_torch_fast_schedule.py), so 2 FP32.  Then
# max(bright, -dark) (the negation an operand modifier), the threshold
# compare and select (min/max class: 118 + 3 = 121).
FAST_EXTREMA_PER_PIXEL = min(112 + 30, 2 * 59)
FAST_PIPES_PER_PIXEL = (2, FAST_EXTREMA_PER_PIXEL + 1 + 2, 0, 0)
# The exact pre-test a pixel (frontend_common.cuh fast_live): the second
# largest and second smallest of the 4 compass taps (8 min/max), two
# subtractions, two compares and their or.  Work that depends on the
# data is counted as this run's data needs it: the bound is the smaller
# of FAST_PIPES_PER_PIXEL on every pixel and the pre-test on every
# pixel plus FAST_PIPES_PER_PIXEL on the pixels that pass it
# (``live_pixels``).
FAST_PRETEST_PIPES = (2, 8 + 2 + 1, 0, 0)
# The rest of the dense FE (K1, K6) a pixel, float: the blur's two passes
# of 7 multiplies and 6 adds, the norm's add and floor, the IEEE divide
# as its sm_90 sequence (MUFU.RCP, 5 FFMA, FCHK), and the NMS's multiply
# by (cs > 0) (FP32: 26 + 2 + 5 + 1 = 34); the separable NMS's 4 maxima,
# its 2 compares and select, and FCHK (min/max: 8); the reciprocal (MUFU:
# 1).  FAST comes on top, as above.
BLUR_NMS_PIPES_PER_PIXEL = (26 + 2 + 5 + 1, 8, 1, 0)
# The uint8 variant's, in int32 instructions (one result each at
# INT32_OPS_PER_S): the blur's horizontal pass, 6 multiply-adds (IMAD or
# LEA; the first tap is the accumulator) on a 32-bit word that holds two
# pixels' sums in 16-bit lanes (at most 255 x 36 = 9180, no carry
# between them), so 3 a pixel; its vertical pass, 6 a pixel in int32
# (the sums reach 330,480); the quotient by 1296 (IMAD.HI and a shift;
# the + 648 rides in an IADD3) (2); NMS's 4 maxima at a quarter and 3
# more (4): 15 on every pixel.  FAST's FAST_EXTREMA_PER_PIXEL two-input
# extrema at a quarter each, since the DPX three-input min/max on packed
# 16-bit lanes does four at once (on raw taps in [0, 255], the centre
# subtracted once a side), then max(bright, -dark), threshold compare
# and select (4) (FAST_INT_OPS_PER_PIXEL, 33.5); the pre-test's 8
# min/max at a quarter and 3 more (5).
DENSE_INT_OPS_PER_PIXEL = 6 / 2 + 6 + 2 + (4 / 4 + 3)
FAST_INT_OPS_PER_PIXEL = FAST_EXTREMA_PER_PIXEL / 4 + 4
FAST_INT_PRETEST_OPS = 8 / 4 + 3
# The sparse FE a keypoint, by pipe (FP32, min/max, MUFU, int32), on the
# cheapest schedule known for each part.  The moments as masked column
# sums (describe_common.cuh): each of the 709 pixels in the mask added
# into sum p and multiply-added into sum dy * p, then each of the 31
# columns' dx * sum p and the sums across the columns (2 x 31): 1,480
# instructions, FP32 on float pixels, int32 on uint8 ones.  atan2f: about
# 20 FP32, 4 compares and selects and a reciprocal (MUFU).  The steering
# bin: a multiply, the conversion to int (MUFU class) and the mod 12 (4
# int32); on uint8 the two moments' conversions to float (MUFU class)
# too.  The descriptor: 256 compares (min/max class in float, int32 on
# uint8) and 8 ballots (int32); the taps' indices are ROM constants.
MOMENT_INSTR_PER_KP = 709 * 2 + 2 * 31
# The pixels the sparse FE reads about a keypoint: the raw image inside
# the moments' circular mask (dx^2 + dy^2 <= 15^2) and the smoothed one
# inside the disc that the steering taps reach (describe_common.cuh
# TAP_REACH2; the largest dx^2 + dy^2 of a STEER_LUT tap).
MOMENT_REACH2 = 15 * 15
TAP_REACH2 = 173
ATAN2_BIN_PIPES = (20 + 1, 4, 1 + 1, 4)
ORIENT_PIPES_PER_KP = {
    "f32": add_pipes((MOMENT_INSTR_PER_KP, 0, 0, 0), (20, 4, 1, 0)),
    "u8": add_pipes((0, 0, 0, MOMENT_INSTR_PER_KP), (20, 4, 1 + 2, 0))}
SPARSE_PIPES_PER_KP = {
    "f32": add_pipes((MOMENT_INSTR_PER_KP, 256, 0, 8), ATAN2_BIN_PIPES),
    "u8": add_pipes((0, 0, 2, MOMENT_INSTR_PER_KP + 256 + 8),
                    ATAN2_BIN_PIPES)}


def abs_moment_sums(patches: torch.Tensor) -> torch.Tensor:
    """(..., 31, 31) raw patches -> (..., 2) sum|x * p| and sum|y * p|,
    the scale of the float-frame moment bound."""
    from repro_torch.kernels.ref import moment_grids
    xg, yg = moment_grids(patches.device)
    return torch.stack([(patches * xg).abs().sum((-2, -1)),
                        (patches * yg).abs().sum((-2, -1))], -1)


def sparse_abs_sums(raw, slabs, xy, col) -> torch.Tensor:
    """``abs_moment_sums`` of the raw patches the sparse FE (K2) reads
    for (B, Ktot) keypoints of column levels ``col``."""
    from repro_torch.kernels.describe_fused import _slab_patches
    b = xy.shape[0]
    slab = col.long()[None, :] * b + torch.arange(b, device=xy.device)[:, None]
    return abs_moment_sums(_slab_patches(raw, slab, slabs.table, xy))


def hold_theta(th_k, mom_k, th_p, mom_p, s_abs, integer: bool, what: str,
               *, same_library: bool = True):
    """Theta and moments of a kernel (``_k``) against another computation
    of them (``_p``) under the module note's rule; raises where it fails.
    ``s_abs`` is ``abs_moment_sums`` of the raw patches (float frames
    only).  With ``same_library=False`` (the card's theta against the
    CPU's: two atan2 libraries) the moments are held as always, but theta
    within the moment difference carried through atan2 plus 4 ulp on
    integer frames too, instead of 1 ulp.  Returns (the theta tolerance
    of each keypoint, for the bin check, and the largest moment
    difference)."""
    own = torch.atan2(mom_k[..., 1], mom_k[..., 0])
    if ulps(th_k, own) > 1:
        raise AssertionError(f"{what}: theta is not atan2 of its moments")
    mom_p = mom_p.to(mom_k.device)
    dmom = (mom_k - mom_p).abs()
    err = float(dmom.max()) if dmom.numel() else 0.0
    hold_moments(mom_k, mom_p, s_abs, integer, what)
    th_p = th_p.to(th_k.device)
    tol = theta_tol(th_p, mom_k, mom_p)
    if integer and same_library:
        if ulps(th_k, th_p) > 1:
            raise AssertionError(
                f"{what}: theta differs by more than 1 ulp on "
                "integer-valued frames")
    elif bool(((th_k.double() - th_p.double()).abs() > tol.double()).any()):
        raise AssertionError(f"{what}: theta differs by more than its "
                             "moments allow")
    return tol, err


def theta_tol(th_p, mom_k, mom_p) -> torch.Tensor:
    """The theta tolerance of each keypoint: the moment difference
    carried through atan2, plus 4 ulp of theta (4 ulp alone where the
    moments are equal)."""
    spacing = 4.0 * torch.from_numpy(np.spacing(np.abs(
        th_p.cpu().numpy()))).to(th_p.device)
    hyp = torch.hypot(mom_p[..., 0], mom_p[..., 1]).clamp(min=1e-30)
    return ((mom_k - mom_p).abs().sum(-1) / hyp) * 1.01 + spacing


def hold_moments(mom_k, mom_p, s_abs, integer: bool, what: str) -> None:
    """Moments equal on integer-valued frames, and within the float
    summation bound 2 * gamma_961 * sum|x * p| on float frames."""
    dmom = (mom_k - mom_p.to(mom_k.device)).abs()
    if bool((dmom > (0.0 if integer else 2 * GAMMA_961 * s_abs)).any()):
        raise AssertionError(f"{what}: moments beyond the rule on "
                             f"{'integer-valued' if integer else 'float'} "
                             "frames")


def hold_sparse(out_k, out_p, s_abs, integer: bool, what: str, *,
                same_library: bool = True):
    """(theta, moments, desc) of a sparse FE kernel against another
    computation of them on the same inputs, under the module note's
    rule: ``hold_theta``, steering bins that differ only within the
    theta tolerance of a bin edge, descriptors equal wherever the bins
    agree.  Returns (the largest moment difference, the largest theta
    difference in ulp, the keypoints near a bin edge, the bins that
    differ)."""
    (th_k, mom_k, desc_k), (th_p, mom_p, desc_p) = out_k, out_p
    th_p, desc_p = th_p.to(th_k.device), desc_p.to(desc_k.device)
    tol, err = hold_theta(th_k, mom_k, th_p, mom_p, s_abs, integer, what,
                          same_library=same_library)
    return (err, ulps(th_k, th_p),
            *hold_bins(th_k, desc_k, th_p, desc_p, tol, what))


def hold_bins(th_k, desc_k, th_p, desc_p, tol, what: str):
    """Steering bins that differ only where theta lies within ``tol`` of
    a bin edge, and descriptors equal wherever the bins agree.  Returns
    (the keypoints near a bin edge, the bins that differ)."""
    from repro_torch.kernels.ref import theta_to_bin
    edge = near_bin_edge(th_p, tol)
    bins_differ = theta_to_bin(th_k) != theta_to_bin(th_p)
    if bool((bins_differ & ~edge).any()):
        raise AssertionError(f"{what}: steering bins differ away from a "
                             "bin edge")
    if bool(((desc_k != desc_p).any(-1) & ~bins_differ).any()):
        raise AssertionError(f"{what}: descriptors differ where the bins "
                             "agree")
    return int(edge.sum()), int(bins_differ.sum())


def sparse_bound(pairs):
    """(bound ms, by) of the sparse FE on [(level (B, h, w), keypoints
    (B, K, 2))]: each level pixel that the function reads read once (at
    the level's element size): the raw image inside the moments' disc,
    the smoothed one inside the steering taps' disc; the keypoints read
    and theta, moments and descriptor written, the steering LUT read;
    SPARSE_PIPES_PER_KP a keypoint (the float or the uint8 counts)."""
    px = n_kp = 0
    size = 4
    for lv, xy in pairs:
        size = lv.element_size()
        h, w = lv.shape[1:]
        n_kp += xy.shape[0] * xy.shape[1]
        for cam in range(lv.shape[0]):
            xs = xy[cam, :, 0].clamp(0, w - 1)
            ys = xy[cam, :, 1].clamp(0, h - 1)
            px += sum(footprint((h, w), xs, ys, 31, 31, lv.device, reach2)
                      for reach2 in (MOMENT_REACH2, TAP_REACH2))
    n_bytes = px * size + n_kp * (8 + 4 + 44) + 12 * 256 * 4
    per = SPARSE_PIPES_PER_KP["u8" if size == 1 else "f32"]
    return bound_ms(n_bytes, pipes=scale_pipes(n_kp, per))


def live_pixels(x: torch.Tensor, threshold: float, slabs=None) -> int:
    """Pixels of ``x`` ((B, h, w) images, or the flat buffer of
    ``slabs``) that pass the dense FE's exact FAST pre-test: the second
    largest compass tap minus the centre above ``threshold`` or the
    second smallest below -``threshold`` (``frontend_common.cuh``
    ``fast_live``; on uint8 pixels the same set, the differences being
    integers)."""
    if slabs is not None:
        return sum(live_pixels(x[off:off + h * w].view(1, h, w), threshold)
                   for off, h, w in slabs.slabs)
    h, w = x.shape[-2:]
    xf = x.float().reshape(-1, h, w)
    pad = F.pad(xf[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    a, b, c, d = (pad[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                  for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0)))
    lo = torch.minimum(torch.maximum(a, b), torch.maximum(c, d))
    hi = torch.maximum(torch.minimum(a, b), torch.minimum(c, d))
    live = ((torch.maximum(lo, hi) - xf > threshold)
            | (-(torch.minimum(lo, hi) - xf) > threshold))
    return int(live.sum())


def fast_bound(n_bytes: int, n: int, n_live: int, base=(0, 0, 0, 0)):
    """(bound ms, by) of FAST on ``n`` pixels, ``n_live`` of them passing
    the pre-test, on top of ``base`` (FP32, min/max, MUFU, int32)
    instructions:
    the smaller of the reference's schedule on every pixel and the
    pre-test on every pixel with the schedule on the live ones."""
    full = [b + n * f for b, f in zip(base, FAST_PIPES_PER_PIXEL)]
    pre = [b + n * p + n_live * f for b, p, f in
           zip(base, FAST_PRETEST_PIPES, FAST_PIPES_PER_PIXEL)]
    return min(bound_ms(n_bytes, pipes=tuple(full)),
               bound_ms(n_bytes, pipes=tuple(pre)))


def dense_bound(x, blur, score, n_live: int):
    """(bound ms, by) of the dense FE on pixels ``x`` with outputs
    ``blur`` and ``score``, ``n_live`` pixels passing the FAST pre-test:
    each read or written once at its element size; the blur and NMS
    (BLUR_NMS_PIPES_PER_PIXEL) and FAST (``fast_bound``) at the pipes'
    rates, or on uint8 pixels DENSE_INT_OPS_PER_PIXEL and FAST's
    FAST_INT_OPS_PER_PIXEL (on the live pixels after the pre-test, if
    smaller) at the int32 rate."""
    n = x.numel()
    n_bytes = n * (x.element_size() + blur.element_size()
                   + score.element_size())
    if x.dtype == torch.uint8:
        fast = min(n * FAST_INT_OPS_PER_PIXEL,
                   n * FAST_INT_PRETEST_OPS + n_live * FAST_INT_OPS_PER_PIXEL)
        return bound_ms(n_bytes,
                        pipes=(0, 0, 0, n * DENSE_INT_OPS_PER_PIXEL + fast))
    return fast_bound(n_bytes, n, n_live,
                      scale_pipes(n, BLUR_NMS_PIPES_PER_PIXEL))


def pyramid_pairs(raw, slabs, xy, col):
    """[(level (B, h, w), its keypoints (B, K_l, 2))] of the sparse FE's
    whole-frame inputs (flat slabs, slab table, level-sorted keypoints
    and their column levels)."""
    b = xy.shape[0]
    pairs = []
    for lvl in range(len(slabs.slabs) // b):
        off, h, w = slabs.slabs[lvl * b]
        pairs.append((raw[off:off + b * h * w].view(b, h, w),
                      xy[:, col == lvl]))
    return pairs


def orient_bound(raw, xy):
    """(bound ms, by) of orientation only on (B, H, W) images and (B, K,
    2) keypoints: each pixel inside a keypoint's moment disc read once
    at the images' element
    size, the keypoints read and theta and moments written;
    ORIENT_PIPES_PER_KP a keypoint (the float or the uint8 counts)."""
    b, h, w = raw.shape
    px = sum(footprint((h, w), xy[c, :, 0].clamp(0, w - 1),
                       xy[c, :, 1].clamp(0, h - 1), 31, 31, raw.device,
                       MOMENT_REACH2) for c in range(b))
    n_kp = xy.shape[0] * xy.shape[1]
    n_bytes = px * raw.element_size() + n_kp * (8 + 4 + 8)
    per = ORIENT_PIPES_PER_KP["u8" if raw.dtype == torch.uint8 else "f32"]
    return bound_ms(n_bytes, pipes=scale_pipes(n_kp, per))


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
    n_live = live_pixels(flat, kw["threshold"], slabs)
    stats["bound_ms"], stats["bound_by"] = dense_bound(flat, blur_k, score_k,
                                                       n_live)
    every = dense_bound(flat, blur_k, score_k, flat.numel())
    log(f"[dense FE/{kind}] {n_live} of {flat.numel()} pixels pass the "
        f"FAST pre-test; bound {stats['bound_ms']:.6f} ms "
        f"({stats['bound_by']}), {every[0]:.6f} ms ({every[1]}) were every "
        "pixel to pass")
    stats["fast_live_share"] = n_live / flat.numel()
    stats["device_ms"] = device_ms(
        lambda: fe.frontend_fused_pyramid_cuda(flat, slabs, **kw),
        "frontend_kernel")
    return stats


# The rendered scene is flat between its landmarks, so under 1% of its
# pixels pass the dense FE's FAST pre-test.  Two textured 720p frames
# show the other end: the scene with seeded Gaussian sensor noise of
# TEXTURE_NOISE_DN grey levels (about a tenth of the pixels pass, so
# nearly every warp runs the arc extrema), and uniform random texture.
TEXTURE_NOISE_DN = 8.0


def textured_frames(frame: np.ndarray, seed: int = 0) -> dict:
    """{name: (4, H, W) integer-valued float32 frame} of ``frame``."""
    rng = np.random.default_rng(seed)
    noisy = np.round(frame + rng.normal(0.0, TEXTURE_NOISE_DN, frame.shape))
    return {"noisy": np.clip(noisy, 0, 255).astype(np.float32),
            "uniform": rng.integers(0, 256, frame.shape).astype(np.float32)}


def check_dense_textured(frame: np.ndarray, cfg, dev) -> dict:
    """K1 and K1-u8 held to their plain versions and timed (``check_dense``)
    on each of ``textured_frames(frame)``: {"<frame>_<f32|u8>": stats}."""
    from repro_torch.core import pyramid
    out = {}
    for name, img in textured_frames(frame).items():
        images = torch.from_numpy(img).to(dev)
        for variant, prec, x in (("f32", "f32", images),
                                 ("u8", "uint8", images.to(torch.uint8))):
            levels = pyramid.build_pyramid_batched(x, cfg, precision=prec)
            st = check_dense(levels, cfg, f"{name} {variant}")
            log(f"[dense FE/{name} {variant}] {st['ms']:.4f} ms event, "
                f"device {st['device_ms']}, live share "
                f"{st['fast_live_share']:.4f}, bound {st['bound_ms']:.6f} "
                f"({st['bound_by']})")
            out[f"{name}_{variant}"] = st
    return out


def check_sparse(levels, dense, cfg, kind: str, integer: bool):
    from repro_torch.core import fast
    from repro_torch.kernels import describe_fused as de, ops
    ks = cfg.features_per_level()
    xys = [fast.select_topk(sc, k, cfg.border)[0]
           for (_, sc), k in zip(dense, ks)]
    raw = ops.flat_levels(levels)
    sm = ops.flat_levels([b for b, _ in dense])
    slabs = ops._slabs_of(levels)
    xy = torch.cat(xys, dim=1).contiguous()
    col = ops._col_levels(tuple(ks), str(xy.device))
    out_k = de.describe_fused_pyramid_cuda(raw, sm, slabs, xy, col)
    out_p = de.describe_fused_pyramid_plain(raw, sm, slabs, xy, col)
    torch.cuda.synchronize()
    s_abs = None if integer else sparse_abs_sums(raw, slabs, xy, col)
    err, d_ulps, n_edge, n_bins = hold_sparse(out_k, out_p, s_abs, integer,
                                              "sparse FE")
    log(f"[sparse FE/{kind}] {xy.shape[0] * xy.shape[1]} keypoints: max "
        f"|d moment| {err}, max theta diff {d_ulps} ulp, "
        f"{n_edge} keypoints within the theta tolerance of a bin "
        f"edge, {n_bins} bins differ, descriptors equal "
        "wherever bins agree")
    stats = dict(
        ms=time_ms(lambda: de.describe_fused_pyramid_cuda(raw, sm, slabs, xy,
                                                          col)),
        plain_ms=time_ms(lambda: de.describe_fused_pyramid_plain(
            raw, sm, slabs, xy, col)),
        device_ms=device_ms(lambda: de.describe_fused_pyramid_cuda(
            raw, sm, slabs, xy, col), "describe_kernel"),
        max_abs_err=err)
    stats["bound_ms"], stats["bound_by"] = sparse_bound(zip(levels, xys))
    return stats, xys


def check_matcher(images, cfg, intr, kind: str, pixels=None):
    """K3 on the stereo pairs of ``images``' own features, on ``pixels``
    (by default ``images``; the uint8 copy for the uint8 variant)
    (``check_matcher_args``)."""
    from repro_torch.core import matching, orb
    from repro_torch.core.types import map_fields
    feats = orb.extract_features_batched(images, cfg)
    pixels = images if pixels is None else pixels
    li = torch.tensor([0, 2], device=images.device)
    ri = torch.tensor([1, 3], device=images.device)
    fl = map_fields(lambda x: x[li], feats)
    fr = map_fields(lambda x: x[ri], feats)
    args = (fl.desc.contiguous(), matching._meta(fl).contiguous(),
            fr.desc.contiguous(), matching._meta(fr).contiguous(),
            pixels[li].contiguous(), pixels[ri].contiguous())
    return check_matcher_args(args, cfg, kind)


def check_matcher_args(args, cfg, kind: str):
    """K3 against its plain version on (desc_l, meta_l, desc_r, meta_r,
    img_l, img_r) at ``cfg``'s gates (every output bit-equal), timed."""
    from repro_torch.kernels import matcher_fused as mf
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
                 device_ms=device_ms(lambda: mf.match_rectify_fused_cuda(
                     *args, **kw), "match_kernel"),
                 max_abs_err=err)
    stats["bound_ms"], stats["bound_by"] = matcher_bound(args, out_k[2], kw)
    return stats


def check_sparse_matcher_textured(frame: np.ndarray, cfg, intr, dev) -> dict:
    """K2 and K3, float and uint8, held to their plain versions and timed
    (``check_sparse``, ``check_matcher``) on each of
    ``textured_frames(frame)``, where every camera's top-K fills with
    corners: {"<frame>_<f32|u8>": {"sparse": stats, "matcher": stats}}."""
    from repro_torch.core import pyramid
    from repro_torch.kernels import ops
    out = {}
    for name, img in textured_frames(frame).items():
        images = torch.from_numpy(img).to(dev)
        for variant, prec, x in (("f32", "f32", images),
                                 ("u8", "uint8", images.to(torch.uint8))):
            what = f"{name} {variant}"
            levels = pyramid.build_pyramid_batched(x, cfg, precision=prec)
            dense = ops.fast_blur_nms_pyramid(
                levels, float(cfg.fast_threshold), nms=cfg.nms,
                quantized=cfg.quantized)
            sp, _ = check_sparse(levels, dense, cfg, what, True)
            mt = check_matcher(images, cfg, intr, what, pixels=x)
            log(f"[textured/{what}] sparse FE {sp['ms']:.4f} ms event, device "
                f"{sp['device_ms']}, bound {sp['bound_ms']:.6f} "
                f"({sp['bound_by']}); matcher {mt['ms']:.4f} ms event, "
                f"device {mt['device_ms']}, bound {mt['bound_ms']:.6f} "
                f"({mt['bound_by']})")
            out[f"{name}_{variant}"] = {"sparse": sp, "matcher": mt}
    return out


def crowded_matcher_args(images: torch.Tensor, cfg, seed: int = 0):
    """Fused-matcher inputs at full width on ``images``' stereo pairs
    with every feature on one row band: 2 pairs x max_features left and
    right features at y = 360 (the right ones within +-1 px), x spread so
    that about a tenth of the pairs lie in the disparity range, valid, on
    level 0; descriptors 0-3 bits from their pair's base descriptor, so
    that equal distances abound.  The search's worst case: every right
    feature passes the row band for every left feature."""
    rng = np.random.RandomState(seed)
    p, n = 2, cfg.max_features
    base = rng.randint(0, 2**32, (p, 8), dtype=np.uint64).astype(np.uint32)

    def near(b):
        out = b.copy()
        for bit in rng.choice(256, rng.randint(0, 4), replace=False):
            out[bit // 32] ^= np.uint32(1) << np.uint32(bit % 32)
        return out

    dl, dr = (np.stack([np.stack([near(base[q]) for _ in range(n)])
                        for q in range(p)]) for _ in range(2))
    ones, zeros = np.ones((p, n)), np.zeros((p, n))
    mr = np.stack([rng.uniform(200.0, 1000.0, (p, n)),
                   360.0 + rng.uniform(-1.0, 1.0, (p, n)), zeros, ones], -1)
    ml = np.stack([rng.uniform(300.0, 1100.0, (p, n)), 360.0 * ones, zeros,
                   ones], -1)
    dev = images.device
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        dl.view(np.int32), ml.astype(np.float32), dr.view(np.int32),
        mr.astype(np.float32))) + (images[[0, 2]].contiguous(),
                                   images[[1, 3]].contiguous())


def empty_launch_floor() -> dict:
    """Event and device ms of an empty kernel (``csrc/empty.cu``) at one
    warp, at K3's grid (126 blocks of 512 threads) and at K2's (500 of
    256): the practical floor under every kernel's bound."""
    from repro_torch.kernels import _build
    kern = _build.CudaKernel("empty", "empty_launch", "ii")
    dev = torch.device("cuda")
    out = {}
    for name, blocks, threads in (("1x32", 1, 32), ("126x512", 126, 512),
                                  ("500x256", 500, 256)):
        def fn():
            kern(dev, blocks, threads)
        out[name] = dict(ms=time_ms(fn), device_ms=device_ms(fn,
                                                             "empty_kernel"))
        log(f"[empty launch {name}] {out[name]['ms']:.4f} ms event, device "
            f"{out[name]['device_ms']} ms")
    return out


def matcher_bound(args, rxy, kw):
    """(bound ms, by) of the fused matcher on (desc_l, meta_l, desc_r,
    meta_r, img_l, img_r) with effective right centers ``rxy``: the
    descriptors and meta rows read, the pixels the windows and strips
    cover read once at the images' element size, the outputs written;
    a banded search (``band_search_pipes``) and the SAD sweeps
    (``sad_pipes``: every term, the covered float pixels' truncation,
    the argmin over the shifts)."""
    images = args[4]
    p, k = args[1].shape[0], args[1].shape[1]
    m = args[3].shape[1]
    h, w = images.shape[1:]
    win, rng = kw["sad_window"], kw["sad_range"]
    px = 0
    for q in range(p):
        xl = torch.round(args[1][q, :, 0]).clamp(0, w - 1)
        yl = torch.round(args[1][q, :, 1]).clamp(0, h - 1)
        xr = torch.round(rxy[q, :, 0]).clamp(0, w - 1)
        yr = torch.round(rxy[q, :, 1]).clamp(0, h - 1)
        px += footprint((h, w), xl, yl, win, win, images.device)
        px += footprint((h, w), xr, yr, win, win + 2 * rng, images.device)
    sweep = 2 * rng + 1
    n_bytes = (p * (k + m) * (32 + 16) + px * images.element_size()
               + p * k * 20)
    converted = 0 if images.dtype == torch.uint8 else px
    return bound_ms(n_bytes, pipes=add_pipes(
        band_search_pipes(args[1], args[3], **kw),
        sad_pipes(p * k * sweep * win ** 2, converted, p * k * sweep)))


def profiled_ms(fn, symbols, reps: int = REPS) -> list:
    """Device ms of every launch of the kernels whose names hold one of
    ``symbols``, over ``reps`` calls of ``fn``, from ``torch.profiler``
    (empty when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if any(sym in e.name for sym in symbols)
            and str(e.device_type).endswith("CUDA")]


def device_ms(fn, symbol: str, reps: int = REPS):
    """Median device time (ms) of the kernel whose name holds ``symbol``
    over ``reps`` calls of ``fn``; None when the profiler records no
    device time."""
    times = profiled_ms(fn, (symbol,), reps)
    return statistics.median(times) if times else None


def check_match_only(args, kw, kind: str):
    """K4 against its plain version on (desc_l, meta_l, desc_r, meta_r)
    (bit-equal dist and idx), timed; the bound counts a banded search
    (``band_search_pipes``) on these inputs."""
    from repro_torch.kernels import match_fused as mo
    out_k = mo.match_fused_cuda(*args, **kw)
    out_p = mo.match_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    bad = {n: int((a != b).sum()) for n, a, b in zip(("dist", "idx"), out_k,
                                                      out_p)}
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(out_k, out_p))
    b, k, m = args[0].shape[0], args[0].shape[1], args[2].shape[1]
    log(f"[match-only/{kind}] B={b} K={k} M={m}: mismatches {bad}; "
        f"{int((out_k[1] >= 0).sum())} candidates found")
    if any(bad.values()):
        raise AssertionError(f"match-only kernel disagrees ({kind})")
    if int((out_k[1] >= 0).sum()) == 0:
        raise AssertionError(f"match-only kernel found nothing ({kind})")
    stats = dict(ms=time_ms(lambda: mo.match_fused_cuda(*args, **kw)),
                 device_ms=device_ms(lambda: mo.match_fused_cuda(*args, **kw),
                                     "match_only_kernel"),
                 plain_ms=time_ms(lambda: mo.match_fused_plain(*args, **kw)),
                 max_abs_err=err)
    stats["bound_ms"], stats["bound_by"] = bound_ms(
        b * (k + m) * (32 + 16) + b * k * 8,
        pipes=band_search_pipes(args[1], args[3], **kw))
    log(f"[match-only/{kind}] {stats['ms']:.4f} ms event, device "
        f"{stats['device_ms']} ms, bound {stats['bound_ms']:.6f} ms "
        f"({stats['bound_by']}), plain {stats['plain_ms']:.4f} ms, library "
        "call: none")
    return stats


def check_sad_only(args, kw, kind: str):
    """K5 against its plain version on (img_l, img_r, xy_l, xy_r)
    (bit-equal SAD table), timed; the bound counts the pixels the
    windows and strips cover and every SAD term."""
    from repro_torch.kernels import sad_fused as so
    _, _, xy_l, _ = args
    rng = kw["sad_range"]
    tab_k = so.sad_fused_cuda(*args, **kw)
    tab_p = so.sad_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    bad = int((tab_k != tab_p).sum())
    err = float((tab_k - tab_p).abs().max())
    p, k = xy_l.shape[0], xy_l.shape[1]
    sweep = 2 * rng + 1
    log(f"[SAD-only/{kind}] P={p} K={k} table {sweep}: mismatches {bad}")
    if bad:
        raise AssertionError(f"SAD-only kernel disagrees ({kind})")
    stats = dict(ms=time_ms(lambda: so.sad_fused_cuda(*args, **kw)),
                 device_ms=device_ms(lambda: so.sad_fused_cuda(*args, **kw),
                                     "sad_only_kernel"),
                 plain_ms=time_ms(lambda: so.sad_fused_plain(*args, **kw)),
                 max_abs_err=err)
    stats["bound_ms"], stats["bound_by"] = sad_bound(args, kw)
    log(f"[SAD-only/{kind}] {stats['ms']:.4f} ms event, device "
        f"{stats['device_ms']} ms, bound {stats['bound_ms']:.6f} ms "
        f"({stats['bound_by']}), plain {stats['plain_ms']:.4f} ms, library "
        "call: none")
    return stats


def sad_bound(args, kw):
    """(bound ms, by) of the SAD-only matcher on (img_l, img_r, xy_l,
    xy_r): the pixels the windows and strips cover read once at the
    images' element size, the centers read and the table written; every
    SAD term and the covered float pixels' truncation (``sad_pipes``)."""
    img_l, _, xy_l, xy_r = args
    win, rng = kw["sad_window"], kw["sad_range"]
    p, k = xy_l.shape[0], xy_l.shape[1]
    sweep = 2 * rng + 1
    h, w = img_l.shape[1:]
    px = 0
    for q in range(p):
        for xy, width in ((xy_l[q], win), (xy_r[q], win + 2 * rng)):
            xs = torch.round(xy[:, 0]).clamp(0, w - 1)
            ys = torch.round(xy[:, 1]).clamp(0, h - 1)
            px += footprint((h, w), xs, ys, win, width, img_l.device)
    n_bytes = px * img_l.element_size() + p * k * 16 + p * k * sweep * 4
    converted = 0 if img_l.dtype == torch.uint8 else px
    return bound_ms(n_bytes, pipes=sad_pipes(p * k * sweep * win ** 2,
                                             converted))


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
        li, ri = vs._flat_pair_indices(1)
        fl = map_fields(lambda x: x[li], feats)
        fr = map_fields(lambda x: x[ri], feats)
        step("FM (K3) + depth", lambda: matching.match_pair_fused(
            images[li], images[ri], fl, fr, cfg, vs._fm_intr(1)))
    return {k: statistics.median(v[2:]) for k, v in times.items()}


def union_ms(spans) -> float:
    """Length in ms of the union of (start, end) intervals in us: the
    time during which at least one of them ran."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def profile_frames(vs, images, n: int = 5, call=None,
                   summary: dict | None = None) -> dict:
    """Device time by kernel over ``n`` frames (torch.profiler) and the
    device's idle share of the frame; ``call`` replaces
    ``vs.process_frame(images)`` as the frame.  Busy time is the union
    of the device events' intervals across streams (on one stream it
    equals their sum, which is logged beside it), so the idle share,
    1 - busy / wall, stays in [0, 1] when streams overlap.  Returns
    {kernel name: device ms per frame}; ``summary`` (a dict) receives
    the wall ms, the busy ms (union) and the sum of device times a
    frame, the idle share and the device kernels a frame."""
    from torch.profiler import ProfilerActivity, profile
    call = call or (lambda: vs.process_frame(images))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
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
    busy_sum = sum(r[0] for r in rows)
    if not rows:
        log("[profile] the profiler recorded no device time")
        return {}
    busy = union_ms([(e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if str(e.device_type).endswith("CUDA")]) / n
    log(f"[profile] wall {wall:.4f} ms/frame, device busy {busy:.4f} "
        f"ms/frame (union of intervals; sum of device times "
        f"{busy_sum:.4f}), idle share {1 - busy / wall:.4f}, "
        f"{sum(r[1] for r in rows):.0f} device kernels/frame")
    if summary is not None:
        summary.update(wall_ms=wall, busy_ms=busy, busy_sum_ms=busy_sum,
                       idle_share=1 - busy / wall,
                       device_kernels=sum(r[1] for r in rows))
    for ms, cnt, key in rows[:12]:
        log(f"[profile]   {ms:.4f} ms/frame  x{cnt:.0f}  {key[:100]}")
    return {key: ms for ms, _, key in rows}


# ATE / RPE limits of the 720p localized run, at about twice what the
# card measured (see PERF.md), as the JAX package pins its accuracy
# gates; the small sequence uses the JAX tests' own limits.
LOC_LIMITS = {"ate_rmse_m": 0.5, "rpe_trans_rmse_m": 0.16,
              "rpe_rot_mean_deg": 0.13}
SMALL_LIMITS = {"ate_rmse_m": 0.4, "rpe_trans_rmse_m": 0.25,
                "rpe_rot_mean_deg": 1.0}
SEQ_T = 6
LOC_KERNELS = ("frontend_fused_pyramid", "describe_fused_pyramid",
               "match_rectify_fused", "match_fused")


@contextlib.contextmanager
def recorded(module, name: str | None = None):
    """Record every call of a kernel module's dispatch (the function
    ``name``, by default the module's own name, just in front of the
    kernel's wrapper) made while the block runs, as a list of (args,
    kwargs, output)."""
    name = name or module.__name__.rsplit(".", 1)[1]
    dispatch = getattr(module, name)
    calls = []

    def record(*args, **kwargs):
        out = dispatch(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, dispatch)


def stacked(calls):
    """One kernel input from several recorded calls: their arguments
    concatenated along the batch axis, and the first call's options."""
    return (tuple(torch.cat(x) for x in zip(*(c[0] for c in calls))),
            calls[0][1])


def reset_counts() -> None:
    from repro_torch.kernels import ops
    for k in ops.KERNELS.values():
        k.reset()


def read_counts() -> dict:
    from repro_torch.kernels import ops
    return {name: k.launches for name, k in ops.KERNELS.items()}


def read_u8_counts() -> dict:
    """The launches of each kernel's uint8 variant, where it has one."""
    from repro_torch.kernels import ops
    return {name: k.variant_launches.get("u8", 0)
            for name, k in ops.KERNELS.items()}


def check_metrics(pose, poses, limits, what: str) -> dict:
    from repro_torch.localization import metrics
    m = metrics.trajectory_metrics(pose.rotation, pose.translation, poses)
    log(f"[{what}] ATE {m['ate_rmse_m']:.6f} m, RPE-t "
        f"{m['rpe_trans_rmse_m']:.6f} m, RPE-r {m['rpe_rot_mean_deg']:.6f} "
        f"deg over {m['travel_m']:.4f} m travelled (limits {limits})")
    for key, limit in limits.items():
        if not m[key] <= limit:
            raise AssertionError(f"{what}: {key} {m[key]} over {limit}")
    return m


def close_poses(a, b, atol: float, what: str) -> float:
    if not torch.equal(a.valid.cpu(), b.valid.cpu()):
        raise AssertionError(f"{what}: pose valid differs")
    err = max(float((a.rotation.cpu() - b.rotation.cpu()).abs().max()),
              float((a.translation.cpu() - b.translation.cpu()).abs().max()))
    if not err <= atol:
        raise AssertionError(f"{what}: poses differ by {err} > {atol}")
    return err


# The 7x7 blur a pixel (K12, quantized): two passes of 7 multiplies and 6
# adds, the norm's add and floor, the IEEE divide as its sm_90 sequence
# (5 FFMA, FCHK, MUFU.RCP): (26 + 2 + 5 FP32, 1 min/max, 1 MUFU).
BLUR_PIPES_PER_PIXEL = (26 + 2 + 5, 1, 1, 0)
SINGLE_KERNELS = ("fast_score_map", "gaussian_blur7", "orient_fused")


def counted(fn, want: dict, what: str):
    """``fn()`` with every launch count set to 0 just before and read
    just after; raises unless exactly the launches ``want`` ({kernel:
    count}) happened.  Returns (output, counts)."""
    from repro_torch.kernels import ops
    reset_counts()
    with ops.launch_audit() as audit:
        out = fn()
        torch.cuda.synchronize()
    counts = read_counts()
    got = {n: c for n, c in counts.items() if c}
    if got != want or audit.count != sum(want.values()):
        raise AssertionError(f"{what}: launches {got} (audit {audit.count}),"
                             f" expected {want}")
    return out, counts


def equal_or_raise(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if not torch.equal(a.cpu(), b.cpu()):
        n = int((a.cpu() != b.cpu()).sum())
        raise AssertionError(f"{what}: {n} of {a.numel()} values differ")


def equal_fields(a, b, what: str) -> None:
    """Every tensor of two (nested) output tuples bit-equal."""
    for name, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
        if isinstance(x, tuple):
            equal_fields(x, y, f"{what} {name}")
        else:
            equal_or_raise(x, y, f"{what} {name}")


def single_image_phase(frame, cfg, dev):
    """The single-image FE API at 720p (phase 5), on the 8 level images
    of the quad frame, integer-valued then float: K11 and K12 against
    their plain versions and K1, ``fast.detect`` (K11 + K8) against the
    CPU and K8 against K2, ``detect`` against ``extract_features``,
    ``brief.describe(brief.smooth(...))`` against K2, the launches of
    every call, then the three kernels timed on the level-0 inputs
    their wrappers received and the paper's module split.  Returns (the
    launches of each kernel summed over the entry-point calls, the
    timing stats, the module split)."""
    from repro_torch.core import brief, extract_features, fast, pyramid
    from repro_torch.core.orb import extract_features_batched
    from repro_torch.kernels import describe_fused as de
    from repro_torch.kernels import fast_detect as fd
    from repro_torch.kernels import gaussian_blur as gb
    from repro_torch.kernels import ops
    from repro_torch.kernels.frontend_fused import (blur_plain,
                                                    fast_score_plain)
    from repro_torch.kernels.ref import extract_patches, nms3
    ks = cfg.features_per_level()
    thr = float(cfg.fast_threshold)
    cfg1 = dataclasses.replace(cfg, n_levels=1)
    total = dict.fromkeys(ops.KERNELS, 0)
    first = {}                            # kernel -> its level-0 call
    for kind, integer in (("integer", True), ("float", False)):
        images = torch.from_numpy(np.round(frame) if integer
                                  else frame).to(dev).contiguous()
        levels = pyramid.build_pyramid_batched(images, cfg)
        dense = ops.fast_blur_nms_pyramid(levels, thr, nms=cfg.nms,
                                          quantized=cfg.quantized)
        batched = extract_features_batched(images, cfg)
        n_edge = cpu_ulps = 0
        for lvl, (lv, (k1_blur, k1_score), k) in enumerate(
                zip(levels, dense, ks)):
            xys, ths = [], []
            for cam in range(lv.shape[0]):
                img = lv[cam]
                what = f"{kind} level {lvl} camera {cam}"
                score = ops.fast_score_map(img, thr)
                equal_or_raise(score, fast_score_plain(img[None], thr)[0],
                               f"K11 vs plain, {what}")
                equal_or_raise(nms3(score), k1_score[cam],
                               f"nms3(K11) vs K1's score, {what}")
                for q in (True, False):
                    blur = ops.gaussian_blur7(img, quantized=q)
                    equal_or_raise(blur, blur_plain(img[None], q)[0],
                                   f"K12 (quantized={q}) vs plain, {what}")
                equal_or_raise(ops.gaussian_blur7(img), k1_blur[cam],
                               f"K12 vs K1's blur, {what}")
                with recorded(fd, "fast_score_map") as r11, \
                        recorded(de, "orient_fused") as r8:
                    (xy, sc, th, ok), counts = counted(
                        lambda: fast.detect(img, cfg, k),
                        {"fast_score_map": 1, "orient_fused": 1},
                        f"fast.detect, {what}")
                with recorded(de, "orient_fused") as r8_cpu:
                    xy_c, sc_c, th_c, ok_c = fast.detect(img.cpu(), cfg, k)
                for a, b, name in ((xy, xy_c, "xy"), (sc, sc_c, "score"),
                                   (ok, ok_c, "valid")):
                    equal_or_raise(a, b, f"fast.detect {name} card vs CPU, "
                                   f"{what}")
                # moments against the CPU's; theta against the plain
                # version on the card (the card's atan2f and the CPU's
                # atan2 are different libraries)
                mom, mom_c = r8[0][2][1][0], r8_cpu[0][2][1][0]
                s_abs = None if integer else abs_moment_sums(
                    extract_patches(img, xy))
                hold_moments(mom, mom_c, s_abs, integer,
                             f"fast.detect moments card vs CPU, {what}")
                th_p, mom_p = de.orient_fused_plain(img[None], xy[None])
                tol, _ = hold_theta(th, mom, th_p[0], mom_p[0], s_abs,
                                    integer, f"fast.detect theta, {what}")
                n_edge += int(near_bin_edge(th_p[0], tol).sum())
                cpu_ulps = max(cpu_ulps, ulps(th.cpu(), th_c))
                sm, c_sm = counted(lambda: brief.smooth(img, cfg),
                                   {"gaussian_blur7": 1}, "brief.smooth")
                desc, _ = counted(lambda: brief.describe(sm, xy, th), {},
                                  "brief.describe")
                _, c_or = counted(lambda: fast.orientations(img, xy),
                                  {"orient_fused": 1}, "fast.orientations")
                for c in (counts, c_sm, c_or):
                    for n, v in c.items():
                        total[n] += v
                if not integer and lvl == 0 and cam == 0:
                    first = {"fast_score_map": r11[0][:2],
                             "orient_fused": r8[0][:2]}
                xys.append(xy)
                ths.append((th, mom, desc))
            # K8 against K2 on the same keypoints, and brief against K2
            xy = torch.stack(xys).contiguous()
            th2, mom2, desc2 = de.describe_fused_pyramid_cuda(
                ops.flat_levels([lv]), ops.flat_levels([k1_blur]),
                ops._slabs_of([lv]), xy, ops._col_levels((k,), str(dev)))
            for cam, (th, mom, desc) in enumerate(ths):
                what = f"{kind} level {lvl} camera {cam}"
                equal_or_raise(th, th2[cam], f"K8 theta vs K2's, {what}")
                equal_or_raise(mom, mom2[cam], f"K8 moments vs K2's, {what}")
                equal_or_raise(desc, desc2[cam],
                               f"brief.describe(brief.smooth) vs K2, {what}")
        log(f"[single image/{kind}] 8 level images: K11 == plain, nms3(K11) "
            "== K1 score, K12 == plain (both quantized) == K1 blur, detect "
            "== CPU (xy, score, valid; moments by rule; theta by rule "
            f"against plain on the card, {n_edge} keypoints within its "
            f"tolerance of a bin edge; card vs CPU theta {cpu_ulps} ulp "
            "at most), "
            "K8 == K2 (theta, moments), describe(smooth) == K2 descriptors; "
            "launches detect 2, orientations 1, smooth 1, describe 0")
        # pin: detect on level 0 == extract_features with a 1-level config;
        # the single-image pyramid and extract_features on each camera
        for cam in range(images.shape[0]):
            img = images[cam]
            k0 = cfg1.features_per_level()[0]
            xy, _, th, _ = fast.detect(img, cfg1, k0)
            f1 = extract_features(img, cfg1)
            equal_or_raise(xy.float(), f1.xy, "detect xy vs extract_features")
            equal_or_raise(th, f1.theta, "detect theta vs extract_features")
            pyr, _ = counted(lambda: pyramid.build_pyramid(img, cfg), {},
                             "build_pyramid")
            equal_or_raise(pyr[0], levels[0][cam], "build_pyramid level 0")
            d1 = (pyr[1] - levels[1][cam]).abs()
            if float(d1.max()) > 1.0 or int((d1 > 0).sum()) * 10_000 > \
                    d1.numel():
                raise AssertionError("build_pyramid level 1 beyond the A2 "
                                     "rule of the batched pyramid")
            feats, _ = counted(
                lambda: extract_features(img, cfg),
                {"frontend_fused_pyramid": 1, "describe_fused_pyramid": 1},
                "extract_features")
            if int((d1 > 0).sum()) == 0:
                rows = slice(None)
            else:
                rows = slice(0, ks[0])
            for name in ("xy", "score", "theta", "desc", "valid"):
                equal_or_raise(getattr(feats, name)[rows],
                               getattr(batched, name)[cam][rows],
                               f"extract_features {name} vs the batched "
                               "extraction")
        log(f"[single image/{kind}] 4 cameras: detect on level 0 == "
            "extract_features (1 level) xy and theta; build_pyramid 0 "
            "launches; extract_features 2 launches (K1 + K2), equal to the "
            "batched extraction")

    # timings on the level-0 float inputs the wrappers received
    x, thr_in = first["fast_score_map"][0]
    raw, xy = first["orient_fused"][0]
    h, w = x.shape[1:]
    n = h * w
    stats = {}
    from repro_torch.kernels.ref import GAUSS7_WEIGHTS_INT
    wt = torch.tensor(GAUSS7_WEIGHTS_INT, dtype=torch.float32, device=dev)
    w2 = (wt[:, None] * wt[None, :]
          / torch.tensor(1296.0, device=dev)).view(1, 1, 7, 7)

    def conv_blur():
        return F.conv2d(F.pad(x[:, None], (3, 3, 3, 3), mode="replicate"),
                        w2)[:, 0]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_err = float((conv_blur() - gb.gaussian_blur7_cuda(
            x, False)).abs().max())
        lib_ms = time_ms(conv_blur)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for name, fn, plain, symbol, bound, lib in (
            ("fast_score_map", lambda: fd.fast_score_map_cuda(x, thr_in),
             lambda: fast_score_plain(x, thr_in), "fast_kernel",
             fast_bound(n * 2 * x.element_size(), n,
                        live_pixels(x, thr_in)),
             None),
            ("gaussian_blur7", lambda: gb.gaussian_blur7_cuda(x, True),
             lambda: blur_plain(x, True), "blur_kernel",
             bound_ms(n * 2 * x.element_size(),
                      pipes=scale_pipes(n, BLUR_PIPES_PER_PIXEL)),
             lib_ms),
            ("orient_fused", lambda: de.orient_fused_cuda(raw, xy),
             lambda: de.orient_fused_plain(raw, xy), "orient_kernel",
             orient_bound(raw, xy), None)):
        got, want = fn(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        st = dict(ms=time_ms(fn), device_ms=device_ms(fn, symbol),
                  plain_ms=time_ms(plain), max_abs_err=err, library_ms=lib)
        st["bound_ms"], st["bound_by"] = bound
        stats[name] = st
        log(f"[{name} 720p] {st['ms']:.4f} ms event, device "
            f"{st['device_ms']} ms, bound {st['bound_ms']:.6f} ms "
            f"({st['bound_by']}), plain {st['plain_ms']:.4f} ms, max abs err "
            f"{err}, library call: "
            + (f"F.conv2d {lib:.4f} ms (max |diff| {lib_err} from the "
               "unquantized blur)" if lib is not None else "none"))

    # the paper's module split (Tab. II), one 720p camera image
    img = torch.from_numpy(frame[0]).to(dev)
    level0 = pyramid.build_pyramid(img, cfg)[0]
    rng0, rng1 = np.random.RandomState(0), np.random.RandomState(1)
    pts = torch.from_numpy(np.stack(
        [rng0.randint(16, cfg.width - 16, 512),
         rng1.randint(16, cfg.height - 16, 512)], 1).astype(np.int32)).to(dev)
    sm = ops.gaussian_blur7(level0)
    zeros = torch.zeros(512, device=dev)
    split = {}
    for name, fn in (
            ("resize", lambda: pyramid.build_pyramid(img, cfg)),
            ("fast_detect", lambda: ops.fast_score_map(level0, thr)),
            ("orientation", lambda: fast.orientations(level0, pts)),
            ("smoothing", lambda: ops.gaussian_blur7(level0)),
            ("descriptor", lambda: brief.describe(sm, pts, zeros))):
        times = []
        for i in range(REPS + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        split[name] = statistics.median(times)
    tot = sum(split.values())
    log("[module split 720p] host ms (median of "
        f"{REPS}, each closed by a synchronize), 512 keypoints: "
        + ", ".join(f"{k} {v:.4f} ({v / tot:.3f})" for k, v in split.items()))
    return total, stats, split


def localized_phase(cfg, dev):
    """The localized path at full width (phase 6).  Returns the session
    and its frames, the launch counts of the loop, the inputs K4
    received in the loop's last frame and in the run, and the
    timings."""
    from repro_torch.core import PipelineConfig, RigConfig, VisualSystem
    from repro_torch.data import scenes
    from repro_torch.kernels import match_fused, ops
    from repro_torch.localization import MIN_CORRESPONDENCES
    from repro_torch.localization import pose as pose_mod
    seq = scenes.render_sequence(scenes.SceneConfig(
        height=cfg.height, width=cfg.width, n_points=1600, seed=0), SEQ_T)
    vs = VisualSystem(RigConfig.quad(seq.intrinsics),
                      PipelineConfig(orb=cfg, localize=True), device="cuda")
    frames = torch.from_numpy(seq.frames).to(dev)

    with recorded(match_fused) as k4_loop:
        loop, loop_counts = counted(
            lambda: [vs.process_frame(frames[t]) for t in range(SEQ_T)],
            {n: SEQ_T for n in LOC_KERNELS},
            "a localized frame launches K1-K4 once each")
    log(f"[localized loop] {SEQ_T} frames: launches {loop_counts}")
    for t, out in enumerate(loop):
        pose = out.pose
        if not (bool(torch.isfinite(pose.rotation).all())
                and bool(torch.isfinite(pose.translation).all())):
            raise AssertionError("non-finite pose")
        if t == 0:
            if bool(pose.valid) or not torch.equal(
                    pose.rotation, torch.eye(3, device=dev)):
                raise AssertionError("frame 0 must be identity + invalid")
        elif not (bool(pose.valid)
                  and int(pose.inliers) >= MIN_CORRESPONDENCES):
            raise AssertionError(f"frame {t}: no valid pose")
    log("[localized loop] inliers "
        f"{[int(o.pose.inliers) for o in loop]}, valid "
        f"{[bool(o.pose.valid) for o in loop]}")

    with recorded(match_fused) as k4_run:
        run, run_counts = counted(
            lambda: vs.run(frames),
            {**{n: SEQ_T for n in ops.FRAME_KERNELS}, "match_fused": 1},
            "a localized run is 3T + 1 launches")
    log(f"[localized run] T={SEQ_T}: launches {run_counts}")
    loop_pose = type(run.pose)(*[torch.stack(x) for x in zip(
        *[o.pose for o in loop])])
    err = close_poses(run.pose, loop_pose, 1e-5, "run vs process_frame loop")
    log(f"[localized run] poses equal the loop's within {err:.3e}")
    m = check_metrics(run.pose, seq.poses, LOC_LIMITS, "localized run 720p")

    # latency of a localized frame over 20 frames of a ping-pong stream
    order = list(range(SEQ_T)) + list(range(SEQ_T - 2, 0, -1))
    stream = [frames[order[i % len(order)]] for i in range(REPS + 3)]
    vs.reset_localization()
    lat = []
    for i, f in enumerate(stream):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vs.process_frame(f)
        torch.cuda.synchronize()
        if i >= 3:
            lat.append((time.perf_counter() - t0) * 1e3)
    # the stages of a localized frame, each closed by a synchronize
    stages = {"frontend (K1-K3)": [], "backend (points + K4 + solve)": [],
              "solve": []}
    prev = vs._loc_state["frame"]
    for f in stream[:REPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = vs._frame_core(f)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vs._localize_frame(out, prev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        stages["frontend (K1-K3)"].append((t1 - t0) * 1e3)
        stages["backend (points + K4 + solve)"].append((t2 - t1) * 1e3)
    pts = run.points[1]
    w = run.stereo.features_l.valid[1] & run.stereo.depth.valid[1]
    pp = pts.reshape(1, -1, 3)
    wf = w.reshape(1, -1).float()
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pose_mod.solve_pose_batched(pp, pp, wf)
        torch.cuda.synchronize()
        stages["solve"].append((time.perf_counter() - t0) * 1e3)
    syncs = {"frame": host_syncs(lambda: vs.process_frame(stream[0])),
             "backend": host_syncs(lambda: vs._localize_frame(out, prev)),
             "solve": host_syncs(
                 lambda: pose_mod.solve_pose_batched(pp, pp, wf))}
    frame_ms = statistics.median(lat)
    med = {k: statistics.median(v) for k, v in stages.items()}
    log(f"[localized frame] latency median {frame_ms:.4f} ms over {REPS} "
        f"frames (min {min(lat):.4f}, max {max(lat):.4f})")
    for k, v in med.items():
        log(f"[localized stages] {k}: {v:.4f} ms (median of {REPS})")
    log(f"[localized frame] solve share {med['solve'] / frame_ms:.4f}; "
        f"synchronizing calls (torch.cuda sync debug mode): {syncs}")
    return (vs, frames, loop_counts, k4_loop[-1][:2], k4_run[0][:2],
            dict(frame_ms=frame_ms, stages=med, metrics=m, host_syncs=syncs),
            seq.poses)


def host_syncs(fn) -> int:
    """How many synchronizing CUDA calls ``fn()`` makes, as PyTorch's
    sync debug mode reports them (it names the calls it detects; the
    mode is a prototype and may miss some)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(c.message)
               for c in caught)


def entry_points(card, cpu, source, frame0, frame1, pairs, what: str):
    """The session's matcher entry points on ``frame0``'s stereo
    ``pairs`` (``temporal_match``: each pair's left camera to
    ``frame1``), on features and caller-given matches from the session
    ``source``.  Each call on the ``card`` session is one launch of its
    kernel, with the counts set to 0 just before it, and equals the
    ``cpu`` session on the same inputs.  Returns the launches of each
    kernel summed over the calls, and the calls K4 (``stereo_match``)
    and K5 (``sad_rectify``) received."""
    from repro_torch.core.types import map_fields
    from repro_torch.kernels import match_fused, ops, sad_fused
    f0, f1 = source.extract(frame0), source.extract(frame1)
    total = dict.fromkeys(ops.KERNELS, 0)
    k4, k5 = [], []
    for cl, cr in pairs:
        fl, fr = (map_fields(lambda x: x[c], f0) for c in (cl, cr))
        fl1 = map_fields(lambda x: x[cl], f1)
        img_l, img_r = frame0[cl], frame0[cr]
        m = source.stereo_match(fl, fr)
        calls = {
            "stereo_match": ("match_fused",
                             lambda vs: vs.stereo_match(fl, fr)),
            "temporal_match": ("match_fused",
                               lambda vs: vs.temporal_match(fl, fl1)),
            "sad_rectify": ("sad_fused", lambda vs: vs.sad_rectify(
                img_l, img_r, fl, fr, m)),
            "match_pair": ("match_rectify_fused",
                           lambda vs: vs.match_pair(img_l, img_r, fl, fr)),
        }
        for name, (kernel, call) in calls.items():
            with recorded(match_fused) as r4, recorded(sad_fused) as r5:
                got, counts = counted(lambda: call(card), {kernel: 1},
                                      f"{name}: one launch")
            for n, c in counts.items():
                total[n] += c
            if name == "stereo_match":
                k4 += r4
            if name == "sad_rectify":
                k5 += r5
            equal_fields(got, call(cpu), f"{name} vs the CPU session")
            log(f"[entry points/{what}] {name} pair ({cl}, {cr}): "
                f"1 launch ({kernel} {counts[kernel]}), equal to "
                "the CPU session: True")
    return total, k4, k5


def check_recorded(calls, plain, what: str) -> float:
    """Each recorded call's output (the kernel's, on the path) bit-equal
    to ``plain`` on the same inputs; returns the largest |difference|,
    which is then 0."""
    for args, kwargs, out in calls:
        want = plain(*args, **kwargs)
        got = out if isinstance(out, tuple) else (out,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            equal_or_raise(a, b, f"{what} vs its plain version")
    return 0.0


UNFUSED_KERNELS = ("hamming_match", "sad_search")


def unfused_phase(card, frame0, images, intr, out4):
    """The unfused FM schedule at full width (phase 8): on the first
    frame of the 720p sequence (features from the ``card`` session, as
    in phase 7), both stereo pairs, the frame as rendered and rounded to
    integers.  ``stereo_match_unfused`` is 1 launch of K9,
    ``sad_rectify_unfused`` 1 of K10 and ``match_pair_unfused`` 1 of
    each, every count set to 0 just before the call; the unfused
    MatchSet and DepthSet are bit-equal to row p of ``match_pair_fused``
    (K3), to the session's ``stereo_match`` (K4) and ``sad_rectify``
    (K5) and to the same calls on CPU tensors.  K9 and K10 are held
    bit-equal to their plain versions on every input their wrappers
    received, and timed on pair 0's float inputs.  Last, the legacy
    ``process_quad_frame`` on phase 4's frame (``images``, ``intr``):
    3 launches, a ``DeprecationWarning``, and equal to phase 4's
    ``process_frame`` output ``out4``.  Returns (the launches of each
    kernel summed over the counted calls, the K9 and K10 stats)."""
    import warnings
    from repro_torch.core import ORBConfig, frontend, matching
    from repro_torch.core.types import map_fields
    from repro_torch.kernels import hamming_match as hm
    from repro_torch.kernels import ops
    from repro_torch.kernels import sad_rectify as sr
    cfg = card.pipe.orb
    pair_intr = card.rig.pair_intrinsics[0]
    li = [cl for cl, _ in card.rig.pairs]
    ri = [cr for _, cr in card.rig.pairs]
    feats = card.extract(frame0)
    fl_all = map_fields(lambda x: x[li], feats)
    fr_all = map_fields(lambda x: x[ri], feats)
    total = dict.fromkeys(ops.KERNELS, 0)
    k9, k10 = [], []
    for kind in ("float", "integer"):
        frame = frame0 if kind == "float" else torch.round(frame0)
        mf, df = matching.match_pair_fused(frame[li], frame[ri], fl_all,
                                           fr_all, cfg, card._fm_intr(1))
        for p, (cl, cr) in enumerate(card.rig.pairs):
            what = f"{kind} pair ({cl}, {cr})"
            fl = map_fields(lambda x: x[p], fl_all)
            fr = map_fields(lambda x: x[p], fr_all)
            img_l, img_r = frame[cl], frame[cr]
            with recorded(hm) as r9:
                m, c9 = counted(
                    lambda: matching.stereo_match_unfused(fl, fr, cfg),
                    {"hamming_match": 1}, f"stereo_match_unfused, {what}")
            with recorded(sr, "sad_search") as r10:
                d, c10 = counted(
                    lambda: matching.sad_rectify_unfused(
                        img_l, img_r, fl, fr, m, cfg, pair_intr),
                    {"sad_search": 1}, f"sad_rectify_unfused, {what}")
            with recorded(hm) as r9b, recorded(sr, "sad_search") as r10b:
                (mu, du), cu = counted(
                    lambda: matching.match_pair_unfused(
                        img_l, img_r, fl, fr, cfg, pair_intr),
                    dict.fromkeys(UNFUSED_KERNELS, 1),
                    f"match_pair_unfused, {what}")
            for c in (c9, c10, cu):
                for n, v in c.items():
                    total[n] += v
            k9 += r9 + r9b
            k10 += r10 + r10b
            equal_fields(mu, m, f"match_pair_unfused vs stereo_match_unfused,"
                         f" {what}")
            equal_fields(du, d, f"match_pair_unfused vs sad_rectify_unfused, "
                         f"{what}")
            equal_fields(mu, map_fields(lambda x: x[p], mf),
                         f"unfused vs fused (K3) matches, {what}")
            equal_fields(du, map_fields(lambda x: x[p], df),
                         f"unfused vs fused (K3) depth, {what}")
            equal_fields(mu, card.stereo_match(fl, fr),
                         f"unfused vs stereo_match (K4), {what}")
            equal_fields(du, card.sad_rectify(img_l, img_r, fl, fr, mu),
                         f"unfused vs sad_rectify (K5), {what}")
            mc, dc = matching.match_pair_unfused(
                img_l.cpu(), img_r.cpu(), map_fields(lambda x: x.cpu(), fl),
                map_fields(lambda x: x.cpu(), fr), cfg, pair_intr)
            equal_fields(mu, mc, f"unfused card vs CPU matches, {what}")
            equal_fields(du, dc, f"unfused card vs CPU depth, {what}")
            log(f"[unfused/{what}] stereo_match_unfused 1 launch (K9), "
                "sad_rectify_unfused 1 (K10), match_pair_unfused 2; equal to "
                "fused (K3), stereo_match (K4), sad_rectify (K5) and the CPU; "
                f"{int(mu.valid.sum())} matches, {int(du.valid.sum())} "
                "depths")
            if int(du.valid.sum()) == 0:
                raise AssertionError(f"unfused schedule found no depth, "
                                     f"{what}")
    err9 = check_recorded(k9, hm.hamming_match_plain, "K9")
    err10 = check_recorded(k10, sr.sad_search_plain, "K10")
    log(f"[unfused] K9 == plain on all {len(k9)} inputs its wrapper "
        f"received, K10 == plain on all {len(k10)}")

    # K9 and K10 timed on pair 0's float inputs
    args9, kw9, _ = k9[0]
    args10, _, _ = k10[0]
    k, m = args9[0].shape[0], args9[2].shape[0]
    in_region = int((hm.masked_hamming(*args9, **kw9) < hm.BIG).sum())
    kp, p = args10[0].shape[0], args10[0].shape[1]
    sweep = args10[1].shape[-1] - p + 1
    stats = {}
    n_window = args10[0].numel() + args10[1].numel()
    for name, fn, plain, symbol, nbytes, pipes, err in (
            ("hamming_match", lambda: hm.hamming_match_cuda(*args9, **kw9),
             lambda: hm.hamming_match_plain(*args9, **kw9),
             "hamming_argmin_kernel", (k + m) * (32 + 16) + k * 8,
             band_search_pipes(args9[1], args9[3], **kw9), err9),
            ("sad_search", lambda: sr.sad_search_cuda(*args10),
             lambda: sr.sad_search_plain(*args10), "sad_search_kernel",
             n_window * args10[0].element_size() + kp * sweep * 4,
             sad_pipes(kp * sweep * p * p, n_window), err10)):
        st = dict(ms=time_ms(fn), device_ms=device_ms(fn, symbol),
                  plain_ms=time_ms(plain), max_abs_err=err)
        st["bound_ms"], st["bound_by"] = bound_ms(nbytes, pipes=pipes)
        stats[name] = st
        log(f"[{name} 720p pair] {st['ms']:.4f} ms event, device "
            f"{st['device_ms']} ms, bound {st['bound_ms']:.6f} ms "
            f"({st['bound_by']}), plain {st['plain_ms']:.4f} ms, library "
            "call: none")
    log(f"[unfused] K9 shapes K={k} M={m} ({in_region} pairs in the search "
        f"region); K10 shapes K={kp} P={p} sweep={sweep}")

    # the legacy frame shim on phase 4's frame
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        quad, _ = counted(
            lambda: frontend.process_quad_frame(images, ORBConfig(), intr),
            dict.fromkeys(ops.FRAME_KERNELS, 1), "process_quad_frame")
    if not any(issubclass(w.category, DeprecationWarning)
               and str(w.message).startswith("repro_torch.") for w in caught):
        raise AssertionError("process_quad_frame did not warn")
    equal_fields(quad, out4, "process_quad_frame vs process_frame")
    log("[legacy] process_quad_frame: 3 launches, a DeprecationWarning, "
        "equal to phase 4's process_frame")
    return total, stats


PER_LEVEL_KERNELS = ("frontend_fused", "describe_fused")


def per_level_phase(frame, cfg, dev):
    """The per-level FE schedule at full width (phase 10), on phase 4's
    quad frame rounded to integers and as rendered.
    ``extract_features_per_level`` is exactly ``cfg.n_levels`` launches
    of the per-level dense FE (K6) and as many of the per-level sparse
    FE (K7), with the counts set to 0 just before; its FeatureSet is
    bit-equal to ``extract_features_batched`` (K1 + K2), the JAX
    package's own pin, and equals the same call on CPU tensors (xy,
    level, score and valid bit-equal, moments and theta by the module
    note's rule, descriptors equal wherever the steering bins agree).
    K6 is held bit-equal, and K7 by the sparse FE's rule, to its plain
    version on every input its wrapper received there; both are timed
    on each level's float inputs.  Last, the paper's frame-multiplexing
    comparison (the JAX package's ``table_whole_frame_vs_per_level``):
    the host ms of either schedule, each call closed by a synchronize,
    and the device ms of its FE kernels.  Returns (the launches of each
    kernel summed over the counted calls, the K6 and K7 stats, the
    comparison)."""
    from repro_torch.core.orb import (extract_features_batched,
                                      extract_features_per_level)
    from repro_torch.kernels import describe_fused as de
    from repro_torch.kernels import frontend_fused as fe
    from repro_torch.kernels import ops
    n_lv = cfg.n_levels
    total = dict.fromkeys(ops.KERNELS, 0)
    k6, k7 = [], {}
    for kind, integer in (("integer", True), ("float", False)):
        images = torch.from_numpy(np.round(frame) if integer
                                  else frame).to(dev).contiguous()
        with recorded(fe) as r6, recorded(de) as r7:
            per, counts = counted(
                lambda: extract_features_per_level(images, cfg),
                dict.fromkeys(PER_LEVEL_KERNELS, n_lv),
                f"extract_features_per_level, {kind}")
        for n, v in counts.items():
            total[n] += v
        k6 += r6
        k7[kind] = r7
        whole, _ = counted(
            lambda: extract_features_batched(images, cfg),
            {"frontend_fused_pyramid": 1, "describe_fused_pyramid": 1},
            f"extract_features_batched, {kind}")
        equal_fields(per, whole, f"per-level vs whole-frame (K1 + K2), {kind}")
        with recorded(de) as r7_cpu:
            cpu = extract_features_per_level(images.cpu(), cfg)
        for name in ("xy", "level", "score", "valid"):
            equal_or_raise(getattr(per, name), getattr(cpu, name),
                           f"per-level {name} card vs CPU, {kind}")
        n_edge = n_bins = cpu_ulps = 0
        for lvl, ((args, _, out), (_, _, out_c)) in enumerate(zip(r7,
                                                                 r7_cpu)):
            s_abs = None if integer else abs_moment_sums(
                de.level_patches(args[0], args[2]))
            _, d_ulps, edge, differ = hold_sparse(
                out, out_c, s_abs, integer,
                f"per-level sparse FE card vs CPU, {kind} level {lvl}",
                same_library=False)
            n_edge += edge
            n_bins += differ
            cpu_ulps = max(cpu_ulps, d_ulps)
        log(f"[per-level/{kind}] {n_lv} + {n_lv} launches (K6, K7); "
            "FeatureSet == extract_features_batched (K1 + K2), every field; "
            "== the CPU call (xy, level, score, valid; moments and theta by "
            f"rule, card vs CPU theta {cpu_ulps} ulp at most; {n_edge} "
            f"keypoints within the tolerance of a bin edge, {n_bins} bins "
            f"differ; descriptors equal where the bins agree); "
            f"{int(per.valid.sum())} valid features")

    err6 = check_recorded(k6, fe.frontend_fused_plain, "K6")
    err7 = 0.0
    for kind, calls in k7.items():
        for args, _, out in calls:
            s_abs = None if kind == "integer" else abs_moment_sums(
                de.level_patches(args[0], args[2]))
            err, _, _, _ = hold_sparse(out, de.describe_fused_plain(*args),
                                       s_abs, kind == "integer",
                                       f"K7 vs its plain version, {kind}")
            err7 = max(err7, err)
    log(f"[per-level] K6 == plain on all {len(k6)} inputs its wrapper "
        f"received, K7 held to plain by the sparse rule on all "
        f"{sum(len(c) for c in k7.values())} (max |d moment| {err7})")

    # K6 and K7 timed on each level's float inputs; the row's own
    # numbers are level 0's
    f6 = k6[n_lv:]
    f7 = k7["float"]
    stats = {}
    for name, calls, cuda, plain, symbol, err, bound in (
            ("frontend_fused", f6, fe.frontend_fused_cuda,
             fe.frontend_fused_plain, "frontend_level_kernel", err6,
             lambda args, kw, out: dense_bound(
                 args[0], *out, live_pixels(args[0], kw["threshold"]))),
            ("describe_fused", f7, de.describe_fused_cuda,
             de.describe_fused_plain, "describe_level_kernel", err7,
             lambda args, kw, out: sparse_bound([(args[0], args[2])]))):
        per = []
        for args, kw, out in calls:
            per.append(dict(
                ms=time_ms(lambda: cuda(*args, **kw)),
                device_ms=device_ms(lambda: cuda(*args, **kw), symbol),
                plain_ms=time_ms(lambda: plain(*args, **kw)),
                bound=bound(args, kw, out)))
        st = dict(per[0], max_abs_err=err, bound_ms=per[0]["bound"][0],
                  bound_by=per[0]["bound"][1])
        del st["bound"]
        for key in ("ms", "device_ms", "plain_ms"):
            st[f"{key}_levels"] = [lv[key] for lv in per]
        st["bound_ms_levels"] = [lv["bound"][0] for lv in per]
        stats[name] = st
        for lvl, (lv, (args, _, _)) in enumerate(zip(per, calls)):
            log(f"[{name} level {lvl}] inputs {tuple(args[0].shape)}"
                + (f", keypoints {tuple(args[2].shape)}" if len(args) > 2
                   else "")
                + f": {lv['ms']:.4f} ms event, device {lv['device_ms']} ms, "
                f"bound {lv['bound'][0]:.6f} ms ({lv['bound'][1]}), plain "
                f"{lv['plain_ms']:.4f} ms, library call: none")

    # the paper's frame-multiplexing comparison, the float frame
    images = torch.from_numpy(frame).to(dev).contiguous()
    schedules = {
        "per_level": (lambda: extract_features_per_level(images, cfg),
                      ("frontend_level_kernel", "describe_level_kernel"),
                      2 * n_lv),
        "whole_frame": (lambda: extract_features_batched(images, cfg),
                        ("frontend_kernel", "describe_kernel"), 2)}
    host = {name: [] for name in schedules}
    for fn, _, _ in schedules.values():
        fn()
    for _ in range(REPS):
        for name, (fn, _, _) in schedules.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) * 1e3)
    cmp = {}
    for name, (fn, symbols, n) in schedules.items():
        cmp[f"{name}_host_ms"] = statistics.median(host[name])
        times = profiled_ms(fn, symbols)
        cmp[f"{name}_fe_device_ms"] = sum(times) / REPS if times else None
        cmp[f"{name}_launches"] = n
    log(f"[per-level vs whole frame] {tuple(images.shape)} float frame, "
        f"host ms median of {REPS} (each closed by a synchronize): per-level "
        f"{cmp['per_level_host_ms']:.4f} ({cmp['per_level_launches']} "
        f"launches), whole frame {cmp['whole_frame_host_ms']:.4f} "
        f"({cmp['whole_frame_launches']}); FE kernels' device ms a call: "
        f"per-level {cmp['per_level_fe_device_ms']}, whole frame "
        f"{cmp['whole_frame_fe_device_ms']}")
    return total, stats, cmp


def small_sequence_phase():
    """The card's localized session against the CPU session (phase 9)."""
    from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                                  VisualSystem)
    from repro_torch.data import scenes
    from repro_torch.kernels import match_fused
    seq = scenes.render_sequence(scenes.SceneConfig(
        height=96, width=128, baseline=0.5, seed=1), 4,
        step_t=(0.25, 0.0, 0.1), yaw_per_frame=0.0)
    frames = np.round(seq.frames)
    pipe = PipelineConfig(orb=ORBConfig(height=96, width=128,
                                        max_features=96, fast_threshold=15),
                          localize=True)
    rig = RigConfig.quad(seq.intrinsics)
    card = VisualSystem(rig, pipe, device="cuda")
    cpu = VisualSystem(rig, pipe, device="cpu")
    with recorded(match_fused) as k4_card:
        rg = card.run(frames)
        torch.cuda.synchronize()
    with recorded(match_fused) as k4_cpu:
        rc = cpu.run(frames)
    dg, dc = k4_card[0][2], k4_cpu[0][2]
    if not all(torch.equal(a.cpu(), b) for a, b in zip(dg, dc)):
        raise AssertionError("card and CPU temporal matches differ")
    err = close_poses(rg.pose, rc.pose, 1e-4, "card vs CPU localized run")
    log(f"[small sequence] temporal dist/idx equal "
        f"({int((dc[1] >= 0).sum())} candidates), pose valid equal "
        f"{rc.pose.valid.tolist()}, poses within {err:.3e}")
    check_metrics(rg.pose, seq.poses, SMALL_LIMITS, "small sequence, card")
    check_metrics(rc.pose, seq.poses, SMALL_LIMITS, "small sequence, CPU")
    entry_points(card, cpu, cpu, frames[0], frames[1], rig.pairs[:1],
                 "96x128")




def counted_u8(fn, want: dict, want_u8: dict, what: str, total: dict):
    """``counted``, and the launches of the uint8 variants exactly
    ``want_u8`` ({kernel: count}), which are added to ``total``.
    Returns the output."""
    out, _ = counted(fn, want, what)
    got = {n: c for n, c in read_u8_counts().items() if c}
    if got != want_u8:
        raise AssertionError(f"{what}: uint8 variant launches {got}, "
                             f"expected {want_u8}")
    for n, c in got.items():
        total[n] += c
    return out


def uint8_phase(frame, intr, seq_rig, seq_frames, seq_poses, cfg, dev):
    """The uint8 datapath at full width (phase 11), on phase 4's quad
    frame (``intr`` its intrinsics) and phase 6's sequence (on its rig
    ``seq_rig``), rounded to uint8.  Each entry point
    runs with every count set to 0 just before it and read just after,
    and launches its kernels' uint8 variants: ``process_frame`` 3 (K1,
    K2, K3), ``extract`` 2, ``match_pair`` 1 (K3), ``sad_rectify`` 1
    (K5), ``fast.detect`` on each of the 8 uint8 level images 2 (K11,
    float, and K8), ``extract_features_per_level`` 2 a level (K6, K7), a
    localized frame 4 (K4 unchanged) and a localized ``run`` 3T + 1.
    Each output is bit-equal to the quantized-f32 session's (or call's)
    on the same integer-valued frame; the localized run's poses equal
    the f32 run's within 1e-5 and pass phase 6's ATE/RPE limits.  Every
    input a variant's wrapper received is held against its plain version
    (dense, K3, K5 bit-equal; K2, K7, K8 by the sparse rule with theta
    within 1 ulp, one library) and against its float kernel on the
    float copy (bit-equal, theta too).  Then each variant and its float
    kernel are timed on the same inputs (events, ``torch.profiler``,
    plain version, bound), the uint8 and f32 frames' latency in turns,
    and each session's device time by kernel over 5 frames.  Returns (the uint8 launches of each kernel summed over the
    counted calls, the timing rows, the latencies)."""
    from repro_torch.core import (PipelineConfig, RigConfig, VisualSystem,
                                  fast, pyramid)
    from repro_torch.core.orb import (extract_features_batched,
                                      extract_features_per_level)
    from repro_torch.core.types import map_fields
    from repro_torch.kernels import describe_fused as de
    from repro_torch.kernels import frontend_fused as fe
    from repro_torch.kernels import matcher_fused as mf
    from repro_torch.kernels import ops
    from repro_torch.kernels import sad_fused as so
    rig = RigConfig.quad(intr)
    f32 = VisualSystem(rig, PipelineConfig(orb=cfg), device="cuda")
    u8 = VisualSystem(rig, PipelineConfig(orb=cfg, precision="uint8"),
                      device="cuda")
    img_u8 = torch.from_numpy(np.clip(np.round(frame), 0, 255)
                              .astype(np.uint8)).to(dev)
    img_f = img_u8.float()
    total = dict.fromkeys(ops.KERNELS, 0)
    frame_k = {n: 1 for n in ops.FRAME_KERNELS}
    with recorded(fe, "frontend_fused_pyramid") as r1, \
            recorded(de, "describe_fused_pyramid") as r2, \
            recorded(mf, "match_rectify_fused") as r3:
        out = counted_u8(lambda: u8.process_frame(img_u8), frame_k,
                         frame_k, "uint8 process_frame", total)
    equal_fields(out, f32.process_frame(img_f),
                 "uint8 process_frame vs the f32 session")
    for t in (out.features_l.theta, out.depth.depth, out.depth.disparity):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("uint8 process_frame: non-finite output")
    nd = out.depth.valid.sum(-1).tolist()
    if min(nd) < 1:
        raise AssertionError("uint8 process_frame: a pair has no depth")
    log(f"[uint8 frame] 3 launches, each a uint8 variant (K1, K2, K3); "
        "every StereoOutput field bit-equal to the f32 session's on the "
        f"same integer-valued frame; depths per pair {nd}")

    two = {"frontend_fused_pyramid": 1, "describe_fused_pyramid": 1}
    feats = counted_u8(lambda: u8.extract(img_u8), two, two,
                       "uint8 extract", total)
    equal_fields(feats, f32.extract(img_f), "uint8 extract vs f32")
    one3 = {"match_rectify_fused": 1}
    one5 = {"sad_fused": 1}
    r5 = []
    for cl, cr in rig.pairs:
        fl, fr = (map_fields(lambda x: x[c], feats) for c in (cl, cr))
        got = counted_u8(lambda: u8.match_pair(img_u8[cl], img_u8[cr],
                                               fl, fr),
                         one3, one3, "uint8 match_pair", total)
        equal_fields(got, f32.match_pair(img_f[cl], img_f[cr], fl, fr),
                     "uint8 match_pair vs f32")
        m = u8.stereo_match(fl, fr)
        with recorded(so) as rec:
            got = counted_u8(lambda: u8.sad_rectify(
                img_u8[cl], img_u8[cr], fl, fr, m), one5, one5,
                "uint8 sad_rectify", total)
        r5 += rec
        equal_fields(got, f32.sad_rectify(img_f[cl], img_f[cr], fl, fr, m),
                     "uint8 sad_rectify vs f32")
    log("[uint8 entry points] extract 2 launches (K1, K2), match_pair 1 "
        "(K3) and sad_rectify 1 (K5) a pair, each its uint8 variant, "
        "equal to the f32 session's")

    # fast.detect (K11 on the float cast, K8's uint8 variant) on the 8
    # uint8 level images; equal to the float level's call
    levels = pyramid.build_pyramid_batched(img_u8, cfg, precision="uint8")
    ks = cfg.features_per_level()
    r8 = []
    for lvl, (lv, k) in enumerate(zip(levels, ks)):
        for cam in range(lv.shape[0]):
            img = lv[cam]
            with recorded(de, "orient_fused") as rec:
                got = counted_u8(
                    lambda: fast.detect(img, cfg, k),
                    {"fast_score_map": 1, "orient_fused": 1},
                    {"orient_fused": 1}, "uint8 fast.detect", total)
            r8 += rec
            equal_fields(got, fast.detect(img.float(), cfg, k),
                         f"uint8 fast.detect level {lvl} camera {cam}")
    log("[uint8 detect] 8 level images: fast.detect 2 launches (K11, K8's "
        "uint8 variant), equal to the float level's (xy, score, theta, "
        "valid)")

    n_lv = cfg.n_levels
    per_k = {"frontend_fused": n_lv, "describe_fused": n_lv}
    with recorded(fe) as r6, recorded(de) as r7:
        per = counted_u8(
            lambda: extract_features_per_level(img_u8, cfg,
                                               precision="uint8"),
            per_k, per_k, "uint8 extract_features_per_level", total)
    whole = extract_features_batched(img_u8, cfg, precision="uint8")
    equal_fields(per, whole, "uint8 per-level vs whole frame")
    equal_fields(per, extract_features_batched(img_f, cfg),
                 "uint8 per-level vs the f32 whole frame")
    log(f"[uint8 per-level] {n_lv} + {n_lv} launches (K6, K7 uint8 "
        "variants), FeatureSet bit-equal to extract_features_batched "
        "(uint8 and f32)")

    # the localized sequence
    seq_u8 = torch.round(seq_frames).clamp(0, 255).to(torch.uint8)
    pipe = PipelineConfig(orb=cfg, localize=True)
    loc_f = VisualSystem(seq_rig, pipe, device="cuda")
    loc_u8 = VisualSystem(seq_rig,
                          dataclasses.replace(pipe, precision="uint8"),
                          device="cuda")
    t_seq = seq_u8.shape[0]
    loop = counted_u8(
        lambda: [loc_u8.process_frame(seq_u8[t]) for t in range(t_seq)],
        {n: t_seq for n in LOC_KERNELS},
        {n: t_seq for n in ops.FRAME_KERNELS}, "uint8 localized frames",
        total)
    run = counted_u8(
        lambda: loc_u8.run(seq_u8),
        {**{n: t_seq for n in ops.FRAME_KERNELS}, "match_fused": 1},
        {n: t_seq for n in ops.FRAME_KERNELS}, "uint8 localized run", total)
    run_f = loc_f.run(seq_u8.float())
    equal_fields(run.stereo, run_f.stereo, "uint8 run vs f32 run")
    err_f = close_poses(run.pose, run_f.pose, 1e-5, "uint8 run vs f32 run")
    loop_pose = type(run.pose)(*[torch.stack(x) for x in zip(
        *[o.pose for o in loop])])
    err_l = close_poses(run.pose, loop_pose, 1e-5,
                        "uint8 run vs its frame loop")
    m = check_metrics(run.pose, seq_poses, LOC_LIMITS,
                      "uint8 localized run 720p")
    log(f"[uint8 localized] 4 launches a frame, run 3T + 1; poses within "
        f"{err_f:.3e} of the f32 run and {err_l:.3e} of the frame loop")

    # every input a variant received: against its plain version, and
    # against its float kernel on the float copy
    def as_float(args, idx):
        return tuple(a.float() if i in idx else a for i, a in enumerate(args))

    table = {
        "frontend_fused_pyramid": (r1, fe.frontend_fused_pyramid_cuda,
                                   fe.frontend_fused_pyramid_plain, (0,),
                                   "frontend_kernel"),
        "describe_fused_pyramid": (r2, de.describe_fused_pyramid_cuda,
                                   de.describe_fused_pyramid_plain, (0, 1),
                                   "describe_kernel"),
        "match_rectify_fused": (r3, mf.match_rectify_fused_cuda,
                                mf.match_rectify_fused_plain, (4, 5),
                                "match_kernel"),
        "sad_fused": (r5, so.sad_fused_cuda, so.sad_fused_plain, (0, 1),
                      "sad_only_kernel"),
        "frontend_fused": (r6, fe.frontend_fused_cuda,
                           fe.frontend_fused_plain, (0,),
                           "frontend_level_kernel"),
        "describe_fused": (r7, de.describe_fused_cuda,
                           de.describe_fused_plain, (0, 1),
                           "describe_level_kernel"),
        "orient_fused": (r8, de.orient_fused_cuda, de.orient_fused_plain,
                         (0,), "orient_kernel"),
    }
    sparse = ("describe_fused_pyramid", "describe_fused", "orient_fused")
    errs = {}
    for name, (calls, cuda, plain, idx, _) in table.items():
        err = 0.0
        for args, kw, got in calls:
            want = plain(*args, **kw)
            flt = cuda(*as_float(args, idx), **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            flt = flt if isinstance(flt, tuple) else (flt,)
            what = f"{name} uint8 variant vs plain"
            if name == "orient_fused":
                hold_theta(got[0], got[1], want[0], want[1], None, True,
                           what)
            elif name in sparse:
                hold_sparse(got, want, None, True, what)
            if name in sparse:
                err = max(err, float((got[0] - want[0]).abs().max()),
                          float((got[1] - want[1]).abs().max()))
            else:
                for a, b in zip(got, want):
                    equal_or_raise(a, b, what)
            for a, b in zip(got, flt):
                equal_or_raise(a.to(b.dtype), b,
                               f"{name} uint8 variant vs the float kernel")
        errs[name] = err
        log(f"[uint8 {name}] {len(calls)} inputs: == plain"
            + (" (moments equal, theta within 1 ulp, descriptors by the "
               "bins)" if name in sparse else "")
            + ", == the float kernel on the float copy (bit-equal)")

    # timings: each variant and its float kernel on the same inputs
    first = {name: (stacked(calls) if name == "sad_fused" else calls[0][:2])
             for name, (calls, *_rest) in table.items()}

    def bound_of(name, args, kw, out):
        if name in ("frontend_fused_pyramid", "frontend_fused"):
            slabs = args[1] if name == "frontend_fused_pyramid" else None
            return dense_bound(args[0], *out, live_pixels(
                args[0], kw["threshold"], slabs))
        if name == "describe_fused_pyramid":
            return sparse_bound(pyramid_pairs(args[0], args[2], args[3],
                                              args[4]))
        if name == "describe_fused":
            return sparse_bound([(args[0], args[2])])
        if name == "orient_fused":
            return orient_bound(args[0], args[1])
        if name == "match_rectify_fused":
            return matcher_bound(args, out[2], kw)
        return sad_bound(args, kw)

    stats = {}
    for name, (calls, cuda, plain, idx, symbol) in table.items():
        args, kw = first[name]
        fargs = as_float(args, idx)
        st = {}
        for key, a in (("", args), ("float_", fargs)):
            out = cuda(*a, **kw)
            out = out if isinstance(out, tuple) else (out,)
            st[f"{key}ms"] = time_ms(lambda: cuda(*a, **kw))
            st[f"{key}device_ms"] = device_ms(lambda: cuda(*a, **kw), symbol)
            st[f"{key}plain_ms"] = time_ms(lambda: plain(*a, **kw))
            st[f"{key}bound_ms"], st[f"{key}bound_by"] = bound_of(
                name, a, kw, out)
        st["max_abs_err"] = float(errs[name])
        stats[name] = st
        log(f"[uint8 {name}] {st['ms']:.4f} ms event, device "
            f"{st['device_ms']} ms, bound {st['bound_ms']:.6f} ms "
            f"({st['bound_by']}), plain {st['plain_ms']:.4f} ms; float "
            f"kernel on the same values: {st['float_ms']:.4f} ms event, "
            f"device {st['float_device_ms']} ms, bound "
            f"{st['float_bound_ms']:.6f} ms ({st['float_bound_by']}), plain "
            f"{st['float_plain_ms']:.4f} ms")

    # frame latency, the uint8 and the f32 session in turns
    lat = {"f32": [], "uint8": []}
    turns = (("f32", f32, img_f), ("uint8", u8, img_u8))
    for _, vs, img in turns:
        for _ in range(3):
            vs.process_frame(img)
    for _ in range(REPS):
        for name, vs, img in turns:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vs.process_frame(img)
            torch.cuda.synchronize()
            lat[name].append((time.perf_counter() - t0) * 1e3)
    latency = {f"{k}_frame_ms_median": statistics.median(v)
               for k, v in lat.items()}
    for name, vs, img in turns:
        log(f"[uint8 vs f32 frame] the {name} session's device profile:")
        prof = profile_frames(vs, img)
        latency[f"{name}_device_busy_ms"] = (sum(prof.values()) if prof
                                             else None)
    latency["localized_metrics"] = m
    log(f"[uint8 vs f32 frame] latency median of {REPS} in turns: uint8 "
        f"{latency['uint8_frame_ms_median']:.4f} ms, f32 "
        f"{latency['f32_frame_ms_median']:.4f} ms; device busy a frame: "
        f"uint8 {latency['uint8_device_busy_ms']}, f32 "
        f"{latency['f32_device_busy_ms']} ms")
    return total, stats, latency


FLEET_RIGS = 8
FLEET_SIZES = (1, 2, 4, 8)
FLEET_LOC_RIGS = 4
FLEET_BIG = (16, 32)


def rig_slice(out, r):
    """Rig ``r`` of a fleet output (its leading axis)."""
    from repro_torch.core.types import map_fields
    return map_fields(lambda x: x[r], out)


def hold_fleet_card_vs_cpu(got, want, what: str) -> int:
    """A card ``StereoOutput`` against the CPU session's on the same
    integer-valued frames and pyramid levels: xy, level, score and valid
    bit-equal, theta within 2 ulp (the card's ``atan2f`` against the
    CPU's ``atan2``), descriptors equal away from a bin edge (4 ulp),
    and, where no descriptor differs, every match and depth field equal.
    Returns the count of descriptors that differ at a bin edge."""
    from repro_torch.core.types import map_fields
    got = map_fields(lambda x: x.cpu(), got)
    n_diff = 0
    for side in ("features_l", "features_r"):
        fg, fc = getattr(got, side), getattr(want, side)
        for name in ("xy", "level", "score", "valid"):
            equal_or_raise(getattr(fg, name), getattr(fc, name),
                           f"{what} {side}.{name}")
        if ulps(fg.theta, fc.theta) > 2:
            raise AssertionError(f"{what}: theta differs by over 2 ulp")
        edge = near_bin_edge(fc.theta, 4.0 * torch.from_numpy(
            np.spacing(np.abs(fc.theta.numpy()))))
        diff = (fg.desc != fc.desc).any(-1)
        if bool((diff & ~edge).any()):
            raise AssertionError(f"{what}: descriptors differ away from a "
                                 "bin edge")
        n_diff += int(diff.sum())
    if n_diff == 0:
        equal_fields(got.matches, want.matches, f"{what} matches")
        equal_fields(got.depth, want.depth, f"{what} depth")
    return n_diff


def hold_path_calls(calls: dict, what: str) -> float:
    """Every input that K1-K4's dispatchers received on a path
    (``calls``: kernel name -> ``recorded`` calls) held against the
    kernel's plain version on the card: the dense FE and both matchers
    bit-equal, the sparse FE by the module note's rule (integer-valued
    slabs when every raw pixel is an integer).  Returns the largest
    moment difference."""
    from repro_torch.kernels import describe_fused as de
    from repro_torch.kernels import frontend_fused as fe
    from repro_torch.kernels import match_fused as mo
    from repro_torch.kernels import matcher_fused as mf
    plain = {"frontend_fused_pyramid": fe.frontend_fused_pyramid_plain,
             "describe_fused_pyramid": de.describe_fused_pyramid_plain,
             "match_rectify_fused": mf.match_rectify_fused_plain,
             "match_fused": mo.match_fused_plain}
    err = 0.0
    for name, recs in calls.items():
        if name != "describe_fused_pyramid":
            check_recorded(recs, plain[name], f"{what} {name}")
            continue
        for args, kw, got in recs:
            raw, _, slabs, xy, col = args
            integer = (raw.dtype == torch.uint8
                       or bool((raw == torch.round(raw)).all()))
            s_abs = None if integer else sparse_abs_sums(raw, slabs, xy, col)
            err = max(err, hold_sparse(got, plain[name](*args, **kw), s_abs,
                                       integer, f"{what} {name}")[0])
    return err


def fleet_phase(cfg, dev):
    """Fleet frames at full width (phase 12): ``render_fleet_sequence``
    of the 720p scene (1,600 landmarks, seed 0), every count set to 0
    just before each call and read just after.

    ``process_fleet`` on 8 rigs: exactly 1 launch each of K1, K2, K3,
    and each rig's slice bit-equal to that rig's ``process_frame`` on
    the card, on 16 and 32 rigs (the 8 repeated) too; with a
    ``camera_mask`` (rig 1's back pair dead, rig 2 all dead) still 3, equal to the per-rig masked frames, the dead rig
    finite with nothing valid; on the frames rounded to uint8 in a
    uint8 session 3 launches of the uint8 variants, bit-equal to the f32
    fleet on the same integer-valued frames.  Localized: two
    ``process_fleet`` steps of 4 launches each (K4 once for the fleet),
    points bit-equal and poses within 1e-5 / 1e-4 of a per-rig
    ``process_frame`` loop (``valid`` and inliers equal); ``run_fleet``
    over T = 6 steps of 4 rigs 3T + 1 launches, each rig's trajectory
    under phase 6's ATE/RPE limits.  The card's ``process_fleet``
    against the CPU session's on 2 rigs at 96 x 128, integer-valued
    frames, both fed the CPU's pyramid levels.  Every input that K1-K4
    received in the counted calls is held against the kernel's plain
    version (``hold_path_calls``).  Then the fleet frame's latency at
    1, 2, 4 and 8 rigs (median of 20, in turns, host clock around the
    call plus a synchronize) and the 8-rig fleet frame's device
    profile.  Returns (the launches of each kernel summed over
    the counted calls, those of each uint8 variant, the timings)."""
    from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                                  VisualSystem, pyramid)
    from repro_torch.core.types import map_fields
    from repro_torch.data import scenes
    from repro_torch.kernels import describe_fused as de
    from repro_torch.kernels import frontend_fused as fe
    from repro_torch.kernels import match_fused as mo
    from repro_torch.kernels import matcher_fused as mf
    from repro_torch.kernels import ops
    scene = scenes.SceneConfig(height=cfg.height, width=cfg.width,
                               n_points=1600, seed=0)
    seq8 = scenes.render_fleet_sequence(scene, 2, FLEET_RIGS)
    rig = RigConfig.quad(seq8.intrinsics)
    vs = VisualSystem(rig, PipelineConfig(orb=cfg), device="cuda")
    fleet = torch.from_numpy(seq8.frames[0]).to(dev)
    total = dict.fromkeys(ops.KERNELS, 0)
    total_u8 = dict.fromkeys(ops.KERNELS, 0)
    frame_k = {n: 1 for n in ops.FRAME_KERNELS}

    held = {"calls": 0, "moment_err": 0.0}

    def count(fn, want, what, want_u8=None):
        """Count the launches of one fleet call, then hold every input
        its kernels received against their plain versions."""
        with recorded(fe, "frontend_fused_pyramid") as r1, \
                recorded(de, "describe_fused_pyramid") as r2, \
                recorded(mf, "match_rectify_fused") as r3, \
                recorded(mo) as r4:
            if want_u8 is None:
                out, counts = counted(fn, want, what)
            else:
                out = counted_u8(fn, want, want_u8, what, total_u8)
                counts = read_counts()
        for n, c in counts.items():
            total[n] += c
        calls = dict(zip(LOC_KERNELS, (r1, r2, r3, r4)))
        held["moment_err"] = max(held["moment_err"],
                                 hold_path_calls(calls, what))
        held["calls"] += sum(len(r) for r in calls.values())
        return out

    out = count(lambda: vs.process_fleet(fleet), frame_k,
                f"process_fleet of {FLEET_RIGS} rigs is 3 launches")
    if tuple(out.features_l.desc.shape) != (FLEET_RIGS, 2, cfg.max_features,
                                            8):
        raise AssertionError("unexpected fleet feature shapes")
    frames = [vs.process_frame(fleet[r]) for r in range(FLEET_RIGS)]
    for r in range(FLEET_RIGS):
        equal_fields(rig_slice(out, r), frames[r],
                     f"fleet rig {r} vs its process_frame")
    for t in (out.features_l.theta, out.depth.depth, out.depth.disparity,
              out.depth.xy_right):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("fleet: non-finite output")
    nd = out.depth.valid.sum(-1).tolist()
    if min(min(d) for d in nd) < 1:
        raise AssertionError("fleet: a pair has no valid depth")
    log(f"[fleet] {FLEET_RIGS} rigs: 3 launches (K1, K2, K3 once each); "
        f"every rig bit-equal to its process_frame; depths {nd}")
    for n in FLEET_BIG:
        big = count(lambda: vs.process_fleet(fleet.repeat(
            n // FLEET_RIGS, 1, 1, 1)), frame_k,
            f"process_fleet of {n} rigs is 3 launches")
        for r in range(n):
            equal_fields(rig_slice(big, r), frames[r % FLEET_RIGS],
                         f"{n}-rig fleet rig {r} vs its process_frame")
        del big
    log(f"[fleet] {' and '.join(map(str, FLEET_BIG))} rigs (the 8 rigs "
        "repeated): 3 launches each, every rig bit-equal to its "
        "process_frame")

    mask = np.ones((FLEET_RIGS, 4), bool)
    mask[1, 2:] = False
    mask[2] = False
    masked = count(lambda: vs.process_fleet(fleet, camera_mask=mask),
                   frame_k, "a masked fleet frame is 3 launches")
    for r in range(FLEET_RIGS):
        equal_fields(rig_slice(masked, r),
                     vs.process_frame(fleet[r], camera_mask=mask[r]),
                     f"masked fleet rig {r} vs its masked frame")
    for grp in masked:
        if bool(grp.valid[2].any()) or bool(grp.valid[1, 1].any()):
            raise AssertionError("masked fleet: a dead pair is valid")
    for t in (masked.features_l.xy, masked.depth.depth):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("masked fleet: non-finite output")
    log("[fleet] masked (rig 1's back pair and rig 2 dead): 3 launches, "
        "every rig bit-equal to its masked process_frame, the dead pairs "
        "invalid and finite")

    u8 = VisualSystem(rig, PipelineConfig(orb=cfg, precision="uint8"),
                      device="cuda")
    fleet_u8 = torch.clamp(torch.round(fleet), 0, 255).to(torch.uint8)
    got = count(lambda: u8.process_fleet(fleet_u8), frame_k,
                "a uint8 fleet frame is 3 launches", want_u8=frame_k)
    equal_fields(got, vs.process_fleet(fleet_u8.float()),
                 "uint8 fleet vs the f32 fleet")
    log("[fleet] uint8: 3 launches of the uint8 variants, bit-equal to the "
        "f32 fleet on the same integer-valued frames")

    # localized: two process_fleet steps against a per-rig frame loop
    loc_pipe = PipelineConfig(orb=cfg, localize=True)
    loc = VisualSystem(rig, loc_pipe, device="cuda")
    loop = [VisualSystem(rig, loc_pipe, device="cuda")
            for _ in range(FLEET_RIGS)]
    four = {**frame_k, "match_fused": 1}
    pose_err = 0.0
    for t in range(2):
        step = torch.from_numpy(seq8.frames[t]).to(dev)
        got = count(lambda: loc.process_fleet(step), four,
                    "a localized fleet frame is 4 launches")
        for r in range(FLEET_RIGS):
            want = loop[r].process_frame(step[r])
            equal_fields(rig_slice(got.stereo, r), want.stereo,
                         f"localized fleet rig {r}")
            equal_or_raise(got.points[r], want.points,
                           f"localized fleet rig {r} points")
            if int(got.pose.inliers[r]) != int(want.pose.inliers):
                raise AssertionError(f"localized fleet rig {r}: inliers "
                                     "differ from its frame's")
            rot = float((got.pose.rotation[r] - want.pose.rotation).abs()
                        .max())
            tr = float((got.pose.translation[r] - want.pose.translation)
                       .abs().max())
            if bool(got.pose.valid[r]) != bool(want.pose.valid) or not (
                    rot <= 1e-5 and tr <= 1e-4):
                raise AssertionError(f"localized fleet rig {r}: pose off "
                                     f"the loop's ({rot}, {tr})")
            pose_err = max(pose_err, rot, tr)
    if not bool(got.pose.valid.all()):
        raise AssertionError("localized fleet: a rig has no valid pose")
    log(f"[fleet localized] 2 steps of {FLEET_RIGS} rigs, 4 launches each; "
        "points bit-equal to the per-rig loop, poses within "
        f"{pose_err:.3e}, inliers {got.pose.inliers.tolist()}")

    seq4 = scenes.render_fleet_sequence(scene, SEQ_T, FLEET_LOC_RIGS)
    frames4 = torch.from_numpy(seq4.frames).to(dev)
    run = count(lambda: loc.run_fleet(frames4),
                {**{n: SEQ_T for n in ops.FRAME_KERNELS}, "match_fused": 1},
                "a localized run_fleet is 3T + 1 launches")
    fleet_metrics = []
    for r in range(FLEET_LOC_RIGS):
        fleet_metrics.append(check_metrics(
            map_fields(lambda x: x[:, r], run.pose), seq4.poses[r], LOC_LIMITS,
            f"run_fleet rig {r}"))
    log(f"[fleet localized] run_fleet T={SEQ_T} x {FLEET_LOC_RIGS} rigs: "
        f"{3 * SEQ_T + 1} launches, every rig under phase 6's limits")

    # the card against the CPU session, 2 rigs at 96 x 128
    small = ORBConfig(height=96, width=128, max_features=64,
                      max_disparity=64)
    sseq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=96, width=128, n_points=300, baseline=0.3), 1, 2)
    sframes = np.round(sseq.frames[0])
    spipe = PipelineConfig(orb=small)
    srig = RigConfig.quad(sseq.intrinsics)
    cpu = VisualSystem(srig, spipe, device="cpu")
    card = VisualSystem(srig, spipe, device="cuda")
    want = cpu.process_fleet(sframes)
    levels = pyramid.build_pyramid_batched(
        torch.from_numpy(sframes).reshape(-1, 96, 128), small)
    own = pyramid.build_pyramid_batched(
        torch.from_numpy(sframes).reshape(-1, 96, 128).to(dev), small)
    same_levels = all(torch.equal(a, b.cpu()) for a, b in zip(levels, own))
    build = pyramid.build_pyramid_batched
    pyramid.build_pyramid_batched = (
        lambda images, cfg_, **kw: [l.to(images.device) for l in levels])
    try:
        got = card.process_fleet(sframes)
        torch.cuda.synchronize()
    finally:
        pyramid.build_pyramid_batched = build
    n_edge = hold_fleet_card_vs_cpu(got, want, "fleet card vs CPU")
    log(f"[fleet small] card == CPU on 2 rigs at 96 x 128 (the card's own "
        f"levels equal the CPU's: {same_levels}; {n_edge} descriptors "
        "differ at a bin edge"
        f"{'; matches not compared' if n_edge else ''})")

    log(f"[fleet] every input of K1-K4 on the counted fleet calls held to "
        f"its plain version: {held['calls']} inputs, dense FE and matchers "
        f"bit-equal, sparse FE moments within {held['moment_err']} (the "
        "float rule), descriptors by the bins")

    # latency at 1, 2, 4 and 8 rigs, in turns; the 8-rig device profile
    lat = {n: [] for n in FLEET_SIZES}
    for _ in range(3):
        for n in FLEET_SIZES:
            vs.process_fleet(fleet[:n])
    for _ in range(REPS):
        for n in FLEET_SIZES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vs.process_fleet(fleet[:n])
            torch.cuda.synchronize()
            lat[n].append((time.perf_counter() - t0) * 1e3)
    med = {n: statistics.median(v) for n, v in lat.items()}
    for n in FLEET_SIZES:
        log(f"[fleet latency] {n} rig(s): median {med[n]:.4f} ms over "
            f"{REPS} (min {min(lat[n]):.4f}, max {max(lat[n]):.4f}), "
            f"{med[n] / n:.4f} ms a rig")
    summary = {}
    profile_frames(vs, None, call=lambda: vs.process_fleet(fleet),
                   summary=summary)
    stats = {"latency_ms": {str(n): med[n] for n in FLEET_SIZES},
             "ms_per_rig": {str(n): med[n] / n for n in FLEET_SIZES},
             "profile_8_rigs": summary, "pose_err_vs_loop": pose_err,
             "held_to_plain": held,
             "run_fleet_metrics": fleet_metrics}
    return total, total_u8, stats


PIPE_FLEET_RIGS, PIPE_FLEET_T = 8, 4
PIPE_REPEATS = 10
# Symbols of the frame kernels in a profiler trace: FE (K1, K2), FM (K3).
FE_SYMBOLS = ("frontend_kernel", "describe_kernel")
FM_SYMBOL = "match_kernel"


def tensors_of(tup) -> list:
    """Every tensor of a (nested) output tuple, in field order."""
    out = []
    for x in tup:
        out += tensors_of(x) if isinstance(x, tuple) else [x]
    return out


def trace_events(fn) -> list:
    """(name, stream, start us, end us) of every device event (kernels,
    copies, fills) of one call of ``fn``, from ``torch.profiler``'s
    Chrome trace."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [(ev["name"], ev.get("args", {}).get("stream"), float(ev["ts"]),
             float(ev["ts"]) + float(ev["dur"]))
            for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "X"
            and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def overlap_ms(a, b) -> float:
    """ms during which some interval of ``a`` and some of ``b`` both
    ran (intervals in us)."""
    return union_ms(a) + union_ms(b) - union_ms(list(a) + list(b))


def fewer_syncs(sequential, pipelined, what: str) -> dict:
    """Host syncs of either schedule's call; raises if the pipelined
    call makes more than the sequential one."""
    syncs = {"sequential": host_syncs(sequential),
             "pipelined": host_syncs(pipelined)}
    if syncs["pipelined"] > syncs["sequential"]:
        raise AssertionError(f"{what}: more host syncs than sequential: "
                             f"{syncs}")
    return syncs


def in_turns(calls: dict, reps: int = REPS) -> dict:
    """Median host ms of each call (host clock around the call and a
    synchronize), ``reps`` of each in turns, the order reversed every
    other turn, after two warm-up calls each."""
    for fn in calls.values():
        fn()
        fn()
    lat = {k: [] for k in calls}
    for i in range(reps):
        for k in (list(calls) if i % 2 == 0 else list(calls)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[k]()
            torch.cuda.synchronize()
            lat[k].append((time.perf_counter() - t0) * 1e3)
    for k, v in lat.items():
        log(f"[latency] {k}: median {statistics.median(v):.4f} ms over "
            f"{reps} (min {min(v):.4f}, max {max(v):.4f})")
    return {k: statistics.median(v) for k, v in lat.items()}


def pipelined_phase(cfg, dev, rig, seq_frames, intr):
    """The pipelined schedule at full width (phase 13): phase 6's T = 6
    sequence of phase 4's scene (``rig``, ``seq_frames``, ``intr``) and
    an 8-rig x T = 4 ``render_fleet_sequence`` of it.

    ``run`` f32, rounded to uint8 in a uint8 session, and localized;
    ``run_fleet`` f32 and localized; the legacy
    ``run_sequence_pipelined``: each bit-equal to the sequential
    schedule's output on the same input, field by field (poses within
    phase 6's 1e-5, inliers and points equal), in 3T launches (3T + 1
    localized; the uint8 variants on the uint8 path), with no more host
    synchronisations than the sequential call; every input that K1-K4
    received there held to its plain version (``hold_path_calls``).
    In a ``torch.profiler`` trace of the 8-rig ``run_fleet``, K1/K2 and
    K3 ran on distinct streams, and the device ms during which FE and FM
    work overlapped is logged.  Then 10 back-to-back 8-rig runs, each
    result freed before the next call, bit-equal to the first; the peak
    device memory of either schedule; the latency of either schedule in
    turns (median of 20) at 1 rig (``run``) and 8 rigs (``run_fleet``);
    and both schedules' 8-rig device profiles.  Returns (the launches
    of each kernel over the counted calls, those of each uint8 variant,
    the timings)."""
    import warnings
    from repro_torch.core import PipelineConfig, VisualSystem, frontend
    from repro_torch.data import scenes
    from repro_torch.kernels import describe_fused as de
    from repro_torch.kernels import frontend_fused as fe
    from repro_torch.kernels import match_fused as mo
    from repro_torch.kernels import matcher_fused as mf
    from repro_torch.kernels import ops
    total = dict.fromkeys(ops.KERNELS, 0)
    total_u8 = dict.fromkeys(ops.KERNELS, 0)
    held = {"calls": 0, "moment_err": 0.0}

    def session(schedule, **kw):
        return VisualSystem(rig, PipelineConfig(orb=cfg, schedule=schedule,
                                                **kw), device="cuda")

    def count(fn, t, what, localized=False, u8=False):
        want = {n: t for n in ops.FRAME_KERNELS}
        if localized:
            want["match_fused"] = 1
        with recorded(fe, "frontend_fused_pyramid") as r1, \
                recorded(de, "describe_fused_pyramid") as r2, \
                recorded(mf, "match_rectify_fused") as r3, \
                recorded(mo) as r4:
            if u8:
                out = counted_u8(fn, want, want, what, total_u8)
            else:
                out, _ = counted(fn, want, what)
        for n, c in read_counts().items():
            total[n] += c
        calls = dict(zip(LOC_KERNELS, (r1, r2, r3, r4)))
        held["moment_err"] = max(held["moment_err"],
                                 hold_path_calls(calls, what))
        held["calls"] += sum(len(r) for r in calls.values())
        return out

    def hold_equal(got, want, what, localized=False):
        if not localized:
            equal_fields(got, want, what)
            return 0.0
        equal_fields(got.stereo, want.stereo, f"{what} stereo")
        equal_or_raise(got.points, want.points, f"{what} points")
        equal_or_raise(got.pose.inliers, want.pose.inliers,
                       f"{what} inliers")
        return close_poses(got.pose, want.pose, 1e-5, f"{what} poses")

    t_run = int(seq_frames.shape[0])
    scene = scenes.SceneConfig(height=cfg.height, width=cfg.width,
                               n_points=1600, seed=0)
    fleet = torch.from_numpy(scenes.render_fleet_sequence(
        scene, PIPE_FLEET_T, PIPE_FLEET_RIGS).frames).to(dev)
    u8_frames = torch.clamp(torch.round(seq_frames), 0, 255).to(torch.uint8)
    cases = (("run f32", "run", seq_frames, {}, t_run),
             ("run uint8", "run", u8_frames, {"precision": "uint8"}, t_run),
             ("run localized", "run", seq_frames, {"localize": True}, t_run),
             (f"run_fleet {PIPE_FLEET_RIGS} rigs", "run_fleet", fleet, {},
              PIPE_FLEET_T),
             (f"run_fleet {PIPE_FLEET_RIGS} rigs localized", "run_fleet",
              fleet, {"localize": True}, PIPE_FLEET_T))
    sessions, pose_err, syncs = {}, 0.0, {}
    for what, entry, frames, kw, t in cases:
        seq_vs, pip_vs = session("sequential", **kw), session("pipelined",
                                                              **kw)
        sessions[what] = (seq_vs, pip_vs)
        want = getattr(seq_vs, entry)(frames)
        got = count(lambda: getattr(pip_vs, entry)(frames), t,
                    f"pipelined {what}: 3T launches (3T + 1 localized)",
                    localized="localize" in kw, u8="precision" in kw)
        pose_err = max(pose_err, hold_equal(
            got, want, f"pipelined {what} vs sequential",
            localized="localize" in kw))
        syncs[what] = fewer_syncs(
            lambda: getattr(seq_vs, entry)(frames),
            lambda: getattr(pip_vs, entry)(frames), f"pipelined {what}")
        log(f"[pipelined] {what}: T={t}, {3 * t + ('localize' in kw)} "
            "launches, bit-equal to the sequential schedule"
            f"{' (poses within 1e-5)' if 'localize' in kw else ''}"
            f"; host syncs {syncs[what]}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = count(lambda: frontend.run_sequence_pipelined(
            seq_frames, cfg, intr, device="cuda"), t_run,
            "the legacy pipelined shim: 3T launches")
        want = frontend.run_sequence(seq_frames, cfg, intr, device="cuda")
    if not any(issubclass(c.category, DeprecationWarning) for c in caught):
        raise AssertionError("run_sequence_pipelined did not warn")
    equal_fields(got, want, "run_sequence_pipelined vs run_sequence")
    syncs["run_sequence_pipelined"] = fewer_syncs(
        lambda: frontend.run_sequence(seq_frames, cfg, intr, device="cuda"),
        lambda: frontend.run_sequence_pipelined(seq_frames, cfg, intr,
                                                device="cuda"),
        "the legacy pipelined shim")
    log(f"[pipelined] legacy run_sequence_pipelined: {3 * t_run} launches, "
        "a DeprecationWarning, bit-equal to run_sequence; host syncs "
        f"{syncs['run_sequence_pipelined']}")
    log(f"[pipelined] every input of K1-K4 on the counted pipelined calls "
        f"held to its plain version: {held['calls']} inputs, sparse FE "
        f"moments within {held['moment_err']} (the float rule)")

    # the two streams, in a trace of the 8-rig run_fleet
    fleet_what = f"run_fleet {PIPE_FLEET_RIGS} rigs"
    seq8, pip8 = sessions[fleet_what]
    events = trace_events(lambda: pip8.run_fleet(fleet))

    def streams(symbols):
        return {st for name, st, _, _ in events
                if any(sym in name for sym in symbols)}

    fe_streams, fm_streams = streams(FE_SYMBOLS), streams((FM_SYMBOL,))
    if not fe_streams or not fm_streams or fe_streams & fm_streams:
        raise AssertionError(f"pipelined run_fleet: FE kernels on streams "
                             f"{fe_streams}, FM kernels on {fm_streams}")
    on_fm = [(a, b) for _, st, a, b in events if st in fm_streams]
    off_fm = [(a, b) for _, st, a, b in events if st not in fm_streams]
    k12 = [(a, b) for name, _, a, b in events
           if any(sym in name for sym in FE_SYMBOLS)]
    k3 = [(a, b) for name, _, a, b in events if FM_SYMBOL in name]
    span = (max(b for *_, b in events) - min(a for _, _, a, _ in events))
    streams_stats = {
        "fe_streams": sorted(map(str, fe_streams)),
        "fm_streams": sorted(map(str, fm_streams)),
        "device_span_ms": span / 1e3,
        "busy_union_ms": union_ms([(a, b) for _, _, a, b in events]),
        "fm_stream_ms": union_ms(on_fm),
        "other_streams_ms": union_ms(off_fm),
        "fe_fm_overlap_ms": overlap_ms(off_fm, on_fm),
        "k12_k3_overlap_ms": overlap_ms(k12, k3)}
    log(f"[pipelined streams] {PIPE_FLEET_RIGS}-rig run_fleet: K1/K2 on streams "
        f"{sorted(map(str, fe_streams))}, K3 on {sorted(map(str, fm_streams))}"
        f"; device span {span / 1e3:.4f} ms, FM stream busy "
        f"{streams_stats['fm_stream_ms']:.4f} ms, the other streams "
        f"{streams_stats['other_streams_ms']:.4f} ms, overlapping "
        f"{streams_stats['fe_fm_overlap_ms']:.4f} ms (K1/K2 against K3: "
        f"{streams_stats['k12_k3_overlap_ms']:.4f} ms)")

    # 10 back-to-back runs, each result freed before the next call
    first = pip8.run_fleet(fleet)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(PIPE_REPEATS):
        out = pip8.run_fleet(fleet)
        for a, b in zip(tensors_of(out), tensors_of(first)):
            bad += (a != b).sum()
        del out
    torch.cuda.synchronize()
    if int(bad):
        raise AssertionError(f"pipelined run_fleet: {int(bad)} values "
                             "differ across back-to-back runs")
    del first
    log(f"[pipelined] {PIPE_REPEATS} back-to-back {PIPE_FLEET_RIGS}-rig runs, each freed "
        "before the next call: bit-equal to the first")
    peak = {}
    for name, vs in (("sequential", seq8), ("pipelined", pip8)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        vs.run_fleet(fleet)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"[pipelined] peak device memory of a {PIPE_FLEET_RIGS}-rig run_fleet: "
        f"{peak} MiB")

    seq1, pip1 = sessions["run f32"]
    lat1 = in_turns({"run sequential": lambda: seq1.run(seq_frames),
                     "run pipelined": lambda: pip1.run(seq_frames)})
    lat8 = in_turns({"run_fleet sequential": lambda: seq8.run_fleet(fleet),
                     "run_fleet pipelined": lambda: pip8.run_fleet(fleet)})
    prof = {}
    for name, vs in (("sequential", seq8), ("pipelined", pip8)):
        prof[name] = {}
        log(f"[pipelined profile] {PIPE_FLEET_RIGS}-rig run_fleet of "
            f"T = {PIPE_FLEET_T} (the whole call), {name}:")
        profile_frames(vs, None, call=lambda: vs.run_fleet(fleet),
                       summary=prof[name])
    stats = {
        "latency_ms": {"1_rig_run_T6": lat1, "8_rigs_run_fleet_T4": lat8},
        "pipelined_over_sequential": {
            "1_rig": lat1["run pipelined"] / lat1["run sequential"],
            "8_rigs": (lat8["run_fleet pipelined"]
                       / lat8["run_fleet sequential"])},
        "host_syncs": syncs, "streams": streams_stats,
        "peak_mib_8_rigs": peak, "profile_8_rigs_run_fleet_T4": prof,
        "pose_err_vs_sequential": pose_err, "held_to_plain": held}
    return total, total_u8, stats


TAB1_MODES = {"slam": (True, 3), "vio": (False, 1), "registration": (True, 6)}
TAB1_PAPER = {"slam": 54.8, "vio": 86.7, "registration": 84.6}
# The back pair's camera -> rig rotation (the quad rig's xz flip).
FLIP = ((-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, -1.0))
# Card against CPU: R and t of a refined or robust pose (the CPU tests'
# VO tolerance: 3 x 3 products and the GN solve round differently).
VO_POSE_ATOL = 1e-4
VO_FRAMES = 5


def vo_inputs(vs, prev, curr, intr, rot=None):
    """The backend's inputs for one transition of one stereo pair
    (``benchmarks/run.py``'s Tab. I backend): the temporal match of the
    left features (1 launch of K4), both frames' triangulated points
    (the current frame's gathered by the match; rotated into the rig
    frame by ``rot``), the 0/1 weights and the matched current pixels."""
    from repro_torch.core import backend
    tm = vs.temporal_match(prev.features_l, curr.features_l)
    idx = tm.right_index.long()
    w = (tm.valid & prev.depth.valid & curr.depth.valid[idx]).float()
    pp = backend.triangulate(prev.features_l, prev.depth, intr)
    pc = backend.triangulate(curr.features_l, curr.depth, intr)[idx]
    if rot is not None:
        rot = torch.tensor(rot, dtype=torch.float32, device=pp.device)
        pp, pc = pp @ rot.T, pc @ rot.T
    return pp, pc, w, curr.features_l.xy[idx]


def quad_vo(fronts, backs, vs, intr):
    """``tests/test_system.py``'s quad-fused VO: both pairs' points in
    the rig frame (the back pair flipped), one flat-weighted robust
    solve a transition without refinement."""
    from repro_torch.core import backend
    poses = []
    for t in range(len(fronts) - 1):
        parts = [vo_inputs(vs, fronts[t], fronts[t + 1], intr),
                 vo_inputs(vs, backs[t], backs[t + 1], intr, FLIP)]
        poses.append(backend.estimate_relative_pose(
            torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            torch.cat([p[2] for p in parts]), xy_curr=None, intr=intr,
            refine=False))
    return poses


def backend_phase(cfg, dev, seq_frames, seq_poses, intr):
    """The pose backend and the paper's Tab. I split at full width
    (phase 14): a 2-camera ``RigConfig.stereo`` session at 720 x 1280 on
    phase 6's sequence, pair 0 (front).  ``process_frame`` a frame in 3
    launches; each transition's ``temporal_match`` 1 launch of K4,
    ``triangulate`` and ``estimate_relative_pose`` none, in the three
    backend modes of ``benchmarks/run.py`` (slam: refine, 3 robust
    rounds; vio: no refine, 1; registration: refine, 6), each with at
    least 8 inliers and a finite pose.  The quad-fused VO of
    ``tests/test_system.py`` (front and back pair, the back flipped,
    ``refine=False``) on that test's scene and motion (0.5 m baseline,
    0.25 m lateral and 0.1 m forward a frame) rendered at full width,
    5 frames, ends within 30% of the ground-truth travel; on phase 6's
    sequence its drift is reported.  Reported, not claimed: the frontend's ms (one
    stereo frame), each mode's backend ms and the frontend's share
    (median of 20 in turns) beside the paper's 54.8 / 86.7 / 84.6%, and
    each mode's host syncs.  Then the card's backend against the CPU's
    on the same points, from a CPU session on ``tests/test_system.py``'s
    small sequence: points bit-equal, poses within ``VO_POSE_ATOL`` and
    inliers equal in every mode.  Returns (launches, stats)."""
    from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                                  VisualSystem, backend)
    from repro_torch.core.types import map_fields
    from repro_torch.data import scenes
    from repro_torch.kernels import ops
    vs = VisualSystem(RigConfig.stereo(intr), PipelineConfig(orb=cfg),
                      device="cuda")
    total = dict.fromkeys(ops.KERNELS, 0)
    frame_k = {n: 1 for n in ops.FRAME_KERNELS}

    def count(fn, want, what):
        out, counts = counted(fn, want, what)
        for n, c in counts.items():
            total[n] += c
        return out

    t_total = int(seq_frames.shape[0])
    fronts = [rig_slice(count(lambda: vs.process_frame(seq_frames[t, 0:2]),
                              frame_k, "a stereo frame is 3 launches"), 0)
              for t in range(t_total)]
    inliers = {m: [] for m in TAB1_MODES}
    for t in range(t_total - 1):
        args = count(lambda: vo_inputs(vs, fronts[t], fronts[t + 1], intr),
                     {"match_fused": 1}, "temporal_match is 1 launch")
        for mode, (refine, iters) in TAB1_MODES.items():
            pose = count(lambda: backend.estimate_relative_pose(
                *args, intr, refine=refine, robust_iters=iters), {},
                f"the {mode} backend launches no kernel")
            if not (bool(torch.isfinite(pose.rotation).all())
                    and bool(torch.isfinite(pose.translation).all())):
                raise AssertionError(f"{mode} transition {t}: non-finite "
                                     "pose")
            inliers[mode].append(int(pose.inliers))
    for mode, n in inliers.items():
        if min(n) < 8:
            raise AssertionError(f"{mode}: a transition kept fewer than 8 "
                                 f"inliers: {n}")
    log(f"[backend] stereo VO on pair 0 at 720p: process_frame 3 launches, "
        f"temporal_match 1 (K4), the backend none; inliers {inliers}")

    def drift_of(session, frames, poses, what):
        """(drift m, travel m) of the quad-fused VO over ``frames``."""
        backs = [rig_slice(session.process_frame(frames[t, 2:4]), 0)
                 for t in range(frames.shape[0])]
        fr = fronts if session is vs else [
            rig_slice(session.process_frame(frames[t, 0:2]), 0)
            for t in range(frames.shape[0])]
        traj = backend.integrate_trajectory(quad_vo(
            fr, backs, session, session.rig.intrinsics[0]))
        true_final = torch.as_tensor(np.asarray(poses[-1][1]))
        travel = float(torch.linalg.vector_norm(true_final))
        drift = float(torch.linalg.vector_norm(traj[-1].cpu() - true_final))
        log(f"[backend] quad-fused VO, {what}, {frames.shape[0]} frames: "
            f"final {traj[-1].tolist()} against {true_final.tolist()}: "
            f"drift {drift:.4f} m over {travel:.4f} m travelled")
        return drift, travel

    # Phase 6's forward steps (0.1 m a frame, 0.12 m baseline) move a
    # point's disparity by about one pixel: reported, not held.
    drift6, travel6 = drift_of(vs, seq_frames, seq_poses, "phase 6's sequence")
    # tests/test_system.py's scene and motion (0.5 m baseline, lateral-
    # dominant steps), rendered at full width: held to that test's 30%.
    sys_seq = scenes.render_sequence(scenes.SceneConfig(
        height=cfg.height, width=cfg.width, n_points=200, seed=7,
        baseline=0.5), VO_FRAMES, step_t=(0.25, 0.0, 0.1),
        yaw_per_frame=0.0)
    sys_vs = VisualSystem(RigConfig.stereo(sys_seq.intrinsics),
                          PipelineConfig(orb=cfg), device="cuda")
    drift, travel = drift_of(sys_vs, torch.from_numpy(sys_seq.frames).to(dev),
                             sys_seq.poses, "tests/test_system.py's motion")
    if not drift < 0.3 * travel:
        raise AssertionError(f"quad-fused VO drifted {drift} m over "
                             f"{travel} m (limit 30%)")

    # the Tab. I split: one stereo frame against each backend mode
    modes = {mode: (lambda r=refine, i=iters: backend.estimate_relative_pose(
        *vo_inputs(vs, fronts[0], fronts[1], intr), intr, refine=r,
        robust_iters=i)) for mode, (refine, iters) in TAB1_MODES.items()}
    lat = in_turns({"frontend": lambda: vs.process_frame(seq_frames[0, 0:2]),
                    **modes})
    split = {mode: {"frontend_ms": lat["frontend"], "backend_ms": lat[mode],
                    "frontend_share_pct": 100.0 * lat["frontend"]
                    / (lat["frontend"] + lat[mode]),
                    "paper_pct": TAB1_PAPER[mode],
                    "backend_host_syncs": host_syncs(modes[mode])}
             for mode in TAB1_MODES}
    for mode, st in split.items():
        log(f"[Tab. I] {mode}: frontend {st['frontend_ms']:.4f} ms, backend "
            f"{st['backend_ms']:.4f} ms, frontend share "
            f"{st['frontend_share_pct']:.1f}% (paper {st['paper_pct']}%); "
            f"backend host syncs {st['backend_host_syncs']}")

    # the card's backend against the CPU's on the same points
    small = scenes.render_sequence(scenes.SceneConfig(
        height=160, width=240, n_points=200, seed=7, baseline=0.5), 4,
        step_t=(0.25, 0.0, 0.1), yaw_per_frame=0.0)
    ocfg = ORBConfig(height=160, width=240, max_features=256, n_levels=1,
                     max_disparity=96)
    cpu = VisualSystem(RigConfig.stereo(small.intrinsics),
                       PipelineConfig(orb=ocfg), device="cpu")
    outs = [rig_slice(cpu.process_frame(f[0:2]), 0) for f in small.frames]
    err = 0.0
    for t in range(len(outs) - 1):
        feats = [o.features_l for o in outs[t:t + 2]]
        deps = [o.depth for o in outs[t:t + 2]]
        for f, d in zip(feats, deps):
            on_card = backend.triangulate(
                *(map_fields(lambda x: x.to(dev), x) for x in (f, d)),
                small.intrinsics)
            equal_or_raise(on_card, backend.triangulate(f, d,
                                                        small.intrinsics),
                           "triangulate card vs CPU")
        args = vo_inputs(cpu, outs[t], outs[t + 1], small.intrinsics)
        for mode, (refine, iters) in TAB1_MODES.items():
            want = backend.estimate_relative_pose(
                *args, small.intrinsics, refine=refine, robust_iters=iters)
            got = backend.estimate_relative_pose(
                *(a.to(dev) for a in args), small.intrinsics, refine=refine,
                robust_iters=iters)
            if int(got.inliers) != int(want.inliers):
                raise AssertionError(f"{mode} card vs CPU: inliers "
                                     f"{int(got.inliers)} vs "
                                     f"{int(want.inliers)}")
            for a, b in ((got.rotation, want.rotation),
                         (got.translation, want.translation)):
                d = float((a.cpu() - b).abs().max())
                if not d <= VO_POSE_ATOL:
                    raise AssertionError(f"{mode} card vs CPU: pose off by "
                                         f"{d}")
                err = max(err, d)
    log(f"[backend small] card == CPU on {len(outs) - 1} transitions at 160 x "
        f"240, 3 modes: points bit-equal, poses within {err:.3e} "
        f"(limit {VO_POSE_ATOL}), inliers equal")
    stats = {"tab1": split, "inliers": inliers,
             "quad_vo": {"drift_m": drift, "travel_m": travel,
                         "phase6_drift_m": drift6,
                         "phase6_travel_m": travel6},
             "card_vs_cpu_pose_err": err}
    return total, stats



SERVICE_RIGS, SERVICE_T = 8, 6
SERVICE_DT = 1.0 / 30.0
SERVICE_SETTLE = 4
# The fault episode: each kind on its own rig of 8 (rigs 0, 6 and 7 stay
# healthy); the watchdog as in ``tests/test_serving_faults.py``.
SERVICE_SPECS = (dict(kind="dead_camera", rig=1, camera=3),
                 dict(kind="corrupt_frame", rig=2, start=1, stop=3, camera=0),
                 dict(kind="desync", rig=3, camera=1, magnitude=0.5),
                 dict(kind="stalled_rig", rig=4, start=1),
                 dict(kind="arrival_jitter", rig=5,
                      magnitude=0.3 * SERVICE_DT))
SERVICE_HEALTHY = (0, 6, 7)
SERVICE_SUP = dict(heartbeat_timeout_s=2.5 * SERVICE_DT,
                   backoff_base_s=SERVICE_DT, backoff_max_s=4 * SERVICE_DT,
                   restart_budget=2, flap_window_s=1.0, seed=0)


def tensor_bytes(tup) -> int:
    """Bytes of every tensor of a (nested) output tuple."""
    return sum(x.numel() * x.element_size() for x in tensors_of(tup))


def wire_equal(a, b, what: str) -> None:
    """Two wire dicts: the same keys, ints and shapes; tensors of one
    dtype with the same bytes (``a``'s on the card)."""
    if isinstance(b, dict):
        if set(a) != set(b):
            raise AssertionError(f"{what}: keys differ")
        for key in b:
            wire_equal(a[key], b[key], f"{what}.{key}")
    elif isinstance(b, torch.Tensor):
        if a.dtype != b.dtype or a.device.type != "cuda" or \
                a.cpu().numpy().tobytes() != b.numpy().tobytes():
            raise AssertionError(f"{what}: card payload differs from the "
                                 "CPU encoding")
    elif a != b:
        raise AssertionError(f"{what}: {a} != {b}")


def check_wire(outputs, what: str) -> dict:
    """``wire_encode`` of each output on the card, byte-identical to
    ``wire_encode`` of the same output moved to the CPU; the lossless
    fields round-trip bit-exactly and the quantized ones within scale / 2
    plus the product's rounding (an ulp of max|x|).  Returns the count
    and the largest quantization error over its bound."""
    from repro_torch.core.types import LocalizationOutput, map_fields
    from repro_torch.serving import wire_decode, wire_encode
    worst = 0.0
    for i, out in enumerate(outputs):
        wire = wire_encode(out)
        wire_equal(wire, wire_encode(map_fields(lambda x: x.cpu(), out)),
                   f"{what} report {i}")
        back = wire_decode(wire)
        loc = isinstance(out, LocalizationOutput)
        st, src = (back.stereo, out.stereo) if loc else (back, out)
        for side in ("features_l", "features_r"):
            g, s = getattr(st, side), getattr(src, side)
            for name in ("level", "desc", "valid"):
                equal_or_raise(getattr(g, name), getattr(s, name),
                               f"{what} wire {side}.{name}")
            for name in ("xy", "score", "theta"):
                x = getattr(s, name)
                bound = (float(wire[side][f"{name}_scale"]) / 2
                         + float(x.abs().max()) * 2.0 ** -23)
                err = float((getattr(g, name) - x).abs().max())
                if not err <= bound:
                    raise AssertionError(f"{what} wire {side}.{name}: "
                                         f"{err} over {bound}")
                worst = max(worst, err / bound)
        equal_fields(st.matches, src.matches, f"{what} wire matches")
        equal_or_raise(st.depth.valid, src.depth.valid,
                       f"{what} wire depth.valid")
        if loc:
            equal_or_raise(back.points, out.points, f"{what} wire points")
            equal_fields(back.pose, out.pose, f"{what} wire pose")
    return {"outputs": len(outputs), "worst_err_over_bound": worst}


@functools.lru_cache(maxsize=1)
def service_sequence(cfg):
    """The services' 8-rig fleet (phases 15 and 16):
    ``render_fleet_sequence`` of phase 4's 720p scene, T = 6."""
    from repro_torch.data import scenes
    scene = scenes.SceneConfig(height=cfg.height, width=cfg.width,
                               n_points=1600, seed=0)
    return scenes.render_fleet_sequence(scene, SERVICE_T, SERVICE_RIGS)


def new_launch_acc() -> dict:
    """What ``count_steps`` accumulates: each kernel's launches, its
    uint8 variant's, and the inputs held to plain."""
    from repro_torch.kernels import ops
    return {"total": dict.fromkeys(ops.KERNELS, 0),
            "total_u8": dict.fromkeys(ops.KERNELS, 0),
            "held": {"calls": 0, "moment_err": 0.0}}


def count_steps(svc, what: str, acc: dict):
    """Wrap ``svc.step``: every step runs with the counts set to 0 just
    before and read just after, a step that serves a batch launches K1-K3
    once each (K4 too when the session localizes; the uint8 variants in
    a uint8 session), a step that serves none launches nothing, and the
    caller's ``launch_audit`` sees every launch (a guarded step's run in
    the guard's worker thread).  Every input K1-K4 received is held to
    its plain version; the served batches are recorded in
    ``svc.batches``.  ``acc`` accumulates the launches (``total``,
    ``total_u8``) and the holds (``held``)."""
    from repro_torch.kernels import describe_fused as de
    from repro_torch.kernels import frontend_fused as fe
    from repro_torch.kernels import match_fused as mo
    from repro_torch.kernels import matcher_fused as mf
    from repro_torch.kernels import ops
    total, total_u8, held = acc["total"], acc["total_u8"], acc["held"]
    step, next_batch = svc.step, svc.queue.next_batch
    loc = svc.vs.pipe.localize
    u8 = svc.vs.pipe.precision == "uint8"
    want = {**{n: 1 for n in ops.FRAME_KERNELS},
            **({"match_fused": 1} if loc else {})}
    svc.batches = []

    def record(now, force=False):
        batch = next_batch(now, force=force)
        if batch is not None:
            svc.batches.append(batch)
        return batch

    def counted_step(now, force=False):
        served = svc.counters["batches"]
        with recorded(fe, "frontend_fused_pyramid") as r1, \
                recorded(de, "describe_fused_pyramid") as r2, \
                recorded(mf, "match_rectify_fused") as r3, \
                recorded(mo) as r4:
            reset_counts()
            with ops.launch_audit() as audit:
                reports = step(now, force=force)
                torch.cuda.synchronize()
            counts = read_counts()
        got = {n: c for n, c in counts.items() if c}
        expect = want if svc.counters["batches"] > served else {}
        if got != expect or audit.count != sum(expect.values()):
            raise AssertionError(f"{what}: a step launched {got} (audit "
                                 f"{audit.count}), expected {expect}")
        u8_got = {n: c for n, c in read_u8_counts().items() if c}
        if u8_got != (expect if u8 else {}):
            raise AssertionError(f"{what}: uint8 variant launches "
                                 f"{u8_got}")
        for n, c in counts.items():
            total[n] += c
        for n, c in u8_got.items():
            total_u8[n] += c
        calls = dict(zip(LOC_KERNELS, (r1, r2, r3, r4)))
        held["moment_err"] = max(held["moment_err"],
                                 hold_path_calls(calls, what))
        held["calls"] += sum(len(r) for r in calls.values())
        return reports

    svc.queue.next_batch = record
    svc.step = counted_step
    return svc


def service_phase(cfg, dev):
    """The fleet service at full width (phase 15): ``FleetService`` over
    a card session, ``QueueConfig()`` (buckets 1, 2, 4, 8), 8 rigs of
    ``render_fleet_sequence`` of phase 4's scene, T = 6, through
    ``run_episode`` on a virtual clock (dt 1/30 s).  Every service step
    runs with the counts set to 0 just before and read just after: 3
    launches (K1-K3; K4 too when localized) for a step that serves a
    batch, none for one that does not, and every input K1-K4 received is
    held to its plain version.

    1. A fault-free f32 episode: every report bit-equal to its rig's
       slice of ``process_fleet`` on the same batch and to its
       ``process_frame``; ``frames_in == frames_out``, no drop.
    2. The fault episode (``SERVICE_SPECS``: a dead camera, a corrupt
       frame, desync, a stall healed by the restart hook and arrival
       jitter, each on its own rig): it never raises; the healthy rigs'
       full-mask frames bit-equal to episode 1's; its events, counters
       and ``status()`` equal to the same episode on a CPU session at
       96 x 128 (they depend only on the specs and the clock).
    3. That fault episode in a uint8 session, its reports bit-equal to
       the f32 session's on the frames rounded to integers (the injector
       hands float frames, which the intake rounds); then a fault-free
       uint8 episode on uint8 frames, whose intake queues the caller's
       arrays without a copy.  Both in the uint8 variants' 3 launches.
    4. The fault episode localized: 4 launches a batch, every pose
       finite; then ``tests/test_serving_faults.py``'s quarantine drive
       (rig 1 silent while the others stream): its pose state dropped,
       the others' kept.
    5. ``wire_encode`` of every report of episodes 1 and 4 on the card,
       byte-identical to the CPU encoding of the same output, lossless
       fields bit-exact, quantized ones within their bound.

    Then, each beside the card: a service tick (8 submits and a step)
    and the step alone against bare ``process_fleet`` on the same frames
    (on the card, and from host frames), median of 20 in turns; submit
    ms a rig frame, f32 against uint8; the batch upload ms (``next_batch``
    and the copy alone); the idle share of a tick (``profile_frames``);
    encode and decode ms; ``wire_bytes`` of a 720p quad ``StereoOutput``
    and ``LocalizationOutput`` beside the bytes of their tensors.
    Returns (launches of each kernel on the counted steps, those of each
    uint8 variant, stats)."""
    from repro_torch import serving
    from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                                  VisualSystem)
    from repro_torch.data import scenes
    from repro_torch.distributed import compression
    from repro_torch.kernels import ops

    seq = service_sequence(cfg)
    frames = seq.frames
    rounded = np.round(frames)
    rig = RigConfig.quad(seq.intrinsics, desync_policy="degrade",
                         max_desync=1e-3)
    sessions = {mode: VisualSystem(rig, PipelineConfig(orb=cfg, **pipe),
                                   device="cuda")
                for mode, pipe in (("f32", {}),
                                   ("uint8", {"precision": "uint8"}),
                                   ("localized", {"localize": True}))}
    acc = new_launch_acc()
    total, total_u8, held = acc["total"], acc["total_u8"], acc["held"]

    def service(mode, restart=None, **sup):
        return serving.FleetService(
            sessions[mode], serving.QueueConfig(),
            serving.SupervisorConfig(**{**SERVICE_SUP, **sup}), restart)

    def counting(svc, what):
        return count_steps(svc, what, acc)

    def episode(mode, source, specs=(), restart=False, what="",
                settle=SERVICE_SETTLE):
        inj = serving.FaultInjector(
            [serving.FaultSpec(**s) for s in specs], seed=9) \
            if specs else None
        svc = counting(service(mode, inj.clear_rig if restart else None),
                       what)
        res = serving.run_episode(svc, source, dt=SERVICE_DT, injector=inj,
                                  settle_steps=settle)
        torch.cuda.synchronize()
        n = svc.counters["batches"]
        log(f"[service {what}] {len(res.reports)} reports in {n} batches "
            f"({3 + svc.vs.pipe.localize} launches each), "
            f"{len(res.events)} events, counters "
            f"{dict(sorted(res.status['counters'].items()))}")
        if n < 1:
            raise AssertionError(f"{what}: no batch served")
        return res, svc

    def by_key(res, rigs):
        return {(r.rig_id, round(r.t_arrival, 9)): r for r in res.reports
                if r.rig_id in rigs and r.output is not None
                and r.camera_mask.all()}

    def same_as_batches(svc, res, what):
        """Each report bit-equal to its rig's slice of ``process_fleet``
        on the same batch, and to that rig's ``process_frame``."""
        reps = {(r.rig_id, r.t_arrival): r for r in res.reports}
        n = 0
        for batch in svc.batches:
            fleet = svc.vs.process_fleet(batch.images,
                                         camera_mask=batch.camera_mask)
            for b, rid in enumerate(batch.rig_ids):
                got = reps[(rid, batch.t_arrivals[b])].output
                equal_fields(got, rig_slice(fleet, b),
                             f"{what} rig {rid} vs process_fleet")
                equal_fields(got, svc.vs.process_frame(
                    batch.images[b], camera_mask=batch.camera_mask[b]),
                    f"{what} rig {rid} vs process_frame")
                n += 1
        if n != len(res.reports):
            raise AssertionError(f"{what}: {n} batch rows for "
                                 f"{len(res.reports)} reports")
        return n

    # 1. fault-free f32
    clean, clean_svc = episode("f32", frames, what="fault-free f32")
    c = clean.status["counters"]
    if c["frames_in"] != c["frames_out"] or c["frames_in"] != \
            SERVICE_RIGS * SERVICE_T or c["dropped_overflow"] or any(
            k.startswith("dropped") and v for k, v in c.items()):
        raise AssertionError(f"fault-free episode lost frames: {c}")
    if {r.status for r in clean.reports} != {"ok"}:
        raise AssertionError("fault-free episode: a report is not ok")
    n_same = same_as_batches(clean_svc, clean, "fault-free f32")
    log(f"[service fault-free f32] {n_same} reports bit-equal to their rig's "
        "slice of process_fleet on the same batch and to process_frame")

    # 2. the fault episode, f32, and the same episode on a CPU session
    faulty, faulty_svc = episode("f32", frames, SERVICE_SPECS, True,
                                 "faults f32")
    want, got = by_key(clean, SERVICE_HEALTHY), by_key(faulty,
                                                       SERVICE_HEALTHY)
    common = set(want) & set(got)
    if not common:
        raise AssertionError("fault episode: no healthy frame to compare")
    for key in common:
        equal_fields(got[key].output, want[key].output,
                     f"healthy rig {key[0]} fault vs fault-free")
    same_as_batches(faulty_svc, faulty, "faults f32")
    kinds = {(e.rig_id, e.kind) for e in faulty.events}
    if not {(4, "timeout"), (4, "restart")} <= kinds:
        raise AssertionError(f"fault episode: no restart of rig 4: {kinds}")
    small = ORBConfig(height=96, width=128, max_features=64,
                      max_disparity=64)
    sseq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=96, width=128, n_points=300, baseline=0.3), SERVICE_T,
        SERVICE_RIGS)
    cinj = serving.FaultInjector([serving.FaultSpec(**s)
                                  for s in SERVICE_SPECS], seed=9)
    cpu_svc = serving.FleetService(
        VisualSystem(RigConfig.quad(sseq.intrinsics, desync_policy="degrade",
                                    max_desync=1e-3),
                     PipelineConfig(orb=small), device="cpu"),
        serving.QueueConfig(), serving.SupervisorConfig(**SERVICE_SUP),
        cinj.clear_rig)
    cpu = serving.run_episode(cpu_svc, sseq.frames, dt=SERVICE_DT,
                              injector=cinj, settle_steps=SERVICE_SETTLE)
    events = [(e.kind, e.rig_id, e.now, e.at, e.attempt)
              for e in faulty.events]
    if events != [(e.kind, e.rig_id, e.now, e.at, e.attempt)
                  for e in cpu.events]:
        raise AssertionError("fault episode: the card's events differ from "
                             "the CPU session's")
    if faulty.status != cpu.status:
        raise AssertionError("fault episode: the card's status differs from "
                             "the CPU session's")
    meta = [[(r.rig_id, r.t, r.t_arrival, r.status, r.camera_mask.tolist(),
              r.late) for r in res.reports] for res in (faulty, cpu)]
    if meta[0] != meta[1]:
        raise AssertionError("fault episode: report metadata differ from "
                             "the CPU session's")
    log(f"[service faults f32] never raised; {len(common)} healthy full-mask "
        f"frames bit-equal to the fault-free episode; {len(events)} events "
        f"{[(k, r) for k, r, *_ in events]}, counters and status equal to "
        "the CPU session's at 96 x 128")

    # 3. uint8: the fault episode against f32 on the rounded frames, and
    #    the zero-copy intake of uint8 frames
    f32r, _ = episode("f32", rounded, SERVICE_SPECS, True, "faults f32 rounded")
    u8, _ = episode("uint8", frames, SERVICE_SPECS, True, "faults uint8")
    if [(r.rig_id, r.t_arrival, r.status) for r in u8.reports] != \
            [(r.rig_id, r.t_arrival, r.status) for r in f32r.reports]:
        raise AssertionError("uint8 fault episode: reports differ from f32's")
    for a, b in zip(u8.reports, f32r.reports):
        equal_fields(a.output, b.output, f"uint8 rig {a.rig_id} vs f32")
    frames_u8 = np.clip(rounded, 0, 255).astype(np.uint8)
    zsvc = counting(service("uint8"), "fault-free uint8")
    put, copies = zsvc.queue.put, []

    def zero_copy_put(rig_id, images, t_arrival, camera_mask=None):
        copies.append(not np.shares_memory(images, frames_u8))
        put(rig_id, images, t_arrival, camera_mask=camera_mask)

    zsvc.queue.put = zero_copy_put
    zres = serving.run_episode(zsvc, frames_u8, dt=SERVICE_DT,
                               settle_steps=SERVICE_SETTLE)
    if not copies or any(copies):
        raise AssertionError(f"uint8 intake copied {sum(copies)} of "
                             f"{len(copies)} frames")
    log(f"[service uint8] fault episode: {len(u8.reports)} reports bit-equal "
        "to the f32 session's on the rounded frames; fault-free on uint8 "
        f"frames: {len(copies)} intakes, none copied, "
        f"{len(zres.reports)} reports")

    # 4. localized: the fault episode, then the quarantine drive
    loc, _ = episode("localized", frames, SERVICE_SPECS, True,
                     "faults localized")
    for r in loc.reports:
        for t in (r.output.pose.rotation, r.output.pose.translation,
                  r.output.points):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"localized rig {r.rig_id}: non-finite "
                                     "pose or points")
    n_valid = sum(bool(r.output.pose.valid) for r in loc.reports)
    if not n_valid:
        raise AssertionError("localized episode: no valid pose")
    qsvc = counting(service("localized"), "quarantine drive")
    now = 0.0
    for r in range(SERVICE_RIGS):
        qsvc.submit(r, frames[0, r], now)
    qsvc.step(now, force=True)
    t = 1
    while (1, "quarantine") not in [(e.rig_id, e.kind) for e in qsvc.events]:
        if t >= 200:
            raise AssertionError("quarantine drive: rig 1 never quarantined")
        now = t * SERVICE_DT
        for r in range(SERVICE_RIGS):
            if r != 1:
                qsvc.submit(r, frames[t % SERVICE_T, r], now)
        qsvc.step(now, force=True)
        t += 1
    if qsvc.supervisor.health(1) is not serving.RigHealth.QUARANTINED or \
            1 in qsvc._loc_state or \
            set(qsvc._loc_state) != set(range(SERVICE_RIGS)) - {1}:
        raise AssertionError("quarantine drive: pose state not dropped for "
                             "rig 1 alone")
    log(f"[service localized] {len(loc.reports)} reports, 4 launches a "
        f"batch, poses finite, {n_valid} valid; quarantine drive: rig 1 "
        f"quarantined after {t} ticks, its pose state dropped, the other "
        f"{SERVICE_RIGS - 1} kept")

    # 5. the wire format on the card
    wire_stats = {"fault_free": check_wire([r.output for r in clean.reports],
                                           "fault-free"),
                  "localized": check_wire([r.output for r in loc.reports],
                                          "localized")}
    log(f"[service wire] {wire_stats}: card payloads byte-identical to the "
        "CPU encoding")
    log(f"[service] every input of K1-K4 on the counted steps held to its "
        f"plain version: {held['calls']} inputs, sparse FE moments within "
        f"{held['moment_err']}")

    # timings, in turns
    vs = sessions["f32"]
    tick_svc = service("f32")
    u8_svc = service("uint8")
    host = [frames[0, r] for r in range(SERVICE_RIGS)]
    host_u8 = [frames_u8[0, r] for r in range(SERVICE_RIGS)]
    on_card = torch.from_numpy(frames[0]).to(dev)
    clock = {"now": 0.0}

    def submits(svc, imgs):
        clock["now"] += SERVICE_DT
        for r, im in enumerate(imgs):
            svc.submit(r, im, clock["now"])

    def tick():
        submits(tick_svc, host)
        tick_svc.step(clock["now"], force=True)

    runs = {"tick": [], "step": [], "process_fleet": [],
            "process_fleet_host": [], "submit_f32": [], "submit_u8": []}
    for rep in range(REPS + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        runs["tick"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        submits(tick_svc, host)
        runs["submit_f32"].append((time.perf_counter() - t0) * 1e3
                                  / SERVICE_RIGS)
        t0 = time.perf_counter()
        tick_svc.step(clock["now"], force=True)
        torch.cuda.synchronize()
        runs["step"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        vs.process_fleet(on_card)
        torch.cuda.synchronize()
        runs["process_fleet"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        vs.process_fleet(frames[0])
        torch.cuda.synchronize()
        runs["process_fleet_host"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        submits(u8_svc, host_u8)
        runs["submit_u8"].append((time.perf_counter() - t0) * 1e3
                                 / SERVICE_RIGS)
        u8_svc.queue.restore_pending([])
    med = {k: statistics.median(v[3:]) for k, v in runs.items()}
    for k, v in runs.items():
        log(f"[service latency] {k}: median {med[k]:.4f} ms over {REPS} "
            f"(min {min(v[3:]):.4f}, max {max(v[3:]):.4f})"
            f"{' a rig frame' if k.startswith('submit') else ''}")
    upload = {}
    for dtype, imgs in (("f32", host), ("uint8", host_u8)):
        q = serving.FrameQueue(rig, (cfg.height, cfg.width),
                               dtype=np.dtype(imgs[0].dtype), device=dev)
        batch_np = np.stack(imgs)
        times = {"next_batch": [], "copy": []}
        for _ in range(REPS + 3):
            q.restore_pending([])
            for r, im in enumerate(imgs):
                q.put(r, im, 0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q.next_batch(1.0, force=True)
            torch.cuda.synchronize()
            times["next_batch"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            torch.from_numpy(batch_np).to(dev)
            torch.cuda.synchronize()
            times["copy"].append((time.perf_counter() - t0) * 1e3)
        upload[dtype] = {k: statistics.median(v[3:]) for k, v in
                         times.items()}
        upload[dtype]["bytes"] = batch_np.nbytes
        log(f"[service upload] {dtype} 8-rig batch ({batch_np.nbytes} bytes): "
            f"next_batch {upload[dtype]['next_batch']:.4f} ms, the copy alone "
            f"{upload[dtype]['copy']:.4f} ms (medians of {REPS})")
    summary = {}
    profile_frames(vs, None, call=tick, summary=summary)
    log("[service profile] a tick: 8 submits and one 8-rig step, the idle "
        "share above")
    codec = {}
    for kind, out in (("stereo", clean.reports[0].output),
                      ("localized", loc.reports[0].output)):
        enc, dec = [], []
        for _ in range(REPS + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wire = serving.wire_encode(out)
            torch.cuda.synchronize()
            enc.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            serving.wire_decode(wire)
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t0) * 1e3)
        codec[kind] = {"encode_ms": statistics.median(enc[3:]),
                       "decode_ms": statistics.median(dec[3:]),
                       "wire_bytes": compression.wire_bytes(wire),
                       "tensor_bytes": tensor_bytes(out),
                       "host_syncs": {
                           "encode": host_syncs(
                               lambda: serving.wire_encode(out)),
                           "decode": host_syncs(
                               lambda: serving.wire_decode(wire))}}
        log(f"[service wire] a 720p quad {kind} output: wire_bytes "
            f"{codec[kind]['wire_bytes']} against {codec[kind]['tensor_bytes']}"
            f" bytes of tensors; encode {codec[kind]['encode_ms']:.4f} ms, "
            f"decode {codec[kind]['decode_ms']:.4f} ms (medians of {REPS}); "
            f"synchronizing calls {codec[kind]['host_syncs']}")
    submits(tick_svc, host)
    step_syncs = host_syncs(lambda: tick_svc.step(clock["now"], force=True))
    log(f"[service] synchronizing calls in an 8-rig step: {step_syncs}")
    stats = {"latency_ms": med, "upload_ms": upload,
             "step_host_syncs": step_syncs,
             "profile_tick": summary, "wire": codec,
             "wire_checks": wire_stats,
             "events_fault_episode": len(events),
             "counters_fault_episode": faulty.status["counters"],
             "held_to_plain": held}
    return total, total_u8, stats


# The failover episodes (phase 16): 8 rigs, T = 6, a crash after tick
# FAILOVER_CRASH_AT.  (mode, guarded, host map, specs, crash).  In the
# crash episodes and their base, rig 7's frame 1 never arrives: tick 1's
# seven frames wait (no full bucket, no deadline), so from tick 2 on each
# tick serves 8 and leaves 7 pending, the crash's snapshot included.
FAILOVER_CRASH_AT = 2
FAILOVER_STALL = dict(kind="stalled_rig", rig=SERVICE_RIGS - 1, start=1,
                      stop=2)
FAILOVER_GUARD = dict(timeout_s=120.0, max_attempts=2,
                      backoff_base_s=SERVICE_DT,
                      backoff_max_s=4 * SERVICE_DT, seed=0)
FAILOVER_EPISODES = {
    "base_f32": ("f32", False, False, (), False),
    "base_localized": ("localized", False, False, (FAILOVER_STALL,),
                       False),
    "kill_recover": ("localized", False, False, (FAILOVER_STALL,), True),
    "corrupt_snapshot": ("localized", False, False,
                         (FAILOVER_STALL,
                          dict(kind="corrupt_snapshot",
                               start=FAILOVER_CRASH_AT)), True),
    "host_down": ("localized", False, True,
                  (dict(kind="host_down", rig="host0", start=2),), False),
    "dispatch_error": ("f32", True, False,
                       (dict(kind="dispatch_error", start=1, stop=3,
                             magnitude=1),), False),
    "stuck_dispatch": ("f32", True, False,
                       (dict(kind="stuck_dispatch", start=1, stop=3,
                             magnitude=2),), False),
}
FAILOVER_VS_CPU = ("kill_recover", "corrupt_snapshot", "host_down",
                   "dispatch_error", "stuck_dispatch")


def failover_episode(sessions, name: str, frames, snap_dir: str,
                     count=None):
    """Episode ``name`` of ``FAILOVER_EPISODES`` over ``sessions`` (mode
    -> session), snapshotting every tick into ``snap_dir`` and keeping
    every step; ``count`` wraps each service it makes (the restored one
    too).  Returns (result, the services made, the injector)."""
    from repro_torch import serving
    from repro_torch.launch import host_fault_domains
    mode, guarded, hosts, specs, crash = FAILOVER_EPISODES[name]
    inj = serving.FaultInjector([serving.FaultSpec(**s) for s in specs],
                                seed=11)
    made = []

    def make():
        svc = serving.FleetService(
            sessions[mode], serving.QueueConfig(),
            serving.SupervisorConfig(**SERVICE_SUP),
            guard=(serving.DispatchGuard(serving.DispatchGuardConfig(
                **FAILOVER_GUARD)) if guarded else None),
            host_map=(serving.HostMap(host_fault_domains({"data": 2}))
                      if hosts else None))
        made.append(svc if count is None
                    else count(svc, f"{name} service {len(made)}"))
        return made[-1]

    res = serving.run_episode(
        make(), frames, dt=SERVICE_DT, injector=inj,
        settle_steps=SERVICE_SETTLE, snapshot_dir=snap_dir,
        snapshot_keep=len(frames), crash_at=FAILOVER_CRASH_AT if crash else None,
        restore=make if crash else None)
    return res, made, inj


def scheduled_dispatch_faults(svc, res, inj, what: str) -> dict:
    """Every fault the guard saw was one the injector scheduled: for each
    dispatch ordinal, the injector's modes on attempts 1, 2, ... up to
    its first fault-free attempt give the expected faults
    (``"error:InjectedDispatchError"``, ``"stall"``), the event kind and
    whether the batch dropped; the events and ``dispatch_errors``,
    ``dispatch_stalls``, ``dispatch_retries`` and ``dropped_dispatch``
    must equal what those imply, or the run fails.  Returns the counts."""
    from repro_torch.serving import DispatchEvent
    attempts = svc.guard.cfg.max_attempts
    want_events, want = [], dict.fromkeys(
        ("dispatch_errors", "dispatch_stalls", "dispatch_retries",
         "dropped_dispatch"), 0)
    n_dispatch = svc.counters["dispatches"]
    if n_dispatch != len(svc.batches):
        raise AssertionError(f"{what}: {n_dispatch} dispatches for "
                             f"{len(svc.batches)} batches")
    for d, batch in enumerate(svc.batches):
        faults = []
        for a in range(1, attempts + 1):
            mode = inj.dispatch_fault(d, a)
            if mode is None:
                break
            faults.append("stall" if mode == "stall"
                          else "error:InjectedDispatchError")
        if not faults:
            continue
        ok = len(faults) < attempts
        want["dispatch_stalls"] += faults.count("stall")
        want["dispatch_errors"] += len(faults) - faults.count("stall")
        want["dispatch_retries"] += (len(faults) + ok) - 1
        want["dropped_dispatch"] += 0 if ok else len(batch.rig_ids)
        want_events.append(("dispatch_recovered" if ok else "dispatch_drop",
                            d, len(faults) + ok, tuple(faults)))
    got_events = [(e.kind, e.dispatch, e.attempts, e.faults)
                  for e in res.events if isinstance(e, DispatchEvent)]
    got = {k: res.status["counters"].get(k, 0) for k in want}
    if got_events != want_events or got != want:
        raise AssertionError(f"{what}: dispatch faults {got_events}, counts "
                             f"{got}; the injector scheduled {want_events}, "
                             f"{want}")
    return want


def hold_snapshot_leaves(card_dir: str, cpu_dir: str, cpu_res,
                         what: str) -> dict:
    """The snapshots a card session and a CPU session wrote of one
    episode at 96 x 128, step by step: equal step lists and indexes
    (leaf file names too: one process), manifests equal but for the
    leaves' CRCs, every leaf of one dtype and shape, pending frames and
    masks byte-equal, and each rig's state as the card-against-CPU rule
    holds its output (``hold_fleet_card_vs_cpu``): descriptors equal
    away from a steering-bin edge of the CPU's theta (the rig's last
    report by the step's time), and where they are equal, ``meta`` and
    ``valid`` byte-equal and the points equal in value (the rotation's
    zero terms may sum to -0 on one device and +0 on the other)."""
    from repro_torch.checkpoint import store
    steps = store.list_steps(card_dir)
    if not steps or steps != store.list_steps(cpu_dir):
        raise AssertionError(f"{what}: snapshot steps {steps} and "
                             f"{store.list_steps(cpu_dir)}")
    n_leaves = n_pending = n_diff = 0
    for step in steps:
        index, flat, meta = [], [], []
        for d in (card_dir, cpu_dir):
            path = os.path.join(d, f"step_{step:08d}", "index.json")
            with open(path) as f:
                index.append(json.load(f))
            flat.append(store.load_flat(d, step))
            meta.append(json.loads(bytes(flat[-1]["meta"]).decode()))
        if index[0] != index[1]:
            raise AssertionError(f"{what} step {step}: indexes differ")
        crcs = [m.pop("leaf_crcs") for m in meta]
        if meta[0] != meta[1]:
            raise AssertionError(f"{what} step {step}: manifests differ")
        leaves = [[f[f"leaves§{i}"] for i in range(meta[0]["n_leaves"])]
                  for f in flat]
        for i, (a, b) in enumerate(zip(*leaves)):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{what} step {step} leaf {i}: "
                                     f"{a.dtype}{a.shape} {b.dtype}{b.shape}")
        now = step * SERVICE_DT + 0.5 * SERVICE_DT
        theta = {}
        for r in cpu_res.reports:
            if r.t <= now and r.output is not None:
                theta[r.rig_id] = r.output.stereo.features_l.theta
        n_loc = len(meta[0]["loc_rigs"])
        for j, enc in enumerate(meta[0]["loc_rigs"]):
            desc, mt, pts, valid = zip(*[ls[4 * j:4 * j + 4]
                                         for ls in leaves])
            diff = torch.from_numpy((desc[0] != desc[1]).any(-1))
            th = theta[enc[1]]
            edge = near_bin_edge(th, 4.0 * torch.from_numpy(
                np.spacing(np.abs(th.numpy()))))
            if bool((diff & ~edge).any()):
                raise AssertionError(f"{what} step {step} rig {enc[1]}: "
                                     "descriptors differ away from a bin "
                                     "edge")
            n_diff += int(diff.sum())
            if bool(diff.any()):
                continue
            if mt[0].tobytes() != mt[1].tobytes() or \
                    valid[0].tobytes() != valid[1].tobytes() or \
                    not np.array_equal(pts[0], pts[1]):
                raise AssertionError(f"{what} step {step} rig {enc[1]}: "
                                     "state differs from the CPU's")
            n_leaves += 4
        for i in range(4 * n_loc, meta[0]["n_leaves"]):
            if leaves[0][i].tobytes() != leaves[1][i].tobytes() or \
                    crcs[0][i] != crcs[1][i]:
                raise AssertionError(f"{what} step {step}: pending leaf "
                                     f"{i} differs from the CPU's")
            n_leaves += 1
            n_pending += 1
    if not n_pending:
        raise AssertionError(f"{what}: no pending frame in any snapshot")
    return {"steps": steps, "leaves_held": n_leaves,
            "pending_leaves_held": n_pending,
            "descriptors_at_bin_edge": n_diff}


def failover_phase(cfg, dev):
    """Failover and crash-consistent snapshots at full width (phase 16):
    ``FleetService`` over card sessions, ``QueueConfig()``, 8 rigs of
    phase 15's fleet (``service_sequence``), T = 6, snapshots every tick
    into a temporary directory; every step counted and every K1-K4 input
    held to plain (``count_steps``, the restored services' steps too).

    1. Kill and recover, localized: a crash after tick 2 and a fresh
       service from ``restore()``; every rig's reports bit-equal to the
       uninterrupted episode's, except the pose of each rig's first
       frame after the restore, identity with ``valid=False``; the
       frames pending at the crash (``FAILOVER_STALL`` leaves 7) are
       those of its snapshot and the restored service serves them;
       every frame served, none pending at the end.
    2. The same with a ``corrupt_snapshot`` spec: ``recovery`` names
       step 1 and ``snapshot_fallback`` is true.
    3. ``host_down`` of host0 over ``HostMap(host_fault_domains({"data":
       2}))`` at frame 2, localized: every rig serves every frame, each
       moved rig's first frame after the event does not chain.
    4. Under a ``DispatchGuard`` in a non-default stream: a
       ``dispatch_error`` of magnitude 1 (2 attempts) recovers, its
       reports bit-equal to the fault-free episode's; a
       ``stuck_dispatch`` of magnitude 2 drops its window's batches.
       Every fault the guard saw is one the injector scheduled, and the
       counters are those the specs imply (``scheduled_dispatch_faults``).
    5. Episodes 1-4 on a CPU session at 96 x 128: equal events, status,
       recovery (less its wall clock) and report metadata; and the
       kill-and-recover snapshots a card session writes at 96 x 128
       held to the CPU session's, leaf by leaf, pending frames too
       (``hold_snapshot_leaves``).

    Then, each beside the card: ``snapshot.save`` ms a tick at 8 rigs,
    localized (into a new directory each time), and its parts: the
    state's copies to the host (``_capture``) and ``store.save`` of the
    captured tree, with its fsyncs and with ``os.fsync`` a no-op;
    ``snapshot.load`` and
    ``snapshot.restore`` ms (a fresh service and its restore: the
    recovery wall clock), of that step and through a newest step torn
    as the injector tears it; a guarded no-op call's ms; and a guarded
    step's ms against an unguarded one's, in turns; medians of 20.
    Returns (launches of each kernel on the counted steps, stats)."""
    import tempfile
    from unittest import mock

    from repro_torch import serving
    from repro_torch.checkpoint import store
    from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                                  VisualSystem)
    from repro_torch.data import scenes

    seq = service_sequence(cfg)
    frames = seq.frames
    rig = RigConfig.quad(seq.intrinsics, desync_policy="degrade",
                         max_desync=1e-3)
    modes = (("f32", {}), ("localized", {"localize": True}))
    card = {m: VisualSystem(rig, PipelineConfig(orb=cfg, **p), device="cuda")
            for m, p in modes}
    small = ORBConfig(height=96, width=128, max_features=64,
                      max_disparity=64)
    sseq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=96, width=128, n_points=300, baseline=0.3), SERVICE_T,
        SERVICE_RIGS)
    srig = RigConfig.quad(sseq.intrinsics, desync_policy="degrade",
                          max_desync=1e-3)
    cpu = {m: VisualSystem(srig, PipelineConfig(orb=small, **p),
                           device="cpu") for m, p in modes}
    acc = new_launch_acc()
    side = torch.cuda.Stream()
    res, made, injs = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="failover_") as tmp:
        for name in FAILOVER_EPISODES:
            guarded = FAILOVER_EPISODES[name][1]
            with torch.cuda.stream(side) if guarded else \
                    contextlib.nullcontext():
                res[name], made[name], injs[name] = failover_episode(
                    card, name, frames, os.path.join(tmp, name),
                    count=lambda svc, what: count_steps(svc, what, acc))
            torch.cuda.synchronize()
            r = res[name]
            n_batches = sum(len(svc.batches) for svc in made[name])
            log(f"[failover {name}] {len(r.reports)} reports, {n_batches} "
                f"batches counted over {len(made[name])} service(s), "
                f"{len(r.events)} events, recovery {r.recovery}, counters "
                f"{dict(sorted(r.status['counters'].items()))}")

        def by_key(result):
            return {(r.rig_id, round(r.t_arrival, 9)): r
                    for r in result.reports if r.output is not None}

        # 1. kill and recover
        crash_time = FAILOVER_CRASH_AT * SERVICE_DT + 0.5 * SERVICE_DT + 1e-9
        base, crashed = by_key(res["base_localized"]), by_key(
            res["kill_recover"])
        n_frames = SERVICE_RIGS * SERVICE_T - (FAILOVER_STALL["stop"]
                                               - FAILOVER_STALL["start"])
        if set(base) != set(crashed) or len(base) != n_frames:
            raise AssertionError("kill and recover: served frames differ "
                                 "from the uninterrupted episode's")
        st = res["kill_recover"].status
        if st["queue"]["pending"] or st["counters"]["frames_out"] != n_frames:
            raise AssertionError(f"kill and recover: frames lost {st}")
        rec = res["kill_recover"].recovery
        if rec["restored_step"] != FAILOVER_CRASH_AT or \
                rec["snapshot_fallback"]:
            raise AssertionError(f"kill and recover: recovery {rec}")
        # the frames pending at the crash went through its snapshot and
        # were served by the restored service
        crash_meta = serving.snapshot._load_step(
            os.path.join(tmp, "kill_recover"), FAILOVER_CRASH_AT)[0]
        at_crash = {(p["rig_id"][1], round(p["t_arrival"], 9))
                    for p in crash_meta["pending"]}
        carried = {k for k, r in crashed.items()
                   if r.t > crash_time and r.t_arrival < crash_time}
        if not at_crash or carried != at_crash:
            raise AssertionError(f"kill and recover: pending at the crash "
                                 f"{sorted(at_crash)}, served after the "
                                 f"restore {sorted(carried)}")
        first_after, n_equal, n_valid_after = {}, 0, 0
        for key in sorted(crashed, key=lambda k: (crashed[k].t, k)):
            if crashed[key].t > crash_time:
                first_after.setdefault(key[0], key)
        if len(first_after) != SERVICE_RIGS:
            raise AssertionError("kill and recover: a rig never served "
                                 "after the restore")
        eye = torch.eye(3, device=dev)
        for key, got in crashed.items():
            want = base[key]
            equal_fields(got.output.stereo, want.output.stereo,
                         f"kill and recover rig {key[0]} stereo")
            equal_or_raise(got.output.points, want.output.points,
                           f"kill and recover rig {key[0]} points")
            if first_after[key[0]] == key:
                pose = got.output.pose
                if bool(pose.valid.any()) or not torch.equal(
                        pose.rotation, eye) or bool(pose.translation.any()):
                    raise AssertionError(f"kill and recover rig {key[0]}: "
                                         "chained a pose across the crash")
            else:
                equal_fields(got.output.pose, want.output.pose,
                             f"kill and recover rig {key[0]} pose")
                n_valid_after += got.t > crash_time and bool(
                    got.output.pose.valid)
            n_equal += 1
        if not n_valid_after:
            raise AssertionError("kill and recover: no pose chain was "
                                 "re-established")
        log(f"[failover kill_recover] {n_equal} reports bit-equal to the "
            f"uninterrupted episode; each rig's first frame after the "
            f"restore identity with valid=False; {n_valid_after} valid "
            f"poses after it; the {len(at_crash)} frames pending at the "
            "crash served by the restored service; none pending at the "
            f"end; restore {rec['recovery_wall_s'] * 1e3:.4f} ms")

        # 2. a torn newest snapshot
        rec = res["corrupt_snapshot"].recovery
        if rec["restored_step"] != FAILOVER_CRASH_AT - 1 or \
                not rec["snapshot_fallback"]:
            raise AssertionError(f"torn snapshot: recovery {rec}")
        if res["corrupt_snapshot"].status["queue"]["pending"] or not any(
                r.t > crash_time for r in res["corrupt_snapshot"].reports):
            raise AssertionError("torn snapshot: nothing served after the "
                                 "restore, or frames left pending")
        log(f"[failover corrupt_snapshot] recovered from step "
            f"{rec['restored_step']} (fallback), "
            f"{rec['recovery_wall_s'] * 1e3:.4f} ms")

        # 3. host down
        hd = res["host_down"]
        host_evs = [e for e in hd.events
                    if getattr(e, "kind", None) == "host_down"]
        moved = [r for r, _ in host_evs[0].moved] if host_evs else []
        if len(host_evs) != 1 or not moved or \
                hd.status["hosts"]["hosts"] != ["host1"] or \
                hd.status["counters"]["rigs_redistributed"] != len(moved):
            raise AssertionError(f"host down: events {host_evs}, status "
                                 f"{hd.status.get('hosts')}")
        served = by_key(hd)
        for rid in range(SERVICE_RIGS):
            if sum(k[0] == rid for k in served) != SERVICE_T:
                raise AssertionError(f"host down: rig {rid} missed frames")
        for rid in moved:
            post = sorted((r for k, r in served.items() if k[0] == rid
                           and r.t > host_evs[0].now), key=lambda r: r.t)
            if not post or bool(post[0].output.pose.valid.any()):
                raise AssertionError(f"host down: moved rig {rid} chained "
                                     "across its migration")
        log(f"[failover host_down] host0's rigs {moved} moved to host1, "
            f"every rig served all {SERVICE_T} frames, each moved rig's "
            "first frame after the event unchained")

        # 4. the guard
        dispatch = {}
        for name in ("dispatch_error", "stuck_dispatch"):
            dispatch[name] = scheduled_dispatch_faults(
                made[name][0], res[name], injs[name], name)
        base_f = by_key(res["base_f32"])
        got = by_key(res["dispatch_error"])
        if set(got) != set(base_f):
            raise AssertionError("dispatch_error: served frames differ from "
                                 "the fault-free episode's")
        for key, r in got.items():
            equal_fields(r.output, base_f[key].output,
                         f"dispatch_error rig {key[0]}")
        if not dispatch["stuck_dispatch"]["dropped_dispatch"]:
            raise AssertionError("stuck_dispatch dropped nothing")
        log(f"[failover guard] in a side stream, 3 launches a guarded batch "
            f"as unguarded; every fault scheduled by the injector: "
            f"{dispatch}; dispatch_error's {len(got)} reports bit-equal to "
            "the fault-free episode's")

        # 5. against the CPU
        cpu_frames = np.round(sseq.frames)
        cpu_res = {}
        for name in FAILOVER_VS_CPU:
            card_r = res[name]
            cpu_res[name] = c = failover_episode(
                cpu, name, cpu_frames, os.path.join(tmp, "cpu_" + name))[0]
            same = ([tuple(e) for e in card_r.events] ==
                    [tuple(e) for e in c.events]
                    and card_r.status == c.status
                    and [(r.rig_id, r.t, r.t_arrival, r.status, r.late)
                         for r in card_r.reports] ==
                    [(r.rig_id, r.t, r.t_arrival, r.status, r.late)
                     for r in c.reports])
            strip = [None if x.recovery is None else
                     {k: v for k, v in x.recovery.items()
                      if k != "recovery_wall_s"} for x in (card_r, c)]
            if not same or strip[0] != strip[1]:
                raise AssertionError(f"{name}: the card's events, status, "
                                     "recovery or reports differ from the "
                                     "CPU session's")
        small_card = {m: VisualSystem(srig, PipelineConfig(orb=small, **p),
                                      device="cuda") for m, p in modes}
        failover_episode(small_card, "kill_recover", cpu_frames,
                         os.path.join(tmp, "card_small"))
        torch.cuda.synchronize()
        leaves = hold_snapshot_leaves(os.path.join(tmp, "card_small"),
                                      os.path.join(tmp, "cpu_kill_recover"),
                                      cpu_res["kill_recover"],
                                      "snapshot leaves")
        log(f"[failover] episodes {list(FAILOVER_VS_CPU)}: events, status, "
            "recovery and report metadata equal to a CPU session's at 96 x "
            f"128; kill-and-recover snapshot leaves held to the CPU's: "
            f"{leaves}")
        log(f"[failover] every input of K1-K4 on the counted steps held to "
            f"its plain version: {acc['held']['calls']} inputs, sparse FE "
            f"moments within {acc['held']['moment_err']}")

        # timings, in turns, beside the card
        log(card_line())
        loc = serving.FleetService(card["localized"], serving.QueueConfig())
        for t in range(2):
            for r in range(SERVICE_RIGS):
                loc.submit(r, frames[t, r], t * SERVICE_DT)
            loc.step(t * SERVICE_DT, force=True)
        torch.cuda.synchronize()
        runs = {k: [] for k in ("snapshot_save", "snapshot_capture",
                                "store_save", "store_save_nofsync",
                                "snapshot_load", "snapshot_restore",
                                "snapshot_load_torn", "snapshot_restore_torn",
                                "guard_noop")}

        def timed(key, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            runs[key].append((time.perf_counter() - t0) * 1e3)
            return out

        def restore_fresh(d):
            fresh = serving.FleetService(card["localized"],
                                         serving.QueueConfig())
            return fresh, serving.snapshot.restore(fresh, d)

        for rep in range(REPS + 3):
            good = os.path.join(tmp, "timing", str(rep))
            timed("snapshot_save",
                  lambda: serving.snapshot.save(loc, good, step=0))
            # the save in parts: the state's copies to the host, then the
            # store's writes with and without their fsyncs
            meta, captured = timed("snapshot_capture",
                                   lambda: serving.snapshot._capture(loc))
            tree = {"meta": np.frombuffer(json.dumps(meta).encode(),
                                          np.uint8).copy(),
                    "leaves": captured}
            timed("store_save", lambda: store.save(
                os.path.join(tmp, "store", str(rep)), 0, tree))
            with mock.patch.object(os, "fsync", lambda fd: None):
                timed("store_save_nofsync", lambda: store.save(
                    os.path.join(tmp, "nofsync", str(rep)), 0, tree))
            timed("snapshot_load", lambda: serving.snapshot.load(good))
            fresh, got = timed("snapshot_restore",
                               lambda: restore_fresh(good))
            if got != 0 or set(fresh._loc_state) != set(range(SERVICE_RIGS)):
                raise AssertionError("timing: the restore lost rigs' states")
            # the newest step torn (the injector's tear of a crash at 2)
            torn = os.path.join(tmp, "torn", str(rep))
            for step in (0, 1):
                serving.snapshot.save(loc, torn, step=step)
            cut = serving.FaultInjector(
                [serving.FaultSpec("corrupt_snapshot", start=2)],
                seed=rep).snapshot_corruption(2)
            serving.snapshot.corrupt_newest(torn, cut["leaf_index"],
                                            cut["keep_fraction"])
            if timed("snapshot_load_torn",
                     lambda: serving.snapshot.load(torn))[0] != 0:
                raise AssertionError("timing: the torn step was loaded")
            if timed("snapshot_restore_torn",
                     lambda: restore_fresh(torn))[1] != 0:
                raise AssertionError("timing: the torn restore did not fall "
                                     "back a step")
        noop = serving.DispatchGuard(serving.DispatchGuardConfig(
            **FAILOVER_GUARD))
        for rep in range(REPS + 3):
            if not timed("guard_noop", lambda: noop.run(rep, int)).ok:
                raise AssertionError("timing: a no-op guarded call failed")
        plain = serving.FleetService(card["f32"], serving.QueueConfig())
        guarded = serving.FleetService(
            card["f32"], serving.QueueConfig(),
            guard=serving.DispatchGuard(serving.DispatchGuardConfig(
                **FAILOVER_GUARD)))
        step_ms = {"unguarded": [], "guarded": []}
        for rep in range(REPS + 3):
            now = rep * SERVICE_DT
            order = (("unguarded", plain), ("guarded", guarded))
            for label, svc in order[::1 if rep % 2 == 0 else -1]:
                for r in range(SERVICE_RIGS):
                    svc.submit(r, frames[rep % SERVICE_T, r], now)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if not svc.step(now, force=True):
                    raise AssertionError(f"timing: {label} step served "
                                         "nothing")
                torch.cuda.synchronize()
                step_ms[label].append((time.perf_counter() - t0) * 1e3)
        if guarded.counters["dispatches"] != REPS + 3 or any(
                isinstance(e, serving.DispatchEvent)
                for e in guarded.events):
            raise AssertionError("timing: the guarded steps saw a fault")
    runs["step_unguarded"] = step_ms["unguarded"]
    runs["step_guarded"] = step_ms["guarded"]
    med = {k: statistics.median(v[3:]) for k, v in runs.items()}
    for k, v in runs.items():
        log(f"[failover latency] {k}: median {med[k]:.4f} ms over {REPS} "
            f"(min {min(v[3:]):.4f}, max {max(v[3:]):.4f}), 8 rigs at 720p")
    stats = {"latency_ms": med, "launches": {
        n: c for n, c in acc["total"].items() if c},
        "held_to_plain": acc["held"], "dispatch": dispatch,
        "recovery": {n: res[n].recovery for n in ("kill_recover",
                                                  "corrupt_snapshot")},
        "host_down_moved": moved, "snapshot_leaves_vs_cpu": leaves}
    return acc["total"], stats


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
    sass_mix()

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

    textured = check_dense_textured(frame, cfg, dev)
    textured_fm = check_sparse_matcher_textured(frame, cfg, intr, dev)
    crowded = {}
    for variant, imgs in (("f32", torch.from_numpy(np.round(frame))),
                          ("u8", torch.from_numpy(np.round(frame)).to(
                              torch.uint8))):
        crowded[variant] = check_matcher_args(
            crowded_matcher_args(imgs.to(dev), cfg), cfg,
            f"crowded row band {variant}")
        log(f"[matcher/crowded row band {variant}] "
            f"{crowded[variant]['ms']:.4f} ms event, device "
            f"{crowded[variant]['device_ms']}, bound "
            f"{crowded[variant]['bound_ms']:.6f} "
            f"({crowded[variant]['bound_by']})")
    floor = empty_launch_floor()

    # 4. the main path through the session entry point
    vs = VisualSystem(RigConfig.quad(intr), PipelineConfig(), device="cuda")
    images = torch.from_numpy(frame).to(dev)
    out, launches = counted(lambda: vs.process_frame(images),
                            {n: 1 for n in ops.FRAME_KERNELS},
                            "process_frame launches each kernel once")
    log(f"[main path] launches {launches}")
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
    profiled = profile_frames(vs, images)

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

    # 5. the single-image FE API at full width
    single_counts, single_stats, module_split = single_image_phase(
        frame, cfg, dev)

    # 6. the localized path at full width, and K4 on the inputs it
    #    received there
    vs_loc, seq_frames, loop_counts, k4_frame, k4_run, loc, seq_poses = (
        localized_phase(cfg, dev))
    mo_frame = check_match_only(*k4_frame, "temporal, localized frame 720p")
    mo_run = check_match_only(*k4_run, f"temporal, run 720p T={SEQ_T}")

    # 7. the matcher entry points at full width, and K4 and K5 on the
    #    inputs they received there
    cpu_loc = VisualSystem(vs_loc.rig, vs_loc.pipe, device="cpu")
    entry_counts, k4_stereo, k5_calls = entry_points(
        vs_loc, cpu_loc, vs_loc, seq_frames[0], seq_frames[1],
        vs_loc.rig.pairs, "720p")
    mo_stereo = check_match_only(*stacked(k4_stereo), "stereo_match 720p")
    sad_stats = check_sad_only(*stacked(k5_calls), "sad_rectify 720p")

    # 8. the unfused FM schedule (K9, K10) at full width, and the legacy
    #    frame shim
    unfused_counts, unfused_stats = unfused_phase(vs_loc, seq_frames[0],
                                                  images, intr, out)

    # 9. the card's session against the CPU session, small sequence
    small_sequence_phase()

    # 10. the per-level FE schedule (K6, K7) at full width
    per_level_counts, per_level_stats, schedules = per_level_phase(
        frame, cfg, dev)

    # 11. the uint8 datapath (the uint8 variants of K1-K3, K5-K8) at full
    #     width
    u8_counts, u8_stats, u8_latency = uint8_phase(
        frame, intr, vs_loc.rig, seq_frames, seq_poses, cfg, dev)

    # 12. fleet frames (K1-K4 with the rig axis folded in) at full width
    fleet_counts, fleet_u8_counts, fleet_stats = fleet_phase(cfg, dev)

    # 13. the pipelined schedule (FE and FM on two streams) at full width
    pipe_counts, pipe_u8_counts, pipe_stats = pipelined_phase(
        cfg, dev, vs_loc.rig, seq_frames, intr)

    # 14. the pose backend and the Tab. I split at full width
    vo_counts, vo_stats = backend_phase(cfg, dev, seq_frames, seq_poses,
                                        intr)

    # 15. the fleet service (FleetService, run_episode, the wire format)
    #     at full width
    service_counts, service_u8_counts, service_stats = service_phase(cfg, dev)

    # 16. failover and crash-consistent snapshots at full width; their
    #     launches join phase 15's under service_launches
    failover_counts, failover_stats = failover_phase(cfg, dev)
    service_stats["phase15_launches"] = {
        n: c for n, c in service_counts.items() if c}
    service_counts = {n: c + failover_counts[n]
                      for n, c in service_counts.items()}

    # 17. result lines
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
        prof = [ms for key, ms in profiled.items() if symbol[name] in key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None,
            "ms_integer_frames": results["integer"][i]["ms"],
            "profiled_device_ms": prof[0] if prof else None,
            "fleet_launches": fleet_counts[name],
            "pipelined_launches": pipe_counts[name],
            "vo_launches": vo_counts[name],
            "service_launches": service_counts[name],
        })
    keys = ("ms", "device_ms", "bound_ms", "bound_by")
    kernels[0]["textured"] = {
        name: {k: st[k] for k in keys + ("fast_live_share",)}
        for name, st in textured.items()}
    for i, part in ((1, "sparse"), (2, "matcher")):
        kernels[i]["device_ms"] = results["float"][i]["device_ms"]
        kernels[i]["textured"] = {name: {k: st[part][k] for k in keys}
                                  for name, st in textured_fm.items()}
    kernels[2]["crowded"] = {v: {k: st[k] for k in keys}
                             for v, st in crowded.items()}
    for name, source, replaces, st, n, extra in (
            ("match_fused", "src/repro_torch/kernels/csrc/match_fused.cu",
             "src/repro/kernels/matcher_fused.py:239", mo_frame,
             loop_counts["match_fused"],
             {f"{what}_{k}": got[k] for what, got in (("run", mo_run),
                                                     ("stereo", mo_stereo))
              for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
             | {"fleet_launches": fleet_counts["match_fused"],
                "pipelined_launches": pipe_counts["match_fused"],
                "vo_launches": vo_counts["match_fused"]}),
            ("sad_fused", "src/repro_torch/kernels/csrc/sad_fused.cu",
             "src/repro/kernels/matcher_fused.py:275", sad_stats,
             entry_counts["sad_fused"], {}),
            ("hamming_match", "src/repro_torch/kernels/csrc/hamming_match.cu",
             "src/repro/kernels/hamming_match.py:83",
             unfused_stats["hamming_match"], unfused_counts["hamming_match"],
             {}),
            ("sad_search", "src/repro_torch/kernels/csrc/sad_search.cu",
             "src/repro/kernels/sad_rectify.py:37",
             unfused_stats["sad_search"], unfused_counts["sad_search"], {}),
            ("frontend_fused",
             "src/repro_torch/kernels/csrc/frontend_level.cu",
             "src/repro/kernels/frontend_fused.py:235",
             per_level_stats["frontend_fused"],
             per_level_counts["frontend_fused"],
             {f"{k}_levels": per_level_stats["frontend_fused"][f"{k}_levels"]
              for k in ("ms", "device_ms", "plain_ms", "bound_ms")}),
            ("describe_fused",
             "src/repro_torch/kernels/csrc/describe_level.cu",
             "src/repro/kernels/describe_fused.py:178",
             per_level_stats["describe_fused"],
             per_level_counts["describe_fused"],
             {f"{k}_levels": per_level_stats["describe_fused"][f"{k}_levels"]
              for k in ("ms", "device_ms", "plain_ms", "bound_ms")})):
        if n < 1:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None,
            "profiled_device_ms": st["device_ms"],
            "service_launches": service_counts[name], **extra})
    for name, source, replaces in (
            ("fast_score_map", "src/repro_torch/kernels/csrc/fast_detect.cu",
             "src/repro/kernels/fast_detect.py:56"),
            ("gaussian_blur7", "src/repro_torch/kernels/csrc/gaussian_blur.cu",
             "src/repro/kernels/gaussian_blur.py:50"),
            ("orient_fused", "src/repro_torch/kernels/csrc/orient_fused.cu",
             "src/repro/kernels/describe_fused.py:218")):
        st = single_stats[name]
        if single_counts[name] < 1:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": single_counts[name],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st["library_ms"],
            "profiled_device_ms": st["device_ms"],
            "service_launches": service_counts[name]})
    # the uint8 variants, each beside its float kernel on the same values
    by_name = {k["name"]: k for k in kernels}
    for name in [n for n, k in ops.KERNELS.items() if "u8" in k.variants]:
        st = u8_stats[name]
        if u8_counts[name] < 1:
            raise AssertionError(f"{name}'s uint8 variant was not launched "
                                 "on its path")
        kernels.append({
            "name": f"{name}_u8", "route": "cuda",
            "source": by_name[name]["source"],
            "replaces": by_name[name]["replaces"],
            "launches": u8_counts[name], "max_abs_err": st["max_abs_err"],
            "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": None, "profiled_device_ms": st["device_ms"],
            "fleet_launches": fleet_u8_counts[name],
            "pipelined_launches": pipe_u8_counts[name],
            "service_launches": service_u8_counts[name],
            **{k: v for k, v in st.items() if k.startswith("float_")}})
    print(json.dumps({"kernels": kernels,
                      "module_split_ms": module_split,
                      "frame_ms_median": statistics.median(frame_ms),
                      "localized_frame_ms_median": loc["frame_ms"],
                      "localized_stage_ms": loc["stages"],
                      "localized_metrics": loc["metrics"],
                      "localized_host_syncs": loc["host_syncs"],
                      "per_level_vs_whole_frame": schedules,
                      "uint8_vs_f32_frame": u8_latency,
                      "fleet": fleet_stats,
                      "pipelined": pipe_stats,
                      "tab1": vo_stats,
                      "service": service_stats,
                      "failover": failover_stats,
                      "empty_launch": floor}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
