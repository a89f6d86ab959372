"""Synthetic quad-camera scene (numpy-only port of the single-frame,
sequence and fleet parts of ``repro.data.scenes``).

A deterministic 3-D landmark field rendered into the four pinhole views
of the quad rig (two stereo pairs, front and back).  Landmarks render as
small textured squares with a bright center (strong FAST corners); the
background is a smooth gradient plus Gaussian noise, so frames are float
and not integer-valued.  The arithmetic follows the JAX renderer in
float32, so the same config renders the same frames.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from repro_torch.core.types import CameraIntrinsics


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    n_points: int = 400
    height: int = 480
    width: int = 640
    stamp: int = 5               # landmark square size (px)
    depth_range: tuple[float, float] = (2.0, 12.0)
    spread: float = 8.0          # lateral landmark spread (m)
    noise_std: float = 2.0
    baseline: float = 0.12       # stereo baseline (m)
    seed: int = 0


def default_intrinsics(cfg: SceneConfig) -> CameraIntrinsics:
    f = 0.72 * cfg.width
    return CameraIntrinsics(fx=f, fy=f, cx=cfg.width / 2.0,
                            cy=cfg.height / 2.0, baseline=cfg.baseline)


def make_landmarks(cfg: SceneConfig) -> tuple[np.ndarray, np.ndarray]:
    """(N, 3) world points (both hemispheres) + (N, S, S) texture stamps,
    float64."""
    rng = np.random.RandomState(cfg.seed)
    n = cfg.n_points
    x = rng.uniform(-cfg.spread, cfg.spread, n)
    y = rng.uniform(-cfg.spread / 2, cfg.spread / 2, n)
    z = rng.uniform(*cfg.depth_range, n)
    z[n // 2:] *= -1.0            # back hemisphere for the rear pair
    pts = np.stack([x, y, z], axis=1)
    s = cfg.stamp
    base = rng.uniform(90.0, 250.0, n)
    texture = rng.uniform(0.4, 1.0, (n, s, s)) * base[:, None, None]
    texture[:, s // 2, s // 2] = 255.0      # bright center -> strong corner
    return pts, texture


def _background(cfg: SceneConfig, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed + 77)
    yy, xx = np.mgrid[0:cfg.height, 0:cfg.width]
    grad = 40.0 + 30.0 * (xx / cfg.width) + 20.0 * (yy / cfg.height)
    noise = rng.normal(0.0, cfg.noise_std, (cfg.height, cfg.width))
    return np.clip(grad + noise, 0, 255).astype(np.float32)


def render_view(pts_cam: np.ndarray, texture: np.ndarray,
                intr: CameraIntrinsics, cfg: SceneConfig,
                bg: np.ndarray) -> np.ndarray:
    """Project (N, 3) float32 camera-frame points and max-composite the
    (N, S, S) float32 texture stamps onto ``bg``."""
    f32 = np.float32
    z = pts_cam[:, 2]
    vis = z > 0.5
    zs = np.where(vis, z, f32(1.0))
    u = np.round(f32(intr.fx) * pts_cam[:, 0] / zs + f32(intr.cx)).astype(
        np.int32)
    v = np.round(f32(intr.fy) * pts_cam[:, 1] / zs + f32(intr.cy)).astype(
        np.int32)
    r = cfg.stamp // 2
    inb = (vis & (u >= r) & (u < cfg.width - r)
           & (v >= r) & (v < cfg.height - r))
    u = np.where(inb, u, 0)
    v = np.where(inb, v, 0)
    img = bg.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            val = np.where(inb, texture[:, dy + r, dx + r], f32(0.0))
            np.maximum.at(img, (v + dy, u + dx), val)
    return np.clip(img, f32(0.0), f32(255.0))


def camera_poses(rig_r: np.ndarray, rig_t: np.ndarray,
                 intr: CameraIntrinsics):
    """World->camera transforms (R_wc, t_w) of the 4 cameras, float32:
    [front_L, front_R, back_L, back_R]; right cameras sit +baseline
    along the rig x axis; the back pair looks along -z."""
    f32 = np.float32
    flip = np.asarray([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                       [0.0, 0.0, -1.0]], f32)
    poses = []
    for r_pair in (np.eye(3, dtype=f32), flip):
        for side in (0, 1):
            off = np.asarray([side * intr.baseline, 0.0, 0.0], f32)
            r_wc = (rig_r.astype(f32) @ r_pair).astype(f32)
            t_w = (rig_t.astype(f32) + r_wc @ off).astype(f32)
            poses.append((r_wc, t_w))
    return poses


def render_quad(pts_world: np.ndarray, texture: np.ndarray,
                rig_r: np.ndarray, rig_t: np.ndarray,
                intr: CameraIntrinsics, cfg: SceneConfig) -> np.ndarray:
    """(4, H, W) float32 images for the rig at pose (rig_r, rig_t)."""
    pts = np.asarray(pts_world, np.float32)
    tex = np.asarray(texture, np.float32)
    views = []
    for i, (r_wc, t_w) in enumerate(camera_poses(rig_r, rig_t, intr)):
        pts_cam = ((pts - t_w) @ r_wc).astype(np.float32)
        bg = _background(cfg, seed=cfg.seed + i)
        views.append(render_view(pts_cam, tex, intr, cfg, bg))
    return np.stack(views)


def render_frame(cfg: SceneConfig) -> tuple[np.ndarray, CameraIntrinsics]:
    """The first frame of the JAX package's ``render_sequence`` (rig at
    the origin, identity pose): ((4, H, W) float32, intrinsics)."""
    pts, tex = make_landmarks(cfg)
    intr = default_intrinsics(cfg)
    return (render_quad(pts, tex, np.eye(3), np.zeros(3), intr, cfg),
            intr)


class SequenceOutput(typing.NamedTuple):
    """One rendered trajectory with its ground truth: ``poses`` is the
    per-frame rig pose [(R, t)] — R maps rig->world, t is the rig's
    world position, both float32 — the ego-motion the localization
    backend's accuracy gates compare against."""

    frames: np.ndarray                  # (T, 4, H, W) float32
    poses: list                         # T x (R (3, 3), t (3,))
    intrinsics: CameraIntrinsics


def render_sequence(cfg: SceneConfig, n_frames: int,
                    step_t: tuple[float, float, float] = (0.05, 0.0, 0.10),
                    yaw_per_frame: float = 0.01) -> SequenceOutput:
    """Deterministic constant-twist trajectory: each frame the rig
    moves ``step_t`` in its own frame and yaws by ``yaw_per_frame``
    radians.  The pose recursion runs in float32, as the JAX renderer's
    does, so frames and poses equal the JAX package's."""
    f32 = np.float32
    pts, tex = make_landmarks(cfg)
    intr = default_intrinsics(cfg)
    r = np.eye(3, dtype=f32)
    t = np.zeros(3, f32)
    dt = np.asarray(step_t, f32)
    c, s = np.cos(yaw_per_frame), np.sin(yaw_per_frame)
    dr = np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], f32)
    frames, poses = [], []
    for _ in range(n_frames):
        frames.append(render_quad(pts, tex, r, t, intr, cfg))
        poses.append((r, t))
        t = (t + r @ dt).astype(f32)
        r = (r @ dr).astype(f32)
    return SequenceOutput(np.stack(frames), poses, intr)


class FleetSequenceOutput(typing.NamedTuple):
    """Fleet traffic with per-rig ground truth: ``poses[r]`` is rig
    ``r``'s per-frame [(R, t)] trajectory (rigs are phase-offset views
    of one trajectory; the offset is applied here)."""

    frames: np.ndarray                  # (T, n_rigs, 4, H, W) float32
    intrinsics: CameraIntrinsics
    poses: tuple                        # n_rigs x [T x (R, t)]


def render_fleet_sequence(cfg: SceneConfig, n_frames: int, n_rigs: int,
                          step_t: tuple[float, float, float] =
                          (0.05, 0.0, 0.10),
                          yaw_per_frame: float = 0.01
                          ) -> FleetSequenceOutput:
    """Deterministic fleet traffic: (T, n_rigs, 4, H, W) quad frames.
    Every rig drives the same landmark field on the same twist, rig r
    seeing frames r .. r + n_frames - 1 of one rendered sequence, so
    rigs see distinct images while only n_frames + n_rigs - 1 quad
    frames are rendered."""
    if n_rigs < 1:
        raise ValueError(f"n_rigs must be >= 1, got {n_rigs}")
    frames, poses, intr = render_sequence(cfg, n_frames + n_rigs - 1,
                                          step_t=step_t,
                                          yaw_per_frame=yaw_per_frame)
    fleet = np.stack([frames[r:r + n_frames] for r in range(n_rigs)],
                     axis=1)
    rig_poses = tuple(poses[r:r + n_frames] for r in range(n_rigs))
    return FleetSequenceOutput(fleet, intr, rig_poses)
