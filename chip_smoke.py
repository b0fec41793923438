"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-out out/profile.txt   # + op table

Phases:
  1. device   — require CUDA; print the card, torch/CUDA versions and the
                kernel build time (`nvcc` for sm_90a, one process per source).
  2. kernels  — hold K1 (fast_select_levels over the 8 levels of an
                image: every field bitwise equal to the plain composition
                and to the per-level cell-stage launches followed by
                torch's selection, on the 752x480 frame and a 512x512 rig
                frame; each stage timed, and the per-level path beside
                it), K2 (orb_describe, and
                orb_describe_levels over the 8 levels in one launch,
                bitwise equal to the per-level launches) and K3
                (hamming_top2) against their plain PyTorch versions on the
                card, at the shapes of a rendered 752x480 frame; time each
                kernel on the card with torch.profiler (`ms`) and each
                call, kernel and plain, with CUDA events (`call_ms`,
                `plain_ms`).
                Also K7 (stereo_sad: the whole tail of match_stereo in one
                launch, bitwise equal to the plain composition on the
                integer pair, and its sweep alone) and K8 (remap_bilinear)
                at the stereo path's shapes (a raw EuRoC-rig pair
                remapped, 1200 features per image), and K1 and K2 once
                more on that
                remapped, non-integer frame; K5 (pose_opt) on a
                tracking-shaped (1200 observations, mixed stereo, 2 x 8)
                and a relocalization-shaped (1200, mono, 3 x 10) problem,
                K9 (vocab_transform) with a k = 10, depth = 4 vocabulary
                trained on the host from descriptors of rendered frames,
                and K10 (bow_l1) on a 256 x 10^4 keyframe database; K11
                (preintegrate) on a 64-sample frame batch and a 768-sample
                keyframe buffer (512 valid), each fresh and continued (no
                ptxas spill), and
                K12 (pose_inertial: the 15-dim system, H_marg from the
                kernel, no ptxas spill) on a tracking-shaped problem (1200
                observations, 60% stereo) with a noisy 0.05 s edge. K4
                (ba_assemble) is held against its plain version in the
                stereo phase, on the local BA problem that path built, and
                in its per-observation mode, with K14 (schur_pcg: S x, the
                right-hand side and the back-substitution through the pass
                launches, and the whole solve in one cooperative launch,
                against the plain solve within testing.PCG_TOL after 40
                CG iterations and testing.PCG_TOL_FIRST after 0, 1 and 2,
                and bitwise equal at two grid sizes), on a global BA
                problem at the loop
                phase's capacities (512 keyframe slots of 1200 features,
                32,768 landmark slots; 120 keyframes, ~84,000 active
                observations).
  3. main   — render the 752x480 synthetic world on the card and run 80
                frames through `Tracker.track_mono` (1200 features, 8
                levels), check initialization, the share of OK frames, the
                Sim3-aligned ATE and that every kernel of the path (K1-K3,
                K5) launched while every plain version stayed unused; then
                count CUDA kernel launches per frame with torch.profiler
                over 5 more frames.
  4. stereo   — render raw, distorted pairs of a rig with EuRoC's cam0 /
                cam1 calibration on the card and run 80 of them through
                `System(settings, Sensor.STEREO).track_stereo` (752x480,
                1200 features, 8 levels; rectification built by the port,
                K8 every frame, K7 in every match); check initialization
                on frame 0, >= 90% of frames OK, the Sim3 scale within 5%,
                the SE3 ATE under 0.03 x extent, and that K1-K3, K5-K8
                launched while no plain version ran, K7 once per
                match_stereo. Profile 5 more frames for kernels and syncs
                per frame and K5's device time on the path; one
                match_stereo on the path's last pair: kernels, device ms
                and event ms per call. Then
                K4 on the path's last local BA problem: its blocks in both
                tangent modes against the plain assembly, two launches
                bitwise equal, and the whole LM loop against the loop over
                the plain assembly.
  5. rgbd     — 40 frames of TUM RGB-D freiburg1 geometry (640x480, 1000
                features, bf 40) through `System(..., Sensor.RGBD)`, depth
                rendered on the card; the first frame OK, > 85% OK, the
                Sim3 scale within 5%.
  6. reloc    — BoW relocalization through `System(settings,
                Sensor.MONOCULAR, vocabulary_path=...)` with loop closing
                off, at the main path's geometry: the k = 10, depth = 4
                vocabulary saved to a temporary .npz, 60 frames of the path
                mapped, 6 blank frames, then poses 5-20 revisited, where
                neither the reference keyframe nor the newest ones can
                anchor tracking. Check that `_try_relocalize` recovered,
                the relocalized camera centre within 0.15 map units of the
                mapped keyframe nearest that pose (the JAX test's gate),
                the Sim3 ATE of every OK frame under 0.023 x extent, and
                that K1-K3, K5, K9 and K10 launched while no plain version
                ran; time each relocalization attempt and count its host
                syncs.
  7. vi       — stereo-inertial through `System(settings,
                Sensor.IMU_STEREO)` on the stereo phase's EuRoC rig with
                EuRoC's IMU noise densities and random walks at 200 Hz and
                EuRoC's cam0-to-body rotation: 120 raw pairs at 20 Hz on
                the tests' accelerated analytic trajectory, each with the
                IMU samples since the previous frame (camera-centre specific
                force and rate in body axes, zero lever arm, seeded noise).
                Check > 85% of frames OK, the IMU initialized with
                viba_stage >= 2, the Sim3 scale within 0.06 of 1 and the SE3
                ATE under 0.04 x extent, and that K1-K5, K7, K8, K11-K13
                launched while no plain version ran, K13 n + 1 times for
                every n-iteration vi_ba_solve; time frames 60-119,
                each keyframe insert's mapping step (visual until the IMU
                initialization, inertial after) and each IMU-init stage;
                profile 5 more frames, then the plain
                `inertial_only_optimize` on the path's last problem.
  8. loop     — a live stereo loop through `System(settings,
                Sensor.STEREO, vocabulary_path=...)` with loop closing on
                and System's default capacities: the tests' ring world (56
                panels on a 6 m ring) rendered on the card, the EuRoC rig
                orbiting inside it, 346 raw pairs (1.5 circuits at the
                tests' 1.3 circuits per 300 frames), the tests' tracker
                settings, a k = 8, depth = 3 vocabulary trained in-run.
                Check >= 1 loop closed, > 90% of frames OK, the loop gap
                after correction < 0.3 and <= the raw one, the SE3 ATE <
                1.1 x the raw poses', the last GBA job's 4 slices run (K14
                in each) and finished by flush(), and that K1-K5, K7-K10,
                K14 and K4's per-observation mode launched while no plain
                version ran (K15 in the correction's pose graph too); time
                the closing insert's parts and every GBA slice, count host
                syncs per maybe_close; then hold one GBA slice of the path's
                own problem against the slice over the plain versions
                (accepts, costs within 1e-3), check its peak memory stays
                under one dense coupling, and time K14's whole solve on
                that problem (held against the plain solve as above).
  9. merge    — the bench's multi-session merge: mono 384x288, 500
                features, the plane world out (28 frames) and back (27), a
                new map at the turn; the stashed map must weld back and the
                Sim3 ATE stay under 0.08 x extent.
 10. vi_loop  — the JAX stereo-inertial ring-circuit test
                (tests/test_inertial_e2e.py:136) through `System(settings,
                Sensor.IMU_STEREO, vocabulary=...)` at its configuration
                (rectified 384x288, fx 300, baseline 0.1, 500 features, 4
                levels, max_kf 128, max_lm 16000, th_depth 60, IMU at
                200 Hz with noise seed 2, a k = 8, depth = 3 vocabulary
                trained in-run, unpipelined): 300 frames at 1.3 circuits,
                then flush(); > 90% OK, imu_ready, finite velocities and
                biases, every keyframe's pitch / roll < 0.01 rad, circuit
                gap < 0.2; K13 n + 1 times a vi_ba_solve of n iterations
                (fisheye too). Then the inertial loop
                branch on the drifted inertial map (the numpy construction
                below): no loop on the first detection, one on the second,
                the four_dof pose graph through K15 and full_inertial_ba
                through K13, the late keyframes' centre RMSE < 0.4 x its
                value before, tilts < 0.01 rad, poses within 1e-3 of the
                same calls on the CPU with the plain versions, K18 (which
                must launch there) against its plain version on the
                branch's first verification.
 11. fisheye  — bench.py:185 mono_inertial_fisheye_run through
                `System(settings, Sensor.IMU_MONOCULAR)` with a
                KannalaBrandt8 cam1 (384x288, f 170): a 640x480 pinhole
                render of the plane world (seed 3) remapped into the
                fisheye by K8 with the bench's map, 100 frames, IMU seed 4;
                > 75% OK, imu_ready with viba_stage >= 1, a finite
                trajectory, Sim3 ATE < 0.04 x extent; fps over frames
                70-99.
 12. new kernels — K13 (vi_edges: inertial_terms, H, b and the cost at
                one state in one call) on the vi path's last window problem
                and K15 (pose_graph) on the loop path's essential graph (and
                K17, K18 as below) against their plain versions (H
                under Jacobi scaling, b, the cost, within 1e-5; two
                calls bitwise equal), their
                times and bounds, and the whole vi_ba_solve (n + 1 K13
                calls) / the whole pose graph over kernel and plain; then
                bench.py:398's ba_iters_per_s problem through the port's
                ba_solve.
 13. persist  — the JAX lifecycle test (tests/test_system.py:24) at the
                main path's size through `System(settings,
                Sensor.MONOCULAR, vocabulary=...)`: 80 frames, every
                trajectory writer, the TUM file read back and scored by
                eval.ate against a ground truth written by the same writer
                (Sim3 ATE < 0.023 x extent), the map's points, save_atlas;
                fresh Systems load it (load_atlas and settings.load_atlas),
                enter localization mode and relocalize on revisit frames
                without a keyframe insert; then tests/test_atlas.py:134:
                24 frames out, a stashed map, 6 frames, save, reload into a
                fresh System, and the stash merges back on the way back.
 14. euroc_synth — the bench's euroc cell function
                (`run_dataset.evaluate_sequence(root, "mono")`) on 80 raw
                EuRoC-cam0 renders of the main path written as 8-bit PNGs
                in EuRoC's layout (Python's zlib and struct only); the
                port's native loader decodes them; >= 70% OK and the mono
                Sim3 gate.

 15. rig      — the non-rectified KB8 fisheye two-camera rig through
                `Tracker(cam0, cfg, stereo_rig=(cam1, R_rl, t_rl))` (the
                JAX package's rig entry point; System builds no rig) at
                TUM-VI's geometry: 512x512 KannalaBrandt8 cam0 of
                ORB-SLAM3's TUM-VI.yaml and, as cam1, that cam0 perturbed
                slightly (not a published calibration), 0.10 m to the
                right, rotated 1 degree; the plane world at half size rendered as a wide
                pinhole view and remapped by K8 into each fisheye; 1200
                features, 8 levels. Run (a): 80 pairs through track_stereo,
                initialized on pair 0, >= 90% OK, the Sim3 scale within 5%,
                the SE3 ATE under 0.03 x extent. Run (b): 120 pairs at
                20 Hz through track_stereo_inertial with the fisheye
                phase's IMU noise: > 85% OK, viba_stage >= 2, |s - 1| <
                0.06, SE3 ATE under 0.04 x extent. Both check that K1-K6
                and K16 launched (and K11-K13 and K17 in run (b))
                with no plain version run, print fps, frame times, kernels
                and syncs per frame and each IMU-init stage's
                inertial_only_optimize time.

K6 (pyramid_blur) is held against its plain pyramid and blur in the
kernels phase, on the main path's first image, and through extract_orb.
K16 (stereo_general) is held against its plain version in the kernels
phase on the rig path's first pair; K17 (inertial_init) on the vi path's
first IMU-init problem and K18 (sim3_verify) on the loop path's first
verified candidate in the new-kernels phase (and on the vi_loop branch's
first verification in that phase), where the loop phase also
checks that K18 ran the guided verification (and the merge phase that no
plain version ran). `--only rig` runs the device phase and the rig.
`--only vi_loop,fisheye` (any phase names; `persist,euroc_synth` for the
persistence slice) runs the device phase and those phases alone, without
the kernels line. `--loop-variants` runs the loop path at the System's own
tracker settings pipelined and not and at the loop test's pipelined;
`--pcg-ab N` runs it 2 N times at the System's own settings pipelined, its
global BA over K14's solve and over the plain solve in turn; both print
the gates each run meets and enforce none.

Any failure raises (nonzero exit). The line before the last is the card's
`nvidia-smi` name and power limit; the last line is the JSON result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

W, H, FX = 752, 480, 460.0
N_FRAMES = 80
N_RGBD = 40
# relocalization: frames mapped, blank frames, path poses revisited
N_MAP, N_BLANK, REVISIT = 60, 6, range(5, 21)
VOC_K, VOC_DEPTH, VOC_ITERS = 10, 4, 3
# EuRoC MAV cam0 / cam1 (fx, fy, cx, cy, radtan k1 k2 p1 p2) and cam1's pose
# in cam0 (X_c0 = R X_c1 + t: 0.110 m baseline, ~0.8 deg about x), as in
# ORB-SLAM3's EuRoC.yaml
CAM0 = (458.654, 457.296, 367.215, 248.375,
        (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05))
CAM1 = (457.587, 456.134, 379.999, 255.238,
        (-0.28368365, 0.07451284, -0.00010473, -3.5559e-05))
T_C0_C1 = np.array([
    [0.999997256477797, -0.002317135723275, -0.000343393120620,
     0.110074137800478],
    [0.002312067192432, 0.999898048507103, 0.014090668452683,
     -0.000156612054392],
    [-0.000376008102320, -0.014089835846691, 0.999900662638081,
     0.000889382785432],
    [0.0, 0.0, 0.0, 1.0]])
# TUM RGB-D freiburg1 (640x480, no distortion, bf = baseline * fx = 40)
TUM_W, TUM_H, TUM_K, TUM_BF = 640, 480, (517.3, 516.5, 318.6, 255.3), 40.0
DEV = "cuda"
# visual-inertial phase: frames at 20 Hz (timed from VI_TIMED on), EuRoC's
# IMU (noise densities, random walks, rate) and its cam0-to-body rotation
# (T_BS of cam0 in EuRoC's sensor.yaml: ~90 deg about the optical axis)
N_VI, VI_DT, VI_TIMED = 120, 0.05, 60
IMU_NOISE = dict(noise_gyro=1.7e-4, noise_acc=2.0e-3, walk_gyro=1.9e-5,
                 walk_acc=3.0e-3, frequency=200.0)
R_B_C0 = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422],
    [0.999557249008, 0.0149672133247, 0.025715529948],
    [-0.0257744366974, 0.00375618835797, 0.999660727178]])
# the port's profiler ranges (K13 and inertial_only_optimize, K4's LM
# loop, the kernel wrappers, the tracker's stage timers); the profiler also
# lists each as a device-side annotation spanning its kernels and the idle
# time between them, which per-frame device sums must skip
RANGES = ("K4 ba_solve", "K4 ba_assemble", "K5 optimize_pose",
          "K6 build_pyramid", "K6 blur_levels", "K6 pyramid_blur",
          "lm_obs_count", "K9 vocab_transform",
          "K10 bow_l1", "K11 preintegrate", "K12 optimize_pose_inertial",
          "K13 vi_ba edges", "K13 inertial_terms",
          "K15 normal_equations", "inertial_only_optimize",
          "K14 schur_lm_pass", "K14 schur_kf_pass", "K14 schur_pcg",
          "ba_solve_pcg", "GBA slice", "GBATotal",
          "LoopTotal", "maybe_close", "maybe_merge", "correct_loop",
          "pose_graph.optimize", "guided_sim3_verify", "search_and_fuse",
          "TrackTotal", "LMTotal")
# NVIDIA's H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12             # float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12           # int8 tensor cores, dense


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    """Fail the run (an AssertionError, kept under python -O)."""
    if not ok:
        raise AssertionError(what)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# synthetic world (harness, not path code): the tests' PlaneWorld and
# camera_path, rendered on the card with grid_sample instead of OpenCV
# ---------------------------------------------------------------------------

def _blur1(t):
    x = torch.arange(-3, 4, dtype=torch.float32, device=t.device)
    k = torch.exp(-0.5 * x * x)
    k = k / k.sum()
    p = F.pad(t[None, None], (3, 3, 3, 3), mode="reflect")
    p = F.conv2d(p, k.view(1, 1, 1, 7))
    return F.conv2d(p, k.view(1, 1, 7, 1))[0, 0]


def texture(size, seed, device):
    """Fractal (1/f amplitude) noise in [0, 255]."""
    rng = np.random.default_rng(seed)
    t = torch.zeros((size, size), dtype=torch.float32, device=device)
    base, amp = 8, 1.0
    while base <= size // 2:
        layer = torch.from_numpy(
            rng.standard_normal((base, base)).astype(np.float32)).to(device)
        t += amp * F.interpolate(layer[None, None], size=(size, size),
                                 mode="bicubic", align_corners=False)[0, 0]
        base *= 2
        amp *= 0.55
    t = _blur1(t)
    return (t - t.min()) / (t.max() - t.min()) * 255.0


class PlaneWorld:
    """Back wall, 10 mid panels and 8 near posts (painter's order), as in
    the tests' synthetic world, seeded the same way."""

    def __init__(self, K, width, height, device, seed=0):
        self.K = np.asarray(K, np.float64)
        self.w, self.h, self.device = width, height, device
        rng = np.random.default_rng(seed)
        self.planes = []
        self._add((-8, -5, 8), (24, 10), texture(3072, seed, device))
        for k in range(10):
            ox = -3.5 + 1.3 * k + rng.uniform(-0.3, 0.3)
            oy = rng.uniform(-2.2, 0.4)
            z = rng.uniform(4.5, 5.8)
            self._add((ox, oy, z), (2.2, 1.8), texture(512, seed + k + 1,
                                                        device))
        for k in range(8):
            ox = -2.0 + 1.0 * k + rng.uniform(-0.2, 0.2)
            oy = rng.uniform(-1.3, 0.4)
            z = rng.uniform(3.2, 3.9)
            self._add((ox, oy, z), (1.1, 0.9), texture(256, seed + 20 + k,
                                                        device))
        self.pix = pixel_grid(width, height, device)

    cull = False       # skip planes whose centre is behind the camera

    def _add(self, origin, extent, tex, ex=(1.0, 0, 0), ey=(0, 1.0, 0)):
        self.planes.append(dict(origin=np.asarray(origin, np.float64),
                                extent=extent, tex=tex,
                                ex=np.asarray(ex, np.float64),
                                ey=np.asarray(ey, np.float64)))

    def render(self, R_cw, t_cw):
        return self.render_points(R_cw, t_cw, self.pix, self.K,
                                  (self.h, self.w))[0]

    def render_points(self, R_cw, t_cw, pts, K, shape):
        """(image, depth) seen along homogeneous pixel coordinates pts
        (N, 3) of a camera with matrix K; pts may be undistorted rays with
        K = I. Depth is the camera-frame z (0 where no plane is hit)."""
        R = np.asarray(R_cw, np.float64)
        t = np.asarray(t_cw, np.float64)
        img = torch.zeros(pts.shape[0], dtype=torch.float32,
                          device=self.device)
        depth = torch.zeros_like(img)
        for p in self.planes:
            th, tw = p["tex"].shape
            if self.cull:
                centre = p["origin"] + 0.5 * p["extent"][0] * p["ex"] + \
                    0.5 * p["extent"][1] * p["ey"]
                if (R @ centre + t)[2] < 0.5:
                    continue
            a = R @ (p["ex"] * p["extent"][0] / tw)
            b = R @ (p["ey"] * p["extent"][1] / th)
            c = R @ p["origin"] + t
            Hinv = np.linalg.inv(K @ np.stack([a, b, c], axis=1))
            src = pts @ torch.from_numpy(Hinv.T).to(self.device)
            front = src[:, 2] > 0
            tx = src[:, 0] / src[:, 2]
            ty = src[:, 1] / src[:, 2]
            ok = front & (tx >= 0) & (tx <= tw - 1) & (ty >= 0) & (ty <= th - 1)
            grid = torch.stack([tx / (tw - 1) * 2 - 1, ty / (th - 1) * 2 - 1],
                               -1).to(torch.float32)
            val = F.grid_sample(p["tex"][None, None], grid.view(1, 1, -1, 2),
                                mode="bilinear", align_corners=True)[0, 0, 0]
            img = torch.where(ok, val, img)
            # K maps camera points to pixels with last row (0, 0, 1), so
            # the homography's third coordinate is 1 / z
            depth = torch.where(ok, (1.0 / src[:, 2]).to(torch.float32), depth)
        return img.view(*shape), depth.view(*shape)


class RingWorld(PlaneWorld):
    """The tests' ring world: 56 textured panels on a 6 m ring, their
    faces towards the centre, rendered with the behind-camera cull."""

    cull = True

    def __init__(self, K, width, height, device, n_panels=56, r_panel=6.0,
                 seed=0):
        self.K = np.asarray(K, np.float64)
        self.w, self.h, self.device = width, height, device
        rng = np.random.default_rng(seed)
        self.planes = []
        up = np.array([0.0, 1.0, 0.0])
        for k in range(n_panels):
            phi = 2 * np.pi * k / n_panels
            tangent = np.array([np.cos(phi), 0.0, -np.sin(phi)])
            ex_w, ey_h = 1.7, 1.6
            origin = (r_panel * np.array([np.sin(phi), 0.0, np.cos(phi)])
                      - 0.5 * ex_w * tangent - 0.5 * ey_h * up
                      + np.array([0.0, rng.uniform(-0.25, 0.25), 0.0]))
            self._add(origin, (ex_w, ey_h),
                      texture(384, seed + 7 * k + 1, device), ex=tangent,
                      ey=up)
        self.pix = pixel_grid(width, height, device)


def ring_path(n_frames, circuits=1.15, r_cam=2.5):
    """The tests' orbit inside the ring, looking radially outward."""
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * circuits * i / n_frames
        sn, cs = np.sin(th), np.cos(th)
        R_cw = np.array([[cs, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, cs]]).T
        poses.append((R_cw.astype(np.float32),
                      (-R_cw @ (r_cam * np.array([sn, 0.0, cs])))
                      .astype(np.float32)))
    return poses


def pixel_grid(width, height, device):
    """Homogeneous (u, v, 1) of every pixel, row-major, float64."""
    v, u = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    return torch.stack([u, v, torch.ones_like(u)], -1).to(
        torch.float64).reshape(-1, 3)


def raw_rays(cam, width, height, device, n_iter=60):
    """Undistorted rays (x, y, 1) of every raw pixel of a radtan camera
    (fx, fy, cx, cy, (k1, k2, p1, p2)): the inverse of the port's
    `cameras.distort`, by fixed-point steps in float64. Returns (rays,
    largest residual in normalized units)."""
    fx, fy, cx, cy, (k1, k2, p1, p2) = cam
    pix = pixel_grid(width, height, device)
    dx, dy = (pix[:, 0] - cx) / fx, (pix[:, 1] - cy) / fy

    def distort(x, y):
        r2 = x * x + y * y
        rad = 1.0 + r2 * (k1 + r2 * k2)
        return (x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)
    x, y = dx, dy
    for _ in range(n_iter):
        ex, ey = distort(x, y)
        x, y = dx - (ex - x), dy - (ey - y)
    ex, ey = distort(x, y)
    res = float(torch.maximum((ex - dx).abs(), (ey - dy).abs()).max())
    return torch.stack([x, y, torch.ones_like(x)], -1), res


def camera_path(n_frames, step=0.05):
    from morb_slam_tpu_torch import lie
    poses = []
    for i in range(n_frames):
        yaw = 0.1 * np.sin(i * 0.08)
        pitch = 0.02 * np.sin(i * 0.13)
        center = np.array([step * i, 0.02 * np.sin(i * 0.2), 0.0])
        R_wc = lie.so3_exp(torch.tensor([pitch, yaw, 0.0],
                                        dtype=torch.float32)).numpy()
        R_cw = R_wc.T.astype(np.float64)
        poses.append((R_cw.astype(np.float32),
                      (-R_cw @ center).astype(np.float32)))
    return poses


GRAVITY_W = np.array([0.0, 0.0, -9.81])


def analytic_pose(t, speed=1.0):
    """The tests' continuous camera path (t in seconds, frame i = t / 0.05)
    with ~1 m/s^2 accelerations. Returns (R_cw, t_cw) in float64 (the IMU
    samples differentiate it); world gravity is -z."""
    from scipy.spatial.transform import Rotation
    i = t / 0.05
    yaw = 0.1 * np.sin(i * 0.08)
    pitch = 0.02 * np.sin(i * 0.13)
    center = np.array([speed * t + 0.35 * np.sin(2.0 * t),
                       0.15 * np.sin(1.9 * t),
                       0.08 * np.sin(2.4 * t)])
    R_cw = Rotation.from_rotvec([pitch, yaw, 0.0]).as_matrix().T
    return R_cw, -R_cw @ center


def imu_between(t0, t1, freq=200.0, rng=None, noise_g=0.0, noise_a=0.0,
                pose_fn=None):
    """The tests' IMU samples in (t0, t1]: camera-frame angular rate and
    specific force of the analytic path (or `pose_fn`'s) by finite
    differences (float64), plus seeded Gaussian noise. Returns
    (timestamps, acc, gyro)."""
    from scipy.spatial.transform import Rotation
    pose_fn = pose_fn or analytic_pose
    h = 2e-3
    ts = np.arange(np.floor(t0 * freq) + 1, np.floor(t1 * freq) + 1) / freq

    def center(tt):
        Rc, tc = pose_fn(tt)
        return -Rc.T @ tc
    acc, gyr = [], []
    for t in ts:
        R_wb = pose_fn(t)[0].T
        W_ = R_wb.T @ pose_fn(t + h)[0].T
        gyr.append(Rotation.from_matrix(W_).as_rotvec() / h)
        a_w = (center(t + h) - 2 * center(t) + center(t - h)) / h ** 2
        acc.append(R_wb.T @ (a_w - GRAVITY_W))
    acc = np.asarray(acc, np.float32).reshape(-1, 3)
    gyr = np.asarray(gyr, np.float32).reshape(-1, 3)
    if rng is not None:
        acc = acc + rng.normal(0, noise_a, acc.shape).astype(np.float32)
        gyr = gyr + rng.normal(0, noise_g, gyr.shape).astype(np.float32)
    return ts, acc, gyr


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps=25, inner=10, warmup=3):
    """Milliseconds per fn() by CUDA events: one event pair around `inner`
    back-to-back calls, the median over `reps` such runs. Where the host
    issues the calls slower than the card runs them, this is the host's
    rate; `device_ms` gives the kernel alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return float(np.median(times))


PROFILE_PAD_S = 0.1
# kernels whose `ms` came from CUDA events because the profiler saw none
EVENT_TIMED = set()


@contextlib.contextmanager
def profiled(cpu=False):
    """torch.profiler (CUPTI) over the enclosed work, the card synchronized
    and idle for PROFILE_PAD_S at both ends. The profiler keeps only the
    device activity that its clock places inside the traced window; the idle
    margins keep a short run's kernels inside it (an H100 run once reported
    none of a 20-call run's kernels)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def device_ms(fn, kernel_name, reps=20, tries=3):
    """Device milliseconds per fn() spent in kernels whose name contains
    kernel_name (every kernel fn launches for None), from torch.profiler
    (CUPTI): the kernels alone, without the host's dispatch gaps that the
    event timing includes. Where `tries` profiles see none of them, the
    CUDA-event time per call instead, and the name goes into EVENT_TIMED."""
    fn()
    torch.cuda.synchronize()

    def counted(ev):
        if kernel_name:
            return kernel_name in ev.key
        return ev.device_type == torch.autograd.DeviceType.CUDA and \
            ev.key not in RANGES
    for _ in range(tries):
        with profiled() as prof:
            for _ in range(reps):
                fn()
        us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if counted(ev))
        if us > 0:
            return us / reps / 1e3
    log(f"profiler saw no {kernel_name or 'kernel'} in {tries} runs: timed "
        f"by CUDA events instead")
    EVENT_TIMED.add(kernel_name)
    return time_ms(fn, reps=reps, inner=1)


def span_ms(fn, first, last, reps=20, tries=3):
    """Device milliseconds per fn() from the start of its kernel named
    `first` to the end of its kernel named `last` (the profiler's
    timestamps; each `last` kernel paired with the latest `first` kernel
    that started before it, the median over `reps` calls): the time of a
    call whose kernels overlap or wait on each other, where the sum of
    their device times would count the overlap twice. None where `tries`
    profiles show fewer than half the pairs."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profiled() as prof:
            for _ in range(reps):
                fn()
        spans = kernel_spans(prof, first, last)
        if len(spans) >= reps // 2:
            return float(np.median(spans))
    log(f"profiler did not show {first} .. {last} in {tries} runs")
    return None


def kernel_spans(prof, first, last):
    """Device milliseconds, for each kernel named `last` in the profile,
    from the start of the latest kernel named `first` that started before
    it to the end of that `last` kernel."""
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    a = sorted(e.time_range.start for e in ev if first in e.name)
    spans = []
    for e in ev:
        if last not in e.name:
            continue
        i = int(np.searchsorted(a, e.time_range.start, side="right"))
        if i:
            spans.append((e.time_range.end - a[i - 1]) / 1e3)
    return spans


def kernels_per_call(fn, reps=5, tries=3):
    """CUDA kernels one fn() launches, by the profiler's count over `reps`
    calls (profiled again, up to `tries` times, while it sees none)."""
    fn()
    n = 0
    for _ in range(tries):
        with profiled() as prof:
            for _ in range(reps):
                fn()
        n = sum(ev.count for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.key not in RANGES)
        if n:
            break
    return round(n / reps)


def bound(nbytes, nops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(state):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from morb_slam_tpu_torch.ops import cuda_build
    log("card:", nvidia_smi())
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    secs = cuda_build.build()
    log(f"kernel build: {secs:.2f} s (nvcc, sm_90a, "
        f"{len(cuda_build.SOURCES)} sources in parallel)")
    for name in cuda_build.SOURCES:
        log(f"  {name}: " + cuda_build.ptxas_report(name).strip().replace(
            "\n", " | "))
    state["build_s"] = secs


def _world(state):
    if "world" not in state:
        K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
        t0 = time.perf_counter()
        state["world"] = PlaneWorld(K, W, H, DEV)
        state["poses"] = camera_path(N_FRAMES + 5)
        torch.cuda.synchronize()
        log(f"world built on the card in {time.perf_counter() - t0:.1f} s")
    return state["world"], state["poses"]


def _k2_pixels_read(shape, yx, angle):
    """Distinct pixels K2 must read for these keypoints: the orientation
    disc on the raw level plus the rotated pattern's samples on the blurred
    one, reflected at the edge as the padding does."""
    from morb_slam_tpu_torch.ops import orb_descriptor as od
    h, w = shape

    def distinct(y, x):
        y = torch.where(y < 0, -y, torch.where(y >= h, 2 * (h - 1) - y, y))
        x = torch.where(x < 0, -x, torch.where(x >= w, 2 * (w - 1) - x, x))
        return torch.unique(y * w + x).numel()

    y0, x0 = yx[:, :1].long(), yx[:, 1:].long()
    dv, du = (torch.from_numpy(d - od.PATCH_R).to(yx.device)
              for d in np.nonzero(od.ORI_MASK))
    pat = torch.from_numpy(od.PATTERN).to(yx.device, torch.float32)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    px = torch.cat([pat[:, 0], pat[:, 2]])[None]
    py = torch.cat([pat[:, 1], pat[:, 3]])[None]
    ys = y0 + torch.round(px * sa + py * ca).long()
    xs = x0 + torch.round(px * ca - py * sa).long()
    return distinct(y0 + dv, x0 + du) + distinct(ys, xs)


def _k1_compass_pass(levels, th):
    """Pixels of the levels that pass FAST's compass test (two of the four
    circle points at distance 3 beyond th on one side, wrapping at the
    edge): those whose FAST score K1 must compute."""
    n = 0
    for lvl in levels:
        d = torch.stack([torch.roll(lvl, s, dims=a) for s, a in
                         ((3, 0), (-3, 0), (3, 1), (-3, 1))]) - lvl
        n += int((((d > th).sum(0) >= 2) | ((d < -th).sum(0) >= 2)).sum())
    return n


def phase_kernels(state):
    from morb_slam_tpu_torch import frontend
    from morb_slam_tpu_torch.ops import fast, hamming, image, orb_descriptor
    world, poses = _world(state)
    cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
    counts = cfg.per_level_counts()
    frames = [world.render(*poses[i]).clamp(0, 255).to(torch.uint8).float()
              for i in (0, 2, 4, 6, 8)]
    levels = image.build_pyramid(frames[0], cfg.n_levels, cfg.scale)
    rows = []

    # K1 over every level in one call: the seven fields bitwise equal to
    # the plain composition and to the 8 per-level cell-stage launches
    # followed by torch's selection, on this frame's 8 levels and on a
    # 512x512 rig frame's
    rig_frame = _rig_raw_pair(state, *camera_path(1)[0])[0].float()
    for name, img in (("752x480", frames[0]), ("512x512 rig", rig_frame)):
        lv = image.build_pyramid(img, cfg.n_levels, cfg.scale)
        n0 = fast.LAUNCHES["kernel"]
        got = fast.fast_select_levels(lv, counts, cfg)
        n1 = fast.LAUNCHES["kernel"]
        plain = fast.fast_select_levels_plain(lv, counts, cfg)
        per = fast.select_levels(lv, counts, cfg, cells=fast.fast_select)
        check(got.kept == plain.kept == per.kept,
              ("K1 fast_select_levels slots a level", name, got.kept,
               plain.kept, per.kept))
        for f, x, y, z in zip(fast.SLOT_FIELDS, got, plain, per):
            check(torch.equal(x, y) and torch.equal(x, z),
                  f"K1 fast_select_levels {name}: {f} differs from the "
                  f"plain composition ({int((x != y).sum())} entries) or "
                  f"the per-level launches ({int((x != z).sum())})")
        check(n1 - n0 == 1, ("K1 launches counted per call", n1 - n0))
        log(f"K1 fast_select_levels {name}: {got.yx.shape[0]} slots "
            f"({int(got.valid.sum())} valid), all 7 fields bitwise equal to "
            f"the plain composition and to the 8 per-level launches + "
            f"torch selection")

    def k1_call():
        fast.fast_select_levels(levels, counts, cfg)

    def per_level():
        fast.select_levels(levels, counts, cfg, cells=fast.fast_select)
    ms = time_ms(k1_call)
    plain = time_ms(lambda: fast.fast_select_levels_plain(levels, counts,
                                                          cfg), reps=10)
    cell_ms = device_ms(k1_call, "fast_cells_kernel")
    level_ms = device_ms(k1_call, "fast_level_kernel")
    npix = sum(l.numel() for l in levels)
    slots = [2 * (-(-l.shape[0] // 16)) * (-(-l.shape[1] // 16))
             for l in levels]
    kept = fast.fast_select_levels(levels, counts, cfg).kept
    n_scored = _k1_compass_pass(levels, cfg.th_fast_lo)
    # each level read once, 33 bytes out per kept slot; every pixel 4
    # compass differences + 8 compares, 8 NMS maxes and ~4 for the key;
    # a pixel that passes the compass test 12 more differences, 2 x 57 for
    # the runs of 9 and their reduction (van Herk) and 2 for the score;
    # each level a pass over its cell slots and an order of its kept ones
    b_ms, b_by = bound(npix * 4 + sum(kept) * 33,
                       npix * 24 + n_scored * 128
                       + sum(n + k * math.log2(max(k, 2))
                             for n, k in zip(slots, kept)))
    rows.append(dict(name="fast_select", route="cuda",
                     source="morb_slam_tpu_torch/csrc/fast_select.cu",
                     replaces="morb_slam_tpu/ops/fast.py:41",
                     max_abs_err=0.0, ms=cell_ms + level_ms,
                     ms_is="fast_select_levels: the cell stage and the level "
                     "stage of one image (2 kernels, counted as 1 launch)",
                     ms_cell_stage=cell_ms, ms_level_stage=level_ms,
                     call_ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None,
                     kernels_per_image=kernels_per_call(k1_call),
                     ms_8_cell_stage_calls=device_ms(
                         lambda: [fast.fast_select(l, 7.0, 20.0)
                                  for l in levels], "fast_cells_kernel"),
                     per_level_path=dict(
                         device_ms=device_ms(per_level, None),
                         call_ms=time_ms(per_level),
                         kernels=kernels_per_call(per_level)),
                     ptxas=_ptxas("fast_select"),
                     pixels=npix, pixels_scored=n_scored,
                     shape="8 levels of 752x480 (one image), 1200 kept"))

    # K2 at each level's n_keep: angles within 1e-4 rad, >= 99.9% bits;
    # one launch over all levels bitwise equal to the per-level launches
    args = []
    max_ang, bit_diff, bit_tot, px_read = 0.0, 0, 0, 0
    blurred = image.blur_levels(levels)
    kp = fast.fast_select_levels(levels, counts, cfg)
    for lvl, blur, yx in zip(levels, blurred, kp.level_yx()):
        args.append((lvl, blur, yx))
        a1, d1 = orb_descriptor.orb_describe(lvl, blur, yx.contiguous())
        a0 = orb_descriptor.compute_orientations(lvl, yx)
        d0 = orb_descriptor.compute_descriptors(blur, yx, a0)
        px_read += _k2_pixels_read(lvl.shape, yx, a0)
        dang = torch.remainder(a1 - a0 + math.pi, 2 * math.pi) - math.pi
        max_ang = max(max_ang, dang.abs().max().item())
        bits = orb_descriptor.unpack_bits(d1) != orb_descriptor.unpack_bits(d0)
        bit_diff += int(bits.sum())
        bit_tot += bits.numel()
    share = 1.0 - bit_diff / bit_tot
    log(f"K2 orb_describe: max angle diff {max_ang:.2e} rad, descriptor "
        f"bits identical {share:.5f} ({bit_diff} of {bit_tot} differ)")
    check(max_ang < 1e-4 and share >= 0.999, (max_ang, share))
    yxs = [a[2] for a in args]
    n0 = orb_descriptor.LAUNCHES["kernel"]
    a_lv, d_lv = orb_descriptor.orb_describe_levels(levels, blurred, yxs)
    lv_launches = orb_descriptor.LAUNCHES["kernel"] - n0
    per = [orb_descriptor.orb_describe(*a) for a in args]
    lv_bitwise = torch.equal(a_lv, torch.cat([p[0] for p in per])) and \
        torch.equal(d_lv, torch.cat([p[1] for p in per]))
    log(f"K2 orb_describe_levels: {lv_launches} launch for {len(levels)} "
        f"levels, bitwise equal to the per-level launches {lv_bitwise}")
    check(lv_launches == 1 and lv_bitwise, ("K2 levels", lv_bitwise))

    def levels_call():
        orb_descriptor.orb_describe_levels(levels, blurred, yxs)

    def eight_calls():
        for a in args:
            orb_descriptor.orb_describe(*a)
    ms = time_ms(levels_call)
    ms_8 = time_ms(eight_calls)

    def plain_k2():
        for lvl, blur, yx in args:
            ang = orb_descriptor.compute_orientations(lvl, yx)
            orb_descriptor.compute_descriptors(blur, yx, ang)
    plain = time_ms(plain_k2, reps=10)
    kernel = device_ms(levels_call, "orb_describe_levels_kernel")
    kernel_8 = device_ms(eight_calls, "orb_describe_kernel")
    nkp = sum(counts)
    # the distinct level pixels this frame's keypoints read, their yx and
    # the pattern in, 36 bytes out per keypoint; 4 flop per disc pixel +
    # ~10 per pair test
    b_ms, b_by = bound(px_read * 4 + nkp * (8 + 36) + 256 * 16,
                       nkp * (709 * 4 + 2560))
    rows.append(dict(name="orb_describe", route="cuda",
                     source="morb_slam_tpu_torch/csrc/orb_describe.cu",
                     replaces="morb_slam_tpu/ops/orb_descriptor.py:64",
                     max_abs_err=max_ang, ms=kernel, call_ms=ms,
                     ms_is="orb_describe_levels: one launch for the 8 levels",
                     ms_8_calls=kernel_8, call_ms_8_calls=ms_8,
                     levels_bitwise_equal_8_calls=lv_bitwise,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, bits_identical=share,
                     ptxas=_ptxas("orb_describe"),
                     shape="1200 keypoints over 8 levels (one image)"))

    # K3 at 1200x1200 and 4096x1200, real descriptors + window masks and
    # random ones: best, index and second exact
    feats = [frontend.extract_orb(f, cfg) for f in frames]
    cases = {}
    f0 = feats[0]
    gate = ((f0.uv[:, None, :] - feats[1].uv[None, :, :]).abs().amax(-1)
            <= 100.0) & f0.valid[:, None] & feats[1].valid[None, :]
    cases["real 1200x1200"] = (f0.desc, feats[1].desc, gate)
    big_desc = torch.cat([f.desc for f in feats[1:]])[:4096]
    big_uv = torch.cat([f.uv for f in feats[1:]])[:4096]
    big_ok = torch.cat([f.valid for f in feats[1:]])[:4096]
    gate = ((big_uv[:, None, :] - f0.uv[None, :, :]).abs().amax(-1) <= 8.0) \
        & big_ok[:, None] & f0.valid[None, :]
    cases["real 4096x1200"] = (big_desc.contiguous(), f0.desc, gate)
    g = torch.Generator(device="cuda").manual_seed(0)
    for n in (1200, 4096):
        ra = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=g,
                           device="cuda", dtype=torch.int64).to(torch.int32)
        rb = torch.randint(-2 ** 31, 2 ** 31 - 1, (1200, 8), generator=g,
                           device="cuda", dtype=torch.int64).to(torch.int32)
        rm = torch.rand((n, 1200), generator=g, device="cuda") < 0.3
        cases[f"random {n}x1200"] = (ra, rb, rm)
    for name, (a, b, m) in cases.items():
        r1 = hamming.hamming_top2(a, b, m)
        r0 = hamming.hamming_top2_plain(a, b, m)
        for x, y in zip(r1, r0):
            if not torch.equal(x, y):
                raise AssertionError(f"K3 mismatch on {name}: "
                                     f"{int((x != y).sum())} rows differ")
        log(f"K3 hamming_top2 {name}: best, index, second exact "
            f"({int(m.sum())} candidate pairs)")
    a, b, m = cases["real 4096x1200"]
    masked = dict(ms=device_ms(lambda: hamming.hamming_top2(a, b, m),
                               "hamming_top2_kernel"),
                  call_ms=time_ms(lambda: hamming.hamming_top2(a, b, m)),
                  ms_1200x1200=device_ms(
                      lambda: hamming.hamming_top2(*cases["real 1200x1200"]),
                      "hamming_top2_kernel"),
                  shape="4096x1200 real mask (match_nn's mode)")
    gated = {}
    for mode, args, max_d in k3_gate_inputs(feats, cfg):
        gated[mode] = _k3_gated_numbers(args, mode, max_d, time_plain=(
            mode == "window"))
    g = gated["window"]
    rows.append(dict(name="hamming_top2", route="cuda",
                     source="morb_slam_tpu_torch/csrc/hamming_top2.cu",
                     replaces="morb_slam_tpu/ops/hamming.py:53",
                     max_abs_err=0.0, ms=g["ms"], call_ms=g["call_ms"],
                     plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
                     bound_by=g["bound_by"], library_ms=None,
                     ms_is="the gated mode (window), one launch at "
                           "4096x1200 on frame features; the stereo phase "
                           "replaces it with its own search's inputs",
                     before_ms=g["before_ms"],
                     before_call_ms=g["before_call_ms"],
                     before_is="the dense gate composition + the masked "
                               "K3, the same function before this design",
                     gated=gated, masked_mode=masked,
                     ptxas=_ptxas("hamming_top2"),
                     shape="4096x1200 (one launch)"))
    rows.append(_k19_row(big_desc.contiguous(), f0.desc))
    rows.append(_k6_row(frames[0], cfg))
    _stereo_kernels(state, rows)
    _reloc_kernels(state, rows)
    _vi_kernels(rows)
    _gba_kernels(rows)
    rows.append(_k16_row(state))
    state["kernel_rows"] = rows
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms on the card, "
            f"{r['call_ms']:.4f} ms per call by events (plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']})")


def _k19_row(a, b):
    """K19 (hamming_matrix_mxu) on the main path's frame descriptors at
    4096x1200 and on random ones at a ragged 1000x777: bitwise equal to its
    plain version and to K3's hamming_matrix. ms by the profiler, call_ms
    and plain_ms by CUDA events, library_ms torch._int_mm on the +-1 int8
    matrices, their unpacking included."""
    from morb_slam_tpu_torch.ops import hamming
    from morb_slam_tpu_torch.ops.orb_descriptor import unpack_bits
    g = torch.Generator(device=DEV).manual_seed(19)
    ra, rb = (torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=g,
                            device=DEV, dtype=torch.int64).to(torch.int32)
              for n in (1000, 777))
    for name, (x, y) in (("4096x1200 frame descriptors", (a, b)),
                         ("1000x777 random", (ra, rb))):
        n0 = hamming.MXU_LAUNCHES["kernel"]
        got = hamming.hamming_matrix_mxu(x, y)
        check(hamming.MXU_LAUNCHES["kernel"] == n0 + 1,
              ("K19 launches counted per call", name))
        plain = hamming.hamming_matrix_mxu_plain(x, y)
        ref = hamming.hamming_matrix(x, y)
        check(torch.equal(got, plain) and torch.equal(got, ref),
              (f"K19 hamming_matrix_mxu {name}: differs from its plain "
               f"version ({int((got != plain).sum())} entries) or "
               f"hamming_matrix ({int((got != ref).sum())})"))
        log(f"K19 hamming_matrix_mxu {name}: bitwise equal to its plain "
            f"version and to hamming_matrix")

    def call():
        return hamming.hamming_matrix_mxu(a, b)

    def library():
        sa = unpack_bits(a).to(torch.int8) * 2 - 1
        sb = unpack_bits(b).to(torch.int8) * 2 - 1
        return torch._int_mm(sa, sb.T)
    check(torch.equal((256 - library()) // 2, call()),
          "K19: torch._int_mm's +-1 product gives another matrix")
    n, m = a.shape[0], b.shape[0]
    # the descriptors in, the whole int32 matrix out once; 2 x 256
    # operations a pair at the dense int8 tensor-core rate
    t_b = (n * m * 4 + (n + m) * 32) / HBM_BYTES_PER_S * 1e3
    t_o = 2 * 256 * n * m / INT8_OPS_PER_S * 1e3
    row = dict(name="hamming_mxu", route="cuda",
               source="morb_slam_tpu_torch/csrc/hamming_mxu.cu",
               replaces="morb_slam_tpu/ops/hamming.py:40", max_abs_err=0.0,
               ms=device_ms(call, "hamming_mxu_kernel"),
               call_ms=time_ms(call),
               plain_ms=time_ms(lambda: hamming.hamming_matrix_mxu_plain(
                   a, b), reps=10),
               hamming_matrix_ms=time_ms(lambda: hamming.hamming_matrix(
                   a, b), reps=10),
               bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               bound_ms_bytes=t_b, bound_ms_int8_ops=t_o,
               library_ms=device_ms(library, None),
               library_call_ms=time_ms(library),
               library="torch._int_mm on the +-1 int8 matrices, the "
                       "unpacking included (device time, as ms)",
               counters=["hamming_mxu"], ptxas=_ptxas("hamming_mxu"),
               shape=f"{n}x{m} frame descriptors (one launch); bitwise "
                     f"also at 1000x777")
    log(f"K19 hamming_matrix_mxu {n}x{m}: {row['ms']:.4f} ms on the card, "
        f"call {row['call_ms']:.4f}, plain {row['plain_ms']:.4f}, "
        f"torch._int_mm {row['library_ms']:.4f} ms; bound "
        f"{row['bound_ms']:.5f} ms by {row['bound_by']} (int8 operations "
        f"{t_o:.5f}); ptxas {row['ptxas']}")
    return row


def k3_gate_inputs(feats, cfg):
    """K3's gated inputs on rendered frames' features: (mode, args, max_d)
    of the projection window (4096 rows of frames 1.. against frame 0's
    features), the last-frame window with NaN projections and the stereo
    row band (frame 0 against frame 1)."""
    f0, f1 = feats[0], feats[1]
    sf = cfg.scale ** torch.arange(cfg.n_levels, device=f0.uv.device,
                                   dtype=torch.float32)
    big = [torch.cat([getattr(f, k) for f in feats[1:]])[:4096].contiguous()
           for k in ("desc", "uv", "octave", "valid")]
    nan_uv = f0.uv.clone()
    nan_uv[::17] = float("nan")
    return (
        ("window", (big[0], f0.desc, big[1], 4.0 * sf[big[2].long()],
                    big[2], big[3], f0.uv, f0.octave, f0.valid), 0.0),
        ("window_nan", (f0.desc, f1.desc, nan_uv, 8.0 * sf[f0.octave.long()],
                        f0.octave, f0.valid, f1.uv, f1.octave, f1.valid),
         0.0),
        ("row_band", (f0.desc, f1.desc, f0.uv, 2.0 * sf[f0.octave.long()],
                      f0.octave, f0.valid, f1.uv, f1.octave, f1.valid),
         60.0))


def _k3_gated_numbers(args, mode, max_d=0.0, time_plain=False):
    """K3's gated mode on one call's inputs (a, b, then the row and column
    gate inputs): best, index and second bitwise equal to its plain
    version (the gate on the flagged rows and columns, then the distances
    of the gated pairs alone, `hamming.hamming_top2_gated_plain`, which
    `plain_ms` times) and to the masked
    kernel on that gate; the kernel's device ms and call ms, and the same
    function before this design (the dense gate composition + the masked
    K3) timed alike; the bound recounted for what the gated kernel reads
    and does."""
    from morb_slam_tpu_torch.ops import hamming
    got = hamming.hamming_top2_gated(*args, mode, max_d=max_d)
    want = hamming.hamming_top2_gated_plain(*args, mode, max_d=max_d)
    mask = hamming.gate_mask(*args[2:], mode, max_d=max_d)
    masked = hamming.hamming_top2(args[0], args[1], mask)
    for name, g, w, k in zip(("best", "index", "second"), got, want, masked):
        check(torch.equal(g, w) and torch.equal(g, k),
              f"K3 gated {mode}: {name} differs from plain in "
              f"{int((g != w).sum())} rows, from the masked kernel in "
              f"{int((g != k).sum())}")
    n, m = args[0].shape[0], args[1].shape[0]
    rows_on = int(args[5].sum())
    n_pass = int(mask.sum())

    def call():
        hamming.hamming_top2_gated(*args, mode, max_d=max_d)

    def before():
        hamming.hamming_top2(args[0], args[1], hamming.gate_mask(
            *args[2:], mode, max_d=max_d))
    # per row uv, radius, octave, flag (17 B) in, (best, index, second)
    # out; per column uv, octave, flag (13 B); the descriptors of flagged
    # rows and of columns that some pair passes; ~10 operations a pair of
    # a flagged row, 16 more a passing pair
    b_ms, b_by = bound(n * 29 + m * 13 + rows_on * 32
                       + int(mask.any(0).sum()) * 32,
                       rows_on * m * 10 + n_pass * 16)
    out = dict(mode=mode, shape=f"{n}x{m}", rows_flagged=rows_on,
               pairs_passed=n_pass, bitwise_equal=True,
               ms=device_ms(call, "hamming_top2_gated_kernel"),
               call_ms=time_ms(call), kernels=kernels_per_call(call),
               before_ms=device_ms(before, None), before_call_ms=time_ms(
                   before), before_kernels=kernels_per_call(before),
               bound_ms=b_ms, bound_by=b_by)
    if time_plain:
        out["plain_ms"] = time_ms(lambda: hamming.hamming_top2_gated_plain(
            *args, mode, max_d=max_d), reps=10)
    log(f"K3 gated {mode} {n}x{m}: bitwise equal to plain and to the "
        f"masked kernel ({rows_on} rows flagged, {n_pass} pairs pass); "
        f"{out['ms']:.4f} ms device, {out['call_ms']:.4f} ms a call; before "
        f"(gate + masked K3) {out['before_ms']:.4f} ms device in "
        f"{out['before_kernels']} kernels, {out['before_call_ms']:.4f} ms a "
        f"call; bound {b_ms:.5f} ms by {b_by}")
    return out


PYR_TOL = 1e-3   # K6 pyramid against the plain pyramid, grey levels


def _k6_row(img, cfg):
    """K6 on the mono path's first 752x480 image, 8 levels, in one launch
    (pyramid_blur): the levels and blurred levels bitwise equal to the
    per-level chain (build_pyramid, blur_levels) and repeatable, the blur
    bitwise equal to the plain blur of the same levels, the pyramid within
    PYR_TOL of the plain pyramid (cuBLAS, TF32 off), one launch an image;
    and extract_orb with the kernel and with the plain K6 forced in
    agreement on >= 99% of the (yx, octave) slots and >= 99.9% of their
    descriptor bits."""
    from morb_slam_tpu_torch import frontend, testing
    from morb_slam_tpu_torch.ops import image, orb_descriptor
    L, sc = cfg.n_levels, cfg.scale
    n0 = image.LAUNCHES["kernel"]
    lk, bk = image.pyramid_blur(img, L, sc)
    per_image = image.LAUNCHES["kernel"] - n0
    per = image.build_pyramid(img, L, sc)
    per_blur = image.blur_levels(per)
    chain_bitwise = all(torch.equal(a, b) for a, b in
                        zip(lk + bk, per + per_blur))
    lp = image.build_pyramid_plain(img, L, sc)
    pyr_err = max(float((a - b).abs().max()) for a, b in zip(lk, lp))
    blur_bitwise = all(torch.equal(a, image.gaussian_blur_plain(b))
                       for a, b in zip(bk, lk))
    again = image.pyramid_blur(img, L, sc)
    repeatable = all(torch.equal(a, b) for a, b in
                     zip(again[0] + again[1], lk + bk))
    log(f"K6 pyramid_blur: {per_image} launch an image, bitwise equal to "
        f"the per-level chain and blur_levels {chain_bitwise}; pyramid max "
        f"|kernel - plain| {pyr_err:.3e} grey levels (tolerance {PYR_TOL}), "
        f"blur bitwise equal to plain {blur_bitwise}, bitwise repeatable "
        f"{repeatable}")
    check(per_image == 1 and chain_bitwise and pyr_err < PYR_TOL
          and blur_bitwise and repeatable,
          ("K6", per_image, chain_bitwise, pyr_err, blur_bitwise, repeatable))

    f_k = frontend.extract_orb(img, cfg)
    saved = image.pyramid_blur
    image.pyramid_blur = testing.plain_pyramid_blur
    try:
        f_p = frontend.extract_orb(img, cfg)
    finally:
        image.pyramid_blur = saved
    same = (f_k.uv == f_p.uv).all(-1) & (f_k.octave == f_p.octave) & \
        (f_k.valid == f_p.valid)
    slots = float(same.float().mean())
    ok = same & f_p.valid
    bits = float((orb_descriptor.unpack_bits(f_k.desc[ok])
                  == orb_descriptor.unpack_bits(f_p.desc[ok])).float().mean())
    log(f"K6 in extract_orb: {slots:.5f} of the (yx, octave) slots and "
        f"{bits:.6f} of their descriptor bits agree with the plain K6")
    check(slots >= 0.99 and bits >= 0.999, ("K6 extract_orb", slots, bits))

    def k6():
        image.pyramid_blur(img, L, sc)

    def per_level():
        image.blur_levels(image.build_pyramid(img, L, sc))

    def plain():
        for l in image.build_pyramid_plain(img, L, sc):
            image.gaussian_blur_plain(l)
    shapes = image.level_shapes(img.shape[0], img.shape[1], L, sc)
    npx = [h * w for h, w in shapes]
    # the image in once; levels 1.. and every blurred level out once (level
    # 0 is the image: the copy into the levels' buffer is the layout's, not
    # the function's); ~12 flops per resized and 28 per blurred pixel
    b_ms, b_by = bound(4 * (npx[0] + sum(npx[1:]) + sum(npx)),
                       12 * sum(npx[1:]) + 28 * sum(npx))
    EVENT_TIMED.discard("pyramid_blur_kernel")
    ms = device_ms(k6, "pyramid_blur_kernel")
    by_events = "pyramid_blur_kernel" in EVENT_TIMED
    per_ms = {k: device_ms(per_level, k) for k in (
        None, "pyramid_level_kernel", "blur_levels_kernel")}
    # the library's blur: a 7x7 convolution with the kernel's outer
    # product on each replicate-padded level (cuDNN, TF32 off); the same
    # blur up to the order of the 49 products' sum
    k7 = torch.from_numpy(np.outer(image._KERNEL7, image._KERNEL7)).to(
        img.device)[None, None]
    r7 = len(image._KERNEL7) // 2

    def library_blur():
        return [F.conv2d(F.pad(l[None, None], (r7,) * 4, mode="replicate"),
                         k7)[0, 0] for l in lk]
    lib_diff = max(float((a - b).abs().max())
                   for a, b in zip(library_blur(), bk))
    EVENT_TIMED.discard(None)
    lib_blur_ms = device_ms(library_blur, None)
    lib_by_events = None in EVENT_TIMED
    return dict(name="pyramid_blur", route="cuda",
                source="morb_slam_tpu_torch/csrc/pyramid_blur.cu",
                replaces="morb_slam_tpu/ops/image.py:33",
                replaces_also="morb_slam_tpu/ops/image.py:55",
                max_abs_err=pyr_err, max_abs_err_is="pyramid, grey levels; "
                "the blur is bitwise equal", pyramid_tolerance=PYR_TOL,
                bitwise_equal_per_level_chain=chain_bitwise,
                blur_bitwise=blur_bitwise, bitwise_repeatable=repeatable,
                extract_orb_slots_agree=slots, extract_orb_bits_agree=bits,
                ms=ms,
                ms_is="one image: one launch (the level-0 copy, levels "
                      "1-7 and the 8 blurs)",
                ms_by="cuda events" if by_events else "profiler",
                call_ms=time_ms(k6), plain_ms=time_ms(plain, reps=10),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library_note="none: F.interpolate(antialias=True) is another "
                             "filter, and no single call blurs a pyramid",
                per_level_path=dict(
                    device_ms=per_ms[None],
                    pyramid_ms=per_ms["pyramid_level_kernel"],
                    blur_ms=per_ms["blur_levels_kernel"],
                    call_ms=time_ms(per_level),
                    kernels=kernels_per_call(per_level),
                    is_="the level-0 copy, 7 pyramid_level launches and "
                        "the blur launch: the per-level path, kept as the "
                        "comparison"),
                library_blur_ms=lib_blur_ms,
                library_blur_ms_by="cuda events" if lib_by_events
                else "profiler",
                library_blur_call_ms=time_ms(library_blur),
                library_blur_max_abs_diff=lib_diff,
                library_blur="per level F.pad(replicate) + F.conv2d 7x7 "
                             "outer product, TF32 off (device time of both)",
                launches_per_image=per_image,
                kernels_per_image=kernels_per_call(k6),
                ptxas=_ptxas("pyramid_blur"),
                shape=f"one {img.shape[1]}x{img.shape[0]} image, {L} levels")


def _kernel_counters():
    """The launch counter of each hand-written kernel, by kernel name."""
    from morb_slam_tpu_torch import imu
    from morb_slam_tpu_torch.ops import (fast, hamming, image,
                                         orb_descriptor, rectify, stereo)
    from morb_slam_tpu_torch.optim import (ba, inertial, pose_graph,
                                           pose_opt, vi_ba)
    from morb_slam_tpu_torch.pipeline import loop_closing
    from morb_slam_tpu_torch.vocab import tree
    return {"fast_select": fast.LAUNCHES,
            "orb_describe": orb_descriptor.LAUNCHES,
            "hamming_top2": hamming.LAUNCHES, "stereo_sad": stereo.LAUNCHES,
            "remap_bilinear": rectify.LAUNCHES, "pose_opt": pose_opt.LAUNCHES,
            "vocab_transform": tree.LAUNCHES["vocab_transform"],
            "bow_l1": tree.LAUNCHES["bow_l1"], "ba_assemble": ba.LAUNCHES,
            "preintegrate": imu.LAUNCHES, "pose_inertial": vi_ba.LAUNCHES,
            "ba_assemble_per_obs": ba.OBS_LAUNCHES,
            "schur_pcg": ba.PCG_LAUNCHES,
            "schur_passes": ba.SCHUR_LAUNCHES,
            "vi_edges": vi_ba.INERTIAL_LAUNCHES,
            "pose_graph": pose_graph.LAUNCHES,
            "pyramid_blur": image.LAUNCHES,
            "stereo_general": stereo.GENERAL_LAUNCHES,
            "inertial_init": inertial.INIT_LAUNCHES,
            "sim3_window": loop_closing.WINDOW_LAUNCHES,
            "sim3_refine": loop_closing.REFINE_LAUNCHES,
            "hamming_mxu": hamming.MXU_LAUNCHES}


# kernels that no pipeline path calls, as in the reference: each path's
# count of them is read and must be 0
NO_PATH_KERNELS = ("hamming_mxu",)


def _reset_counters():
    for c in _kernel_counters().values():
        c["kernel"] = 0
        c["plain"] = 0


def _read_counters(names, path, state, allow_plain=()):
    """Kernel and plain counts of one path's run; fail unless each kernel
    of the path launched and no plain version ran (but those of
    `allow_plain`)."""
    counters = _kernel_counters()
    launches = {k: counters[k]["kernel"] for k in names}
    plain = {k: c["plain"] for k, c in counters.items()
             if k not in allow_plain}
    log(f"{path}: kernel launches", launches, "plain calls", plain)
    for k in names:
        check(launches[k] > 0, f"{k} never launched on the {path} path")
    check(not any(plain.values()), f"a plain version ran on the {path} path")
    state.setdefault("launches_by_path", {})[path] = launches
    state.setdefault("all_launches_by_path", {})[path] = {
        k: c["kernel"] for k, c in counters.items()}
    return launches


def phase_main(state):
    from morb_slam_tpu_torch import cameras
    from morb_slam_tpu_torch.pipeline import tracking
    world, poses = _world(state)
    frames = [world.render(*poses[i]).clamp(0, 255).to(torch.uint8)
              for i in range(N_FRAMES + 5)]
    torch.cuda.synchronize()
    cam = cameras.pinhole(FX, FX, W / 2, H / 2)
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=1200,
                                 max_kf=256, max_lm=16384, n_levels=8,
                                 min_init_matches=80, min_init_points=50)
    tracker = tracking.Tracker(cam, cfg)
    inserts = _timed_inserts(tracker)

    def feed(i, ts):
        return tracker.track_mono(frames[i], ts=ts)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    states, fm, secs, n_ins_20 = _track_run(tracker, feed, N_FRAMES, 1.0,
                                            inserts)
    launches = _read_counters(["fast_select", "orb_describe", "hamming_top2",
                               "pose_opt", "ba_assemble", "pyramid_blur"],
                              "mono", state)
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    check("OK" in states, "never initialized")
    n_ok = sum(s == "OK" for s in states)
    check(n_ok >= 0.7 * N_FRAMES, f"only {n_ok} of {N_FRAMES} frames OK")
    ate, _, _, extent, n_traj = _ate(tracker, poses, 1.0)
    log(f"trajectory: {n_traj} poses, Sim3 ATE {ate:.4f} m over "
        f"{extent:.3f} m extent (gate {0.023 * extent:.4f})")
    check(math.isfinite(ate) and ate < 0.023 * extent, (ate, extent))
    main = dict(
        fps=(N_FRAMES - 20) / secs,
        frame_ms_p50=float(np.percentile(fm, 50)),
        frame_ms_p90=float(np.percentile(fm, 90)),
        frames_ok=n_ok, kf_inserts=len(inserts),
        kf_insert_ms_each=float(np.mean(inserts)) if inserts else None,
        kf_inserts_in_timed_window=len(inserts) - n_ins_20,
        ate_sim3_m=ate, extent_m=extent,
        peak_device_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_frame={k: v / N_FRAMES for k, v in launches.items()})
    log("main path:", json.dumps(main))
    _path_profile(tracker, lambda i: feed(i, float(i)),
                  range(N_FRAMES, N_FRAMES + 5), "mono", main, inserts,
                  state.get("profile_out"))
    state["main"] = main


# ---------------------------------------------------------------------------
# stereo / RGB-D harness
# ---------------------------------------------------------------------------

def _rig(state):
    """The EuRoC-calibrated rig: settings, the port's rectify maps and the
    undistorted rays of both raw cameras (cached in state)."""
    if "rig" not in state:
        from morb_slam_tpu_torch.io import config
        from morb_slam_tpu_torch.ops import rectify

        def cam_settings(c):
            return config.CameraSettings(model="PinHole", fx=c[0], fy=c[1],
                                         cx=c[2], cy=c[3], dist=c[4],
                                         width=W, height=H)
        baseline = float(np.linalg.norm(T_C0_C1[:3, 3]))
        settings = config.Settings(
            sensor="stereo", cam1=cam_settings(CAM0), cam2=cam_settings(CAM1),
            T_c1_c2=T_C0_C1, baseline=baseline, bf=baseline * CAM0[0],
            th_depth=35.0, n_features=1200, n_levels=8, scale_factor=1.2)
        maps = rectify.build_rectify_maps(
            settings.cam1.to_camera(), settings.cam2.to_camera(), T_C0_C1, W,
            H, device=DEV)
        rays0, res0 = raw_rays(CAM0, W, H, DEV)
        rays1, res1 = raw_rays(CAM1, W, H, DEV)
        log(f"rig: rectified baseline {float(maps.baseline):.6f} m, raw-ray "
            f"residuals {res0:.1e} / {res1:.1e} (normalized)")
        check(max(res0, res1) < 1e-6, ("raw rays did not converge", res0,
                                        res1))
        state["rig"] = dict(settings=settings, maps=maps, rays=(rays0, rays1))
    return state["rig"]


def _raw_pair(state, R1, t1, world=None):
    """uint8 raw (distorted) left and right images of the rig at cam0 pose
    T_c0_w = (R1, t1), rendered with grid_sample (in `world`, by default
    the plane world)."""
    world = world or _world(state)[0]
    rays0, rays1 = _rig(state)["rays"]
    R_10 = T_C0_C1[:3, :3].T
    t_10 = -R_10 @ T_C0_C1[:3, 3]
    R1 = np.asarray(R1, np.float64)
    t1 = np.asarray(t1, np.float64)
    eye = np.eye(3)
    left = world.render_points(R1, t1, rays0, eye, (H, W))[0]
    right = world.render_points(R_10 @ R1, R_10 @ t1 + t_10, rays1, eye,
                                (H, W))[0]
    return tuple(x.clamp(0, 255).to(torch.uint8) for x in (left, right))


def _distinct(idx):
    return torch.unique(idx).numel()


def _stereo_kernels(state, rows):
    """K7 and K8 against their plain versions at the stereo path's shapes,
    and K1 / K2 on the remapped (non-integer) frame."""
    from morb_slam_tpu_torch import frontend
    from morb_slam_tpu_torch.ops import (fast, image, orb_descriptor,
                                         rectify, stereo)
    _, poses = _world(state)
    rig = _rig(state)
    maps = torch.stack([rig["maps"].map1, rig["maps"].map2])
    raw = torch.stack(_raw_pair(state, *poses[0])).float()

    # K8 on the raw pair: exact (same rounding, no FMA)
    rect = rectify.remap_bilinear(raw, maps)
    want = rectify.remap_bilinear_plain(raw, maps)
    err = float((rect - want).abs().max())
    check(torch.equal(rect, want), ("K8 mismatch", err))
    frac = float((rect != torch.round(rect)).float().mean())
    log(f"K8 remap_bilinear: exact on the raw pair; {frac:.3f} of the "
        f"rectified pixels are non-integer")
    gx = maps[..., 0] / (W - 1) * 2 - 1
    gy = maps[..., 1] / (H - 1) * 2 - 1
    grid = torch.stack([gx, gy], -1)

    def library():
        return F.grid_sample(raw[:, None], grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)
    x0 = torch.floor(maps[..., 0]).long().clamp(0, W - 1)
    y0 = torch.floor(maps[..., 1]).long().clamp(0, H - 1)
    inside = ((maps[..., 0] >= 0) & (maps[..., 0] <= W - 1)
              & (maps[..., 1] >= 0) & (maps[..., 1] <= H - 1))
    taps = 0
    for b in range(2):
        ids = [(y0[b] + dy).clamp(max=H - 1) * W + (x0[b] + dx).clamp(
            max=W - 1) for dy in (0, 1) for dx in (0, 1)]
        taps += _distinct(torch.stack(ids)[:, inside[b]])
    npx = maps.shape[0] * H * W
    # per output: the (x, y) map entry and 4 B out; the distinct source
    # pixels the taps read; ~21 flops (2 floor, 4 sub, 8 mul, 3 add, 4 cmp)
    b_ms, b_by = bound(npx * 12 + taps * 4, npx * 21)
    rows.append(dict(
        name="remap_bilinear", route="cuda",
        source="morb_slam_tpu_torch/csrc/remap_bilinear.cu",
        replaces="morb_slam_tpu/ops/rectify.py:97", max_abs_err=err,
        ms=device_ms(lambda: rectify.remap_bilinear(raw, maps),
                     "remap_bilinear_kernel"),
        call_ms=time_ms(lambda: rectify.remap_bilinear(raw, maps)),
        plain_ms=time_ms(lambda: rectify.remap_bilinear_plain(raw, maps),
                         reps=10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(library, None),
        library_call_ms=time_ms(library),
        library="F.grid_sample bilinear, zeros padding, align_corners "
                "(device time, as ms)",
        shape="2 x 752x480 (one stereo pair, one launch)"))

    # K1 and K2 on the remapped, non-integer left frame
    cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
    counts = cfg.per_level_counts()
    pyr = image.build_pyramid(rect[0].contiguous(), cfg.n_levels, cfg.scale)
    kp = fast.fast_select_levels(pyr, counts, cfg)
    want = fast.fast_select_levels_plain(pyr, counts, cfg)
    check(kp.kept == want.kept, "K1 mismatch on the remapped frame: kept")
    for f, a, b in zip(fast.SLOT_FIELDS, kp, want):
        check(torch.equal(a, b), f"K1 mismatch on the remapped frame: {f}")
    max_ang, bit_diff, bit_tot = 0.0, 0, 0
    for lvl, yx in zip(pyr, kp.level_yx()):
        blur = image.gaussian_blur(lvl).contiguous()
        a1, d1 = orb_descriptor.orb_describe(lvl, blur, yx)
        a0 = orb_descriptor.compute_orientations(lvl, yx)
        d0 = orb_descriptor.compute_descriptors(blur, yx, a0)
        dang = torch.remainder(a1 - a0 + math.pi, 2 * math.pi) - math.pi
        max_ang = max(max_ang, float(dang.abs().max()))
        bits = orb_descriptor.unpack_bits(d1) != orb_descriptor.unpack_bits(d0)
        bit_diff += int(bits.sum())
        bit_tot += bits.numel()
    share = 1.0 - bit_diff / bit_tot
    log(f"K1 exact and K2 within {max_ang:.2e} rad, {share:.5f} of the bits "
        f"identical, on the remapped (non-integer) frame")
    check(max_ang < 1e-4 and share >= 0.999, (max_ang, share))
    rows[0]["exact_on_remapped_frame"] = True
    rows[1]["max_abs_err_remapped_frame"] = max_ang
    rows[1]["bits_identical_remapped_frame"] = share

    # K7 on the rectified pair's real features (1200 x 1200): the whole
    # tail of match_stereo in one launch, and its sweep alone
    fl = frontend.extract_orb(rect[0].contiguous(), cfg)
    fr = frontend.extract_orb(rect[1].contiguous(), cfg)
    bf = float(rig["maps"].baseline) * CAM0[0]
    max_d = bf / float(rig["maps"].baseline)
    sf = torch.tensor([1.2 ** i for i in range(8)], device=DEV)
    best_idx, matched = stereo.row_search(fl, fr, sf, max_d)
    u0 = fr.uv[best_idx.long(), 0].contiguous()
    uv, uvr = fl.uv.contiguous(), fr.uv.contiguous()
    for name, (il, ir) in (("integer", (torch.round(rect[0]),
                                        torch.round(rect[1]))),
                           ("non-integer", (rect[0], rect[1]))):
        il, ir = il.contiguous(), ir.contiguous()
        k7 = (il, ir, uv, uvr, best_idx, matched, bf, max_d)
        got = stereo.sad_refine(il, ir, uv, u0)
        ref = stereo.sad_refine_plain(il, ir, uv, u0)
        ur_err = float((got[0] - ref[0]).abs().max())
        sm, sm0 = stereo.refine_and_filter(*k7), \
            stereo.refine_and_filter_plain(*k7)
        same = all(torch.equal(a, b) for a, b in zip(sm, sm0))
        flips = int((sm.valid != sm0.valid).sum())
        both = sm.valid & sm0.valid
        sm_err = float((sm.u_right - sm0.u_right)[both].abs().max()) \
            if bool(both.any()) else 0.0
        log(f"K7 stereo_sad on the {name} pair: the sweep's u_right within "
            f"{ur_err:.2e} px, best offsets equal "
            f"{bool(torch.equal(got[2], ref[2]))}; the whole launch "
            f"(u_right, depth, valid) bitwise equal to the plain "
            f"composition {same}, {flips} of {uv.shape[0]} match flags "
            f"flipped, u_right within {sm_err:.2e} px where both keep, "
            f"{int(matched.sum())} row matches, {int(sm.valid.sum())} kept")
        if name == "integer":
            check(torch.equal(got[2], ref[2]) and torch.equal(got[1], ref[1])
                  and ur_err <= 1e-5 and same, ("K7 integer", ur_err, flips))
        else:
            check(ur_err <= 1e-3 and sm_err <= 1e-3
                  and flips <= 0.005 * uv.shape[0],
                  ("K7 non-integer", ur_err, sm_err, flips))
            k7_err = max(ur_err, sm_err)
    il, ir = rect[0].contiguous(), rect[1].contiguous()
    k7 = (il, ir, uv, uvr, best_idx, matched, bf, max_d)
    n = uv.shape[0]
    wl, strip = stereo._windows(torch.arange(H * W, device=DEV).view(H, W),
                                torch.arange(H * W, device=DEV).view(H, W),
                                uv, u0)
    # what the function reads and returns: in, the distinct pixels of the
    # windows and strips, uv_l (8 B), the index and the flag (5 B) and the
    # matched right x (the distinct right keypoints, 4 B each); out,
    # u_right, depth, valid (9 B). The kernel's own scratch (ur_ref,
    # sad_best) is not the function's work. ~5455 flops a keypoint (11 x
    # 121 x 4 + 121 + the parabola), the gate, the 4 select passes and the
    # depth (~12 more)
    b_ms, b_by = bound((_distinct(wl) + _distinct(strip)) * 4
                       + _distinct(best_idx) * 4 + n * (8 + 5 + 9),
                       n * (5455 + 12))

    def tail_plain():
        return stereo.refine_and_filter_plain(*k7)
    rows.append(dict(
        name="stereo_sad", route="cuda",
        source="morb_slam_tpu_torch/csrc/stereo_sad.cu",
        replaces="morb_slam_tpu/ops/stereo.py:64-120", max_abs_err=k7_err,
        max_abs_err_is="u_right, non-integer pair (the integer pair: "
                       "u_right, depth and valid bitwise equal)",
        ms=device_ms(lambda: stereo.refine_and_filter(*k7),
                     "stereo_sad_kernel"),
        ms_is="one launch: the matched right x, the SAD sweep, the "
              "disparity gate, the median filter and the depth",
        call_ms=time_ms(lambda: stereo.refine_and_filter(*k7)),
        plain_ms=time_ms(tail_plain, reps=10),
        plain_kernels_per_call=kernels_per_call(tail_plain),
        plain_device_ms=device_ms(tail_plain, None),
        sweep_ms=device_ms(lambda: stereo.sad_refine(il, ir, uv, u0),
                           "stereo_sad_kernel"),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ptxas=_ptxas("stereo_sad"),
        shape="1200 left keypoints of a 752x480 rectified pair"))
    check("0 bytes spill stores, 0 bytes spill loads" in rows[-1]["ptxas"],
          ("K7 spills", rows[-1]["ptxas"]))


# ---------------------------------------------------------------------------
# relocalization harness: vocabulary, K5 / K9 / K10 checks
# ---------------------------------------------------------------------------

def _vocabulary(state):
    """The k = 10, depth = 4 vocabulary, trained on the host (the port's
    numpy `train`) from the descriptors of every 4th frame of the path,
    extracted by the port on the card (cached in state)."""
    if "voc" not in state:
        from morb_slam_tpu_torch import frontend
        from morb_slam_tpu_torch.vocab import tree
        world, poses = _world(state)
        cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
        descs = []
        for R, t in poses[::4]:
            f = frontend.extract_orb(
                world.render(R, t).clamp(0, 255).to(torch.uint8).float(), cfg)
            descs.append(f.desc[f.valid].cpu().numpy())
        descs = np.concatenate(descs)
        t0 = time.perf_counter()
        voc = tree.train(descs, k=VOC_K, depth=VOC_DEPTH, iters=VOC_ITERS)
        secs = time.perf_counter() - t0
        log(f"vocabulary: k {VOC_K}, depth {VOC_DEPTH}, {voc.n_words} words "
            f"trained on {descs.shape[0]} descriptors of {len(poses[::4])} "
            f"frames in {secs:.1f} s ({VOC_ITERS} k-means iterations)")
        state["voc"] = voc.to(DEV)
        state["voc_train"] = dict(seconds=secs, descriptors=descs.shape[0],
                                  frames=len(poses[::4]), iters=VOC_ITERS)
    return state["voc"]


def _pose_problem(n, stereo_share, seed):
    """A pose problem shaped like the tracker's: n points 2-8 units ahead,
    0.5 px noise at focal FX, 10% outliers, 5% invalid rows, octave-scaled
    information, a share of stereo rows (baseline 0.11), solved from a pose
    ~4 degrees and ~3 cm off."""
    from morb_slam_tpu_torch import lie
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(2, 8, n)], -1)
    xn = X[:, :2] / X[:, 2:] + rng.normal(0, 0.5 / FX, (n, 2))
    bad = rng.random(n) < 0.1
    xn[bad] += rng.uniform(-0.05, 0.05, (int(bad.sum()), 2))
    ur = np.full(n, np.nan)
    st = rng.random(n) < stereo_share
    ur[st] = (X[st, 0] - 0.11) / X[st, 2] + rng.normal(0, 0.5 / FX,
                                                      int(st.sum()))
    info = FX ** 2 * 1.2 ** (-2.0 * rng.integers(0, 8, n))
    valid = rng.random(n) < 0.95
    dR, dt = lie.se3_exp(torch.tensor([0.05, -0.03, 0.04, 0.02, -0.01, 0.015]))

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=DEV)
    return ((dR.to(DEV), dt.to(DEV), f(X), f(xn), f(info),
             torch.from_numpy(valid).to(DEV)),
            dict(obs_ur=f(ur) if stereo_share > 0 else None,
                 baseline=0.11 if stereo_share > 0 else 0.0))


def _reloc_kernels(state, rows):
    """K5, K9 and K10 against their plain versions at the shapes of the
    tracking and relocalization paths."""
    from morb_slam_tpu_torch import frontend
    from morb_slam_tpu_torch.optim import pose_opt
    from morb_slam_tpu_torch.vocab import tree

    # K5 on a tracking-shaped (mixed stereo, 2 x 8) and a relocalization-
    # shaped (mono, 3 x 10) problem of 1200 observations: R, t within 1e-4,
    # the inlier count within 1%
    k5 = {}
    for name, share, rounds, iters, seed in (("tracking", 0.6, 2, 8, 1),
                                             ("relocalization", 0.0, 3, 10,
                                              2)):
        args, kw = _pose_problem(1200, share, seed)
        kw.update(n_rounds=rounds, n_iters=iters)
        got = pose_opt.optimize_pose(*args, **kw)
        want = pose_opt.optimize_pose_plain(*args, **kw)
        err = max(float((got.R - want.R).abs().max()),
                  float((got.t - want.t).abs().max()))
        n_valid = int(args[5].sum())
        dn = abs(int(got.n_inliers) - int(want.n_inliers))
        log(f"K5 pose_opt {name} (1200 obs, {rounds} x {iters}): R, t within "
            f"{err:.2e}, inliers {int(got.n_inliers)} vs plain "
            f"{int(want.n_inliers)} of {n_valid} valid")
        check(err <= 1e-4 and dn <= 0.01 * n_valid, ("K5", name, err, dn))
        check(int(got.n_inliers) == int(got.inliers.sum()),
              ("K5 inlier count", name))
        n_st = int((args[5] & torch.isfinite(kw["obs_ur"])).sum()) \
            if kw["obs_ur"] is not None else 0
        # inputs read once (X, obs, info, valid, obs_ur), outputs written
        # once; per Gauss-Newton step and active row ~200 flops (pose,
        # residual, Huber weight, 2 Jacobian rows, their 27 normal-equation
        # sums), ~280 for a stereo row; ~30 per row to reclassify
        nbytes = 1200 * (25 + 5) + (1200 * 4 if n_st else 0) + 2 * 48 + 8
        nops = rounds * iters * ((n_valid - n_st) * 200 + n_st * 280) + \
            (rounds + 1) * 1200 * 30
        b_ms, b_by = bound(nbytes, nops)
        k5[name] = dict(
            ms=device_ms(lambda: pose_opt.optimize_pose(*args, **kw),
                         "pose_opt_kernel"),
            call_ms=time_ms(lambda: pose_opt.optimize_pose(*args, **kw)),
            plain_ms=time_ms(lambda: pose_opt.optimize_pose_plain(*args, **kw),
                             reps=5, inner=2),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            inliers=int(got.n_inliers), inliers_plain=int(want.n_inliers))
    tr, rl = k5["tracking"], k5["relocalization"]
    rows.append(dict(
        name="pose_opt", route="cuda",
        source="morb_slam_tpu_torch/csrc/pose_opt.cu",
        replaces="morb_slam_tpu/optim/pose_opt.py:67",
        max_abs_err=max(tr["max_abs_err"], rl["max_abs_err"]),
        ms=tr["ms"], call_ms=tr["call_ms"], plain_ms=tr["plain_ms"],
        bound_ms=tr["bound_ms"], bound_by=tr["bound_by"], library_ms=None,
        relocalization_shape=rl, ptxas=_ptxas("pose_opt"),
        shape="1200 observations, 60% stereo, 2 x 8 (tracking)"))

    # K9 on the descriptors of three frames of the path: exact
    voc = _vocabulary(state)
    world, poses = _world(state)
    cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
    def frame_feats(i):
        img = world.render(*poses[i]).clamp(0, 255).to(torch.uint8).float()
        return frontend.extract_orb(img, cfg)
    feats = [frame_feats(i) for i in (1, 30, 57)]
    for f in feats:
        got = tree.transform(voc, f.desc, f.valid)
        want = tree.transform_plain(voc, f.desc, f.valid)
        check(torch.equal(got, want),
              ("K9 mismatch", int((got != want).sum())))
        check(torch.equal(tree.transform(voc, f.desc),
                          tree.transform_plain(voc, f.desc)), "K9 unmasked")
    log(f"K9 vocab_transform: word ids exact on {len(feats)} frames "
        f"({sum(int(f.valid.sum()) for f in feats)} valid descriptors)")
    d, v = feats[0].desc, feats[0].valid
    words = tree.transform(voc, d, v)
    w_ok = words[words >= 0].long()
    # the center rows this descent reads: per level the k children of each
    # distinct node it passes through
    rows_read = sum(
        VOC_K * torch.unique(w_ok // VOC_K ** (VOC_DEPTH - l)).numel()
        for l in range(VOC_DEPTH))
    n_ok = int(v.sum())
    # descriptors and mask in, word ids out, the center rows read once;
    # per valid descriptor, level and child 8 XOR + 8 popc + 8 add + compare
    b_ms, b_by = bound(d.shape[0] * (32 + 1 + 4) + rows_read * 32,
                       n_ok * VOC_DEPTH * VOC_K * 25)
    rows.append(dict(
        name="vocab_transform", route="cuda",
        source="morb_slam_tpu_torch/csrc/vocab_transform.cu",
        replaces="morb_slam_tpu/vocab/tree.py:118", max_abs_err=0.0,
        ms=device_ms(lambda: tree.transform(voc, d, v),
                     "vocab_transform_kernel"),
        call_ms=time_ms(lambda: tree.transform(voc, d, v)),
        plain_ms=time_ms(lambda: tree.transform_plain(voc, d, v), reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        center_rows_read=rows_read,
        shape=f"1200 descriptors ({n_ok} valid), k {VOC_K}, depth "
              f"{VOC_DEPTH}"))

    # K10 on a full 256 x 10^4 database: the BoW vectors of the 3 frames
    # and 253 sparse L1-normalized rows from a seed; scores within 1e-5 and
    # the same top 3 unless two scores lie within 1e-5
    Wn = voc.n_words
    real = torch.stack([tree.bow_vector(voc, tree.transform(voc, f.desc,
                                                            f.valid))
                        for f in feats])
    rng = np.random.default_rng(3)
    fake = rng.random((253, Wn)) * (rng.random((253, Wn)) < 0.05)
    fake /= fake.sum(1, keepdims=True)
    db = torch.cat([real, torch.from_numpy(fake.astype(np.float32)).to(DEV)])
    f31 = frame_feats(31)
    q = tree.bow_vector(voc, tree.transform(voc, f31.desc, f31.valid))
    ok = torch.from_numpy(rng.random(256) < 0.8).to(DEV)
    ok[:3] = True
    err = 0.0
    for mask in (None, ok):
        got = tree.l1_score(q, db, mask)
        want = tree.l1_score_plain(q, db, mask)
        err = max(err, float((got - want).abs().max()))
        top_g = torch.topk(got, 3).indices
        top_w = torch.topk(want, 3).indices
        if not torch.equal(top_g, top_w):
            s = torch.sort(want, descending=True).values[:4]
            check(bool(((s[:-1] - s[1:]) < 1e-5).any()),
                  ("K10 top-3 differ", top_g.tolist(), top_w.tolist()))
        if mask is not None:
            check(bool((got[~mask] == -1).all()), "K10 masked rows")
    Q = torch.stack([q, real[0]])
    err = max(err, float((tree.l1_score(Q, db)
                          - tree.l1_score_plain(Q, db)).abs().max()))
    check(err <= 1e-5, ("K10", err))
    top = torch.topk(tree.l1_score(q, db), 3).indices.tolist()
    log(f"K10 bow_l1: scores within {err:.2e} of plain on a 256 x {Wn} "
        f"database; top 3 rows {top} for frame 31 (row 1 is frame 30)")
    K_ = db.shape[0]
    # the database and query read once, 4 B out per row; 3 flops per element
    b_ms, b_by = bound(K_ * Wn * 4 + Wn * 4 + K_ * 4, 3 * K_ * Wn)

    def library():
        return torch.cdist(q[None], db, p=1)
    lib_err = float((1.0 - 0.5 * library()[0] - tree.l1_score(q, db))
                    .abs().max())
    rows.append(dict(
        name="bow_l1", route="cuda",
        source="morb_slam_tpu_torch/csrc/bow_l1.cu",
        replaces="morb_slam_tpu/vocab/tree.py:145", max_abs_err=err,
        ms=device_ms(lambda: tree.l1_score(q, db), "bow_l1_kernel"),
        call_ms=time_ms(lambda: tree.l1_score(q, db)),
        plain_ms=time_ms(lambda: tree.l1_score_plain(q, db), reps=10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(library, None),
        library_call_ms=time_ms(library),
        library="torch.cdist(q, db, p=1) (device time, as ms)",
        library_max_abs_err=lib_err,
        shape=f"1 query x {K_} rows x {Wn} words"))


# ---------------------------------------------------------------------------
# visual-inertial harness: K11 / K12 checks
# ---------------------------------------------------------------------------

def _imu_calib():
    from morb_slam_tpu_torch import imu
    n = IMU_NOISE
    return imu.make_calib(np.eye(3), np.zeros(3), n["noise_gyro"],
                          n["noise_acc"], n["walk_gyro"], n["walk_acc"],
                          n["frequency"], device=DEV)


def _imu_noise():
    """The discrete per-sample noise of EuRoC's densities at its rate."""
    sf = math.sqrt(IMU_NOISE["frequency"])
    return dict(noise_g=IMU_NOISE["noise_gyro"] * sf,
                noise_a=IMU_NOISE["noise_acc"] * sf)


def _imu_batch(t0, cap, n_valid, rng):
    """n_valid noisy samples of the analytic path after t0, zero-padded to
    cap, on the card: (acc, gyro, dts, mask)."""
    _, acc, gyr = imu_between(t0, t0 + (n_valid + 1) / 200.0, rng=rng,
                              **_imu_noise())
    pad = np.zeros((cap - n_valid, 3), np.float32)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEV)
    dts = np.where(np.arange(cap) < n_valid, 0.005, 0.0)
    return (f(np.concatenate([acc[:n_valid], pad])),
            f(np.concatenate([gyr[:n_valid], pad])), f(dts),
            torch.arange(cap, device=DEV) < n_valid)


PRE_FIELDS = ("dt", "dR", "dV", "dP", "J_Rg", "J_Vg", "J_Va", "J_Pg", "J_Pa",
              "avg_a", "avg_w")


def _pre_errors(got, want):
    """(largest absolute error of the deltas and Jacobians, the same
    relative to max(1, the field's max-abs), C's error relative to its
    max-abs)."""
    ab, rel = 0.0, 0.0
    for name in PRE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        e = float((a - b).abs().max())
        ab = max(ab, e)
        rel = max(rel, e / max(1.0, float(b.abs().max())))
    c = float((got.C - want.C).abs().max()) / max(
        float(want.C.abs().max()), 1e-30)
    return ab, rel, c


# K11's float32 operations per valid sample (a 3x3 product is 27 multiplies
# and 18 adds), with the structure of the transition blocks A (9x9) and B
# (9x6) of imu.py (csrc/preintegrate.cu states the same count):
K11_FLOPS = (
    513     # A C[:9, :9]: A's rows [dRi^T 0 0; M I 0; M dt/2 dt I I], M =
            # -dR hat(a) dt: 9 block products and the identity / dt terms
    + 369   # (A C) A^T, the 6 upper blocks (C stays symmetric)
    + 180   # B diag(N) B^T: Jr Ng Jr^T dt^2 and dR Na dR^T with 3 scalings
            # (B's gyro and acc columns meet in no block), added to C
    + 12    # the bias random-walk diagonal
    + 9 + 27 + 15   # a, w, phi; dR hat(a) (3 cross products); dR a
    + 110   # so3_exp and the right Jacobian of phi
    + 18 + 20       # A's two dR hat(a) blocks; dP, dV
    + 216   # the five bias Jacobians (two 3x3 products)
    + 85    # dR dRi and its Gram-Schmidt normalization
    + 7)    # dt and the measurement sums


def _vi_kernels(rows):
    """K11 and K12 against their plain versions at the visual-inertial
    path's shapes."""
    from morb_slam_tpu_torch import imu, lie
    from morb_slam_tpu_torch.optim import vi_ba
    calib = _imu_calib()
    rng = np.random.default_rng(11)
    bias = torch.tensor([0.002, -0.001, 0.003, 0.02, -0.03, 0.01],
                        device=DEV)

    # K11: a frame batch (64 slots, 10 samples) and a keyframe buffer (768
    # slots, 512 samples), each fresh and continued by a frame batch. The
    # deltas and Jacobians within 1e-5 of plain, relative to max(1, the
    # field's size): a 512-sample recursion reaches |dV| ~ 25 m/s, where
    # float32's own step is 2e-6; C within 1e-5 of its max-abs
    k11, worst = {}, (0.0, 0.0, 0.0)
    for name, cap, n in (("frame", 64, 10), ("keyframe", 768, 512)):
        acc, gyr, dts, mask = _imu_batch(1.0, cap, n, rng)
        nxt = _imu_batch(1.0 + n / 200.0, 64, 10, rng)
        got = imu.preintegrate(acc, gyr, dts, mask, bias, calib)
        want = imu.preintegrate_plain(acc, gyr, dts, mask, bias, calib)
        got2 = imu.preintegrate(*nxt, bias, calib, init=got)
        want2 = imu.preintegrate_plain(*nxt, bias, calib, init=want)
        for case, (g, w) in (("fresh", (got, want)),
                             ("continued", (got2, want2))):
            ab, rel, c = _pre_errors(g, w)
            log(f"K11 preintegrate {name} {cap}/{n} {case}: deltas and "
                f"Jacobians within {ab:.2e} ({rel:.2e} relative), C within "
                f"{c:.2e} of its max-abs")
            check(rel <= 1e-5 and c <= 1e-5, ("K11", name, case, ab, rel, c))
            worst = tuple(max(x, y) for x, y in zip(worst, (ab, rel, c)))
        k11[name] = dict(args=(acc, gyr, dts, mask), init=got, nxt=nxt,
                         n=n, cap=cap)
    fr, kf = k11["frame"], k11["keyframe"]

    def k11_bound(cap, n, cont):
        # the mask of every slot (1 B) and each valid sample's acc, gyro and
        # dt (28 B), bias and noise in, the carry in when continued, the
        # packed result out; K11_FLOPS per valid sample
        return bound(cap + n * 28 + 24 + 48 + imu.PACK * 4 * (1 + cont),
                     n * K11_FLOPS)
    # the path's per-frame call: a frame batch continuing the chain
    frame_call = (lambda: imu.preintegrate(*fr["nxt"], bias, calib,
                                           init=fr["init"]))
    b_ms, b_by = k11_bound(64, 10, 1)
    kf_call = lambda: imu.preintegrate(*kf["args"], bias, calib)
    kb_ms, kb_by = k11_bound(768, 512, 0)
    rows.append(dict(
        name="preintegrate", route="cuda",
        source="morb_slam_tpu_torch/csrc/preintegrate.cu",
        replaces="morb_slam_tpu/imu.py:79", max_abs_err=worst[0],
        max_rel_err=worst[1], C_rel_err=worst[2],
        ms=device_ms(frame_call, "preintegrate_kernel"),
        call_ms=time_ms(frame_call),
        plain_ms=time_ms(lambda: imu.preintegrate_plain(
            *fr["nxt"], bias, calib, init=fr["init"]), reps=5, inner=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        keyframe_buffer=dict(
            ms=device_ms(kf_call, "preintegrate_kernel"),
            call_ms=time_ms(kf_call),
            plain_ms=time_ms(lambda: imu.preintegrate_plain(
                *kf["args"], bias, calib), reps=2, inner=1, warmup=1),
            bound_ms=kb_ms, bound_by=kb_by,
            shape="768 slots, 512 samples, fresh"),
        ptxas=_ptxas("preintegrate"),
        shape="64 slots, 10 samples, continuing a chain (one frame)"))
    check("0 bytes spill stores, 0 bytes spill loads" in rows[-1]["ptxas"],
          ("K11 spills", rows[-1]["ptxas"]))

    # K12 on a tracking-shaped problem: 1200 observations, 60% stereo, the
    # anchor keyframe 0.05 s earlier on a constant-velocity path, its edge
    # preintegrated from noisy samples; R, t within 1e-5, v and bias within
    # 1e-4, the same inliers, H_marg within 1e-4 of its max-abs
    args, kw = _pose_problem(1200, 0.6, seed=4)
    R0, t0, X, xn, info, valid = args
    n_rows = 10
    acc = np.tile([0.0, 0.0, 9.81], (n_rows, 1)) + rng.normal(
        0, _imu_noise()["noise_a"], (n_rows, 3))
    gyr = rng.normal(0, _imu_noise()["noise_g"], (n_rows, 3))
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=DEV)
    z6 = torch.zeros(6, device=DEV)
    pre = imu.preintegrate_plain(f(acc), f(gyr), f(np.full(n_rows, 0.005)),
                                 torch.ones(n_rows, dtype=torch.bool,
                                            device=DEV), z6, calib)
    eye9 = torch.eye(9, device=DEV)
    info9 = vi_ba.floor_info(torch.linalg.inv_ex(
        pre.C[:9, :9] + 1e-9 * eye9).inverse)
    rw = 1.0 / torch.clamp(torch.diagonal(pre.C[9:, 9:]), min=1e-12)
    v = f([0.4, -0.05, 0.1])
    k12_args = (R0, t0, v + f([0.05, 0.05, -0.05]), z6, X, xn, info, valid,
                kw["obs_ur"], torch.tensor(kw["baseline"], device=DEV),
                torch.eye(3, device=DEV), -v * pre.dt, v, z6, pre.dt, pre.dR,
                pre.dV, pre.dP, pre.J_Rg, pre.J_Vg, pre.J_Va, pre.J_Pg,
                pre.J_Pa, info9, pre.bias, rw)
    got = vi_ba.optimize_pose_inertial(*k12_args, n_iters=6)
    want = vi_ba.optimize_pose_inertial_plain(*k12_args, n_iters=6)
    err_Rt = max(float((got.R_cw - want.R_cw).abs().max()),
                 float((got.t_cw - want.t_cw).abs().max()))
    err_vb = max(float((got.v - want.v).abs().max()),
                 float((got.bias - want.bias).abs().max()))
    err_H = float((got.H_marg - want.H_marg).abs().max()
                  / want.H_marg.abs().max())
    n_valid = int(valid.sum())
    c_err = float(torch.linalg.norm(-lie.matvec(got.R_cw.T, got.t_cw)))
    log(f"K12 pose_inertial (1200 obs, 60% stereo, 2 x 6 + final): R, t "
        f"within {err_Rt:.2e}, v and bias within {err_vb:.2e}, inliers "
        f"{int(got.n_inliers)} vs plain {int(want.n_inliers)} of {n_valid} "
        f"valid; H_marg within {err_H:.2e} of its max-abs; camera centre "
        f"{c_err:.2e} from the truth")
    check(err_Rt <= 1e-5 and err_vb <= 1e-4, ("K12", err_Rt, err_vb))
    check(err_H <= 1e-4, ("K12 H_marg", err_H))
    check(int(got.n_inliers) == int(want.n_inliers) ==
          int(got.inliers.sum()), ("K12 inliers", int(got.n_inliers),
                                   int(want.n_inliers)))
    check(bool(torch.isfinite(got.H_marg).all()), "K12 H_marg")
    st = torch.isfinite(kw["obs_ur"])
    n_st = int((valid & st).sum())
    n_inl = int(got.n_inliers)
    n_inl_st = int((got.inliers & st).sum())
    # inputs read once, the 15x15 marginal, state and inliers written once;
    # per assembling step and active row ~150 flops (+70 for a stereo
    # row): round 1's 6 steps over the valid rows, round 2's 6 and the
    # final step over the inliers; per step ~32 kflop of fixed work (the
    # forward-mode 9 x 15 edge Jacobian of the current state, its products,
    # the 15x15 Cholesky: the anchor is fixed, so the 30-dim system is
    # diag(I, H_cc)); ~40 flops per row for each reclassification
    nops = (6 * (n_valid * 150 + n_st * 70) + 7 * (n_inl * 150 + n_inl_st * 70)
            + 13 * 32e3 + 2 * 40 * 1200)
    b_ms, b_by = bound(1200 * 30 + 197 * 4 + 246 * 4 + 8, nops)
    call = lambda: vi_ba.optimize_pose_inertial(*k12_args, n_iters=6)
    rows.append(dict(
        name="pose_inertial", route="cuda",
        source="morb_slam_tpu_torch/csrc/pose_inertial.cu",
        replaces="morb_slam_tpu/optim/vi_ba.py:426",
        max_abs_err=max(err_Rt, err_vb), max_abs_err_R_t=err_Rt,
        max_abs_err_v_bias=err_vb, H_marg_rel_err=err_H,
        ms=device_ms(call, "pose_inertial_kernel"), call_ms=time_ms(call),
        plain_ms=time_ms(lambda: vi_ba.optimize_pose_inertial_plain(
            *k12_args, n_iters=6), reps=3, inner=1, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        inliers=n_inl, inliers_plain=int(want.n_inliers),
        ptxas=_ptxas("pose_inertial"),
        shape="1200 observations, 60% stereo, 0.05 s edge, 2 x 6 + final"))
    check("0 bytes spill stores, 0 bytes spill loads" in rows[-1]["ptxas"],
          ("K12 spills", rows[-1]["ptxas"]))


def _cloned(x):
    """A copy of nested tuples, lists, dicts and NamedTuples of tensors."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cloned(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_cloned(v) for v in x)
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    return x


class _CountCalls:
    """Count the calls of module functions during one path's run by
    wrapping the module attributes the path looks up (by default K4's LM
    loop `ba.ba_solve`); keep each one's last
    arguments, every call's keyword arguments and, for the names in
    `timed`, its milliseconds per call with the card synchronized before
    and after."""

    def __init__(self, targets=None, timed=(), keep_first=()):
        if targets is None:
            from morb_slam_tpu_torch.optim import ba
            targets = [(ba, "ba_solve")]
        self.targets = targets
        self.timed = set(timed)
        self.counts = {name: 0 for _, name in targets}
        self.ms = {name: [] for name in timed}
        self.last_args = {}
        self.first_args = {}       # a copy of the first call's, by name
        self.keep_first = set(keep_first)
        self.kwargs = {name: [] for _, name in targets}

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.targets]
        for (mod, name), fn in zip(self.targets, self.saved):
            def wrap(*a, _fn=fn, _name=name, **kw):
                self.counts[_name] += 1
                self.last_args[_name] = (a, kw)
                if _name in self.keep_first and \
                        _name not in self.first_args:
                    self.first_args[_name] = _cloned((a, kw))
                self.kwargs[_name].append(kw)
                if _name not in self.timed:
                    return _fn(*a, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.ms[_name].append((time.perf_counter() - t0) * 1e3)
                return r
            setattr(mod, name, wrap)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)


class _EventCalls:
    """CUDA-event milliseconds of each call of one module function during a
    path's run, host dispatch included: an event on the current stream
    before and after each call, read after the run (no synchronization on
    the path)."""

    def __init__(self, mod, name):
        self.mod, self.name, self.events = mod, name, []

    def __enter__(self):
        self.saved = getattr(self.mod, self.name)

        def wrap(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            r = self.saved(*a, **kw)
            e.record()
            self.events.append((s, e))
            return r
        setattr(self.mod, self.name, wrap)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.saved)

    def summary(self):
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in self.events]
        return dict(calls=len(ms),
                    median=float(np.median(ms)) if ms else None,
                    p90=float(np.percentile(ms, 90)) if ms else None)


def range_device_ms(name, run, prof=None, tries=3):
    """(device ms per call, calls, span ms per call) of a record_function
    range: the device time of the kernels launched inside it, and the
    device-side annotation's span from its first kernel to its last, idle
    gaps included. Read from `prof` where given, else from the profile that
    run() returns, profiled anew up to `tries` times while the range shows
    no device time."""
    for _ in range(tries):
        prof = prof or run()
        busy, span = None, 0.0
        for ev in prof.key_averages():
            if ev.key != name or not ev.count:
                continue
            if ev.device_type == torch.autograd.DeviceType.CPU:
                total = getattr(ev, "device_time_total", None)
                if total is None:
                    total = ev.cuda_time_total
                busy = (total / ev.count / 1e3, ev.count)
            else:
                span = ev.self_device_time_total / ev.count / 1e3
        if busy is not None and busy[0] > 0:
            return busy + (span,)
        prof = None
    check(False, f"profiler gave no device time under {name}")


def _track_run(tracker, feed, n, dt, inserts, timed_from=20):
    """Drive n frames through feed(i, ts); returns (states, frame ms of
    frames timed_from.., their seconds, KF inserts before timed_from)."""
    states, frame_ms = [], []
    t_start = None
    for i in range(n):
        if i == timed_from:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            n_ins_20 = len(inserts)
        t0 = time.perf_counter()
        states.append(feed(i, i * dt)[0])
        if i >= timed_from:
            frame_ms.append((time.perf_counter() - t0) * 1e3)
    tracker.flush()
    torch.cuda.synchronize()
    return (states, np.asarray(frame_ms), time.perf_counter() - t_start,
            n_ins_20)


def _timed_inserts(tracker):
    inserts = []
    orig = tracker._insert_keyframe

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(*a, **kw)
        torch.cuda.synchronize()
        inserts.append((time.perf_counter() - t0) * 1e3)
        return r
    tracker._insert_keyframe = timed
    return inserts


def _ate(tracker, poses, dt):
    """(Sim3 ATE, Sim3 scale, SE3 ATE, extent, n poses) of the tracker's
    camera centres against the ground-truth poses."""
    from morb_slam_tpu_torch import alignment
    traj = tracker.trajectory_world()
    est, gt = [], []
    for ts, p in traj:
        pose = poses[int(round(ts / dt))]
        if pose is None:
            continue
        R, t = pose
        gt.append(-(np.asarray(R, np.float64).T @ t))
        est.append(p)
    est = torch.tensor(np.asarray(est), dtype=torch.float32)
    gt = torch.tensor(np.asarray(gt), dtype=torch.float32)
    rmse, s, _, _ = alignment.ate_rmse(est, gt, with_scale=True)
    rmse_se3, _, _, _ = alignment.ate_rmse(est, gt, with_scale=False)
    return (float(rmse), float(s), float(rmse_se3),
            float(torch.linalg.norm(gt[-1] - gt[0])), len(est))


def _ba_bound(p, per_obs=False):
    """K4's least time for one assembly of this problem. The kernel walks
    the active observations only (masked ones sort past every segment):
    each one's inputs (25 B) and its places in the two sorted orders (8 B)
    are read once, the segment starts (4 B each), poses, points and lm_opt
    once; Hpp, bp, Hll, bl and the cost are written once, and the coupling:
    the dense (L, K, 6, 3) tensor, written whole, or with `per_obs` the
    whole (O, 6, 3) Wpl, a 72-byte block per observation slot, the masked
    slots' zero blocks included (the kernel writes them; it reads every
    slot's mask flag, 1 B, to tell them apart). Per active observation ~120
    flops for its residual, Jacobians and Huber weight (taken in both the
    keyframe and the landmark pass) and per residual row ~114 for its block
    products (Hpp 42, bp 12, coupling 36, Hll 18, bl 6)."""
    from morb_slam_tpu_torch.optim import ba
    O = p.obs_uv.shape[0]
    K, L = p.R.shape[0], p.X.shape[0]
    act = p.obs_mask
    n_obs = int(act.sum())
    n_st = int((act & torch.isfinite(p.obs_ur)).sum())
    coupling = O * (72 + 1) if per_obs else L * K * 72
    nbytes = (n_obs * (25 + 8) + 4 * (K + L + 2) + K * 48 + L * 13
              + K * (144 + 24) + coupling + L * 48 + 4)
    nops = n_obs * 120 + (2 * n_obs + n_st) * 114
    return bound(nbytes, nops), dict(obs=O, active_obs=n_obs, kfs=K,
                                     points=L, ba_assemble_outputs=list(
                                         (ba.ObsBlocks if per_obs else
                                          ba.BlockSums)._fields))


def _path_profile(tracker, step, frames, name, out, inserts,
                  table_path=None):
    """Profile `frames` more frames, each in its own trace, and keep the
    frames in whose step no keyframe was inserted (`inserts` grows in
    each insert): CUDA kernels, device ms (all, and in the hand-written
    kernels), busy share, implicit host syncs and their sites per kept
    frame. The op table of the last kept frame goes to table_path if given.
    Returns {kernel name: (count, device us)} summed over the kept frames."""
    import warnings
    ours = tuple(f"{k}_kernel" for k in _kernel_counters()) + (
        "schur_lm_kernel", "schur_kf_kernel", "pyramid_level_kernel",
        "blur_levels_kernel", "fast_cells_kernel", "fast_level_kernel",
        "hamming_top2_gated_kernel", "vi_terms_kernel") + K16_K18_KERNELS
    n_kern, dev_us, ours_us, wall, nf, skipped = 0, 0.0, 0.0, 0.0, 0, []
    kern = collections.Counter(), collections.Counter()
    in_range = collections.Counter(), collections.Counter()
    sync_sites = collections.Counter()
    n_sync = 0
    for i in frames:
        n_ins = len(inserts)
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as syncs, \
                profiled(cpu=True) as prof:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode(0)
        if len(inserts) > n_ins:
            skipped.append(i)
            continue
        nf += 1
        wall += t1 - t0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA and \
                    ev.key not in RANGES:
                n_kern += ev.count
                dev_us += ev.self_device_time_total
                kern[0][ev.key] += ev.count
                kern[1][ev.key] += ev.self_device_time_total
                if any(k in ev.key for k in ours):
                    ours_us += ev.self_device_time_total
        for k, (c, us) in _range_kernels(prof, "lm_obs_count").items():
            in_range[0][k] += c
            in_range[1][k] += us
        syncs = [w for w in syncs if "synchroniz" in str(w.message)]
        n_sync += len(syncs)
        sync_sites.update(
            "/".join(os.path.normpath(w.filename).split(os.sep)[-2:])
            + f":{w.lineno}" for w in syncs)
        if table_path:
            os.makedirs(os.path.dirname(table_path) or ".", exist_ok=True)
            with open(table_path, "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_device_time_total", row_limit=60))
    tracker.flush()
    torch.cuda.synchronize()
    check(nf > 0, f"{name}: every profiled frame inserted a keyframe")
    out["profiled_frames"] = nf
    out["profiled_frames_skipped_for_insert"] = skipped
    out["cuda_kernels_per_frame_profiler"] = n_kern / nf
    out["device_ms_per_frame_profiler"] = dev_us / nf / 1e3
    out["hand_kernels_device_ms_per_frame_profiler"] = ours_us / nf / 1e3
    out["device_busy_share_profiler"] = dev_us / 1e6 / wall
    # device time per frame over the unprofiled frame time of frames 20..
    out["device_busy_share_unprofiled"] = dev_us / nf / 1e6 * out["fps"]
    out["host_syncs_per_frame"] = n_sync / nf
    out["host_sync_sites"] = dict(sync_sites.most_common(10))
    # the kernels launched inside mapstate.state.lm_obs_count's range
    out["lm_obs_count_kernels_per_frame"] = {
        k: dict(count=in_range[0][k] / nf, device_us=in_range[1][k] / nf)
        for k in in_range[0]}
    log(f"{name} profiler, {nf} frames without a keyframe insert (skipped "
        f"{skipped}): {n_kern / nf:.0f} CUDA kernels, "
        f"{dev_us / nf / 1e3:.2f} ms device time ({ours_us / nf / 1e3:.3f} "
        f"ms in the hand-written kernels) and {n_sync / nf:.1f} host "
        f"syncs per frame; device busy {dev_us / 1e6 / wall:.3f} of the "
        f"profiled step time; sync sites {out['host_sync_sites']}")
    return {k: (kern[0][k], kern[1][k]) for k in kern[0]}


def _range_kernels(prof, name):
    """{kernel: (count, device us)} of the CUDA kernels that torch ops
    launched inside every CPU range `name` of a profile (a ctypes launch
    has no op to tie it to its range)."""
    out = {}

    def walk(ev):
        for k in ev.kernels:
            if k.name not in RANGES:
                c, us = out.get(k.name, (0, 0.0))
                out[k.name] = (c + 1, us + k.duration)
        for ch in ev.cpu_children:
            walk(ch)
    for ev in prof.events():
        if ev.name == name and ev.device_type == \
                torch.autograd.DeviceType.CPU:
            walk(ev)
    return out


class _GatedCalls:
    """Keep the arguments of the last K3 gated call of each mode during a
    path's run (references only: the searches build fresh tensors each
    frame)."""

    def __enter__(self):
        from morb_slam_tpu_torch.ops import hamming
        self.mod, self.saved, self.last = hamming, \
            hamming.hamming_top2_gated, {}

        def wrap(*a, **kw):
            self.last[a[9] if len(a) > 9 else kw["mode"]] = (a, kw)
            return self.saved(*a, **kw)
        hamming.hamming_top2_gated = wrap
        return self

    def __exit__(self, *exc):
        self.mod.hamming_top2_gated = self.saved


def _k3_path_searches(state, gated):
    """K3's gated mode on the inputs of the stereo path's last call of each
    search (search_last_frame's window with NaN projections,
    search_by_projection's window, row_search's band): bitwise equal to
    plain, timed against the dense gate + masked K3; the kernels row takes
    its numbers from search_by_projection's 4096-row search."""
    names = {"window_nan": "search_last_frame", "window":
             "search_by_projection", "row_band": "stereo.row_search"}
    res = {}
    for mode, (a, kw) in sorted(gated.last.items()):
        args = a[:9]
        res[names[mode]] = _k3_gated_numbers(
            args, mode, a[10] if len(a) > 10 else kw.get("max_d", 0.0),
            time_plain=mode == "window")
    check(len(res) == 3, ("K3 gated modes on the stereo path", sorted(res)))
    row = next(r for r in state.get("kernel_rows", [])
               if r["name"] == "hamming_top2") if "kernel_rows" in state \
        else None
    if row is not None:
        p = res["search_by_projection"]
        row.update(ms=p["ms"], call_ms=p["call_ms"], plain_ms=p["plain_ms"],
                   bound_ms=p["bound_ms"], bound_by=p["bound_by"],
                   before_ms=p["before_ms"],
                   before_call_ms=p["before_call_ms"],
                   ms_is="the gated mode (window), one launch on the stereo "
                         "path's last search_by_projection inputs",
                   shape=p["shape"], stereo_path_searches=res)
    return res


def phase_stereo(state):
    from morb_slam_tpu_torch import system
    _, poses = _world(state)
    rig = _rig(state)
    pairs = [_raw_pair(state, *poses[i]) for i in range(N_FRAMES + 5)]
    torch.cuda.synchronize()
    dt = 0.05
    sysm = system.System(rig["settings"], system.Sensor.STEREO,
                         tracker_overrides=dict(max_kf=256, max_lm=16384))
    tracker = sysm.tracker
    log(f"stereo System: rectified focal {tracker.cfg.focal:.3f}, baseline "
        f"{tracker.cfg.baseline:.6f} m, th_depth {tracker.cfg.th_depth}")
    inserts = _timed_inserts(tracker)

    def feed(i, ts):
        return sysm.track_stereo(pairs[i][0], pairs[i][1], ts)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    from morb_slam_tpu_torch.ops import stereo
    with _CountCalls() as calls, _GatedCalls() as gated, \
            _CountCalls([(stereo, "match_stereo")]) as mcalls:
        states, fm, secs, _ = _track_run(tracker, feed, N_FRAMES, dt,
                                         inserts)
    launches = _read_counters(["fast_select", "orb_describe", "hamming_top2",
                               "pose_opt", "stereo_sad", "remap_bilinear",
                               "ba_assemble", "pyramid_blur"], "stereo",
                              state)
    check(launches["stereo_sad"] == mcalls.counts["match_stereo"],
          ("K7 once per match_stereo", launches["stereo_sad"],
           mcalls.counts["match_stereo"]))
    check(launches["remap_bilinear"] == N_FRAMES,
          ("K8 once per pair", launches["remap_bilinear"]))
    check(launches["stereo_sad"] >= N_FRAMES,
          ("K7 on every frame", launches["stereo_sad"]))
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    n_ok = sum(s == "OK" for s in states)
    ate, scale, ate_se3, extent, n_traj = _ate(tracker, poses, dt)
    log(f"stereo trajectory: {n_traj} poses, SE3 ATE {ate_se3:.4f} m "
        f"(gate {0.03 * extent:.4f}), Sim3 ATE {ate:.4f} m, scale "
        f"{scale:.4f}, over {extent:.3f} m")
    check(states[0] == "OK", "stereo did not initialize on frame 0")
    check(n_ok >= 0.9 * N_FRAMES, f"stereo: only {n_ok} of {N_FRAMES} OK")
    check(abs(scale - 1.0) < 0.05, ("stereo scale", scale))
    check(ate_se3 < 0.03 * extent, ("stereo SE3 ATE", ate_se3, extent))
    n_ins = len(inserts)
    out = dict(
        fps=(N_FRAMES - 20) / secs,
        frame_ms_p50=float(np.percentile(fm, 50)),
        frame_ms_p90=float(np.percentile(fm, 90)),
        frames_ok=n_ok, kf_inserts=n_ins,
        kf_insert_ms_each=float(np.mean(inserts)) if inserts else None,
        ate_se3_m=ate_se3, ate_sim3_m=ate, sim3_scale=scale,
        extent_m=extent, landmarks=int(tracker.m.lm_valid.sum()),
        peak_device_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_frame={k: v / N_FRAMES for k, v in launches.items()},
        local_ba_per_frame=calls.counts["ba_solve"] / N_FRAMES)
    log(f"stereo: K2 {launches['orb_describe'] / N_FRAMES:.2f} launches per "
        f"frame")

    table = state.get("profile_out")
    kern = _path_profile(tracker, lambda i: feed(i, i * dt),
                         range(N_FRAMES, N_FRAMES + 5), "stereo", out,
                         inserts,
                         table and table.replace(".txt", "") + "_stereo.txt")
    # K5 on the path: the kernel's own device time per launch (the
    # profiler does not tie a ctypes launch to the CPU side of its range)
    # (the launch counts above show that it ran)
    k5 = [v for k, v in kern.items() if "pose_opt_kernel" in k]
    out["pose_opt_on_path"] = dict(
        device_ms_per_call=k5[0][1] / k5[0][0] / 1e3,
        calls_profiled=k5[0][0]) if k5 and k5[0][0] else None
    out["k3_gated_searches"] = {
        k: {f: v[f] for f in ("shape", "rows_flagged", "pairs_passed",
                              "bitwise_equal", "ms", "before_ms")}
        for k, v in _k3_path_searches(state, gated).items()}
    # one match_stereo on the path's last pair: K3, its 4 torch ops, K7
    a, kw = mcalls.last_args["match_stereo"]
    match = lambda: stereo.match_stereo(*a, **kw)    # noqa: E731
    out["match_stereo"] = dict(
        calls_per_frame=mcalls.counts["match_stereo"] / N_FRAMES,
        kernels_per_call=kernels_per_call(match),
        device_ms_per_call=device_ms(match, None),
        call_ms=time_ms(match))
    log("stereo path:", json.dumps(out))
    state["stereo"] = out

    check("ba_solve" in calls.last_args, "no local BA ran on the stereo path")
    _k4_kernel(state, calls.last_args["ba_solve"][0][0],
               out["launches_per_frame"]["ba_assemble"])


def _log_plain_rows(rows):
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms device per call over a "
            f"{r['span_ms']:.3f} ms span, bound "
            f"{r['bound_ms']:.6f} ms by {r['bound_by']}, "
            f"{r['launches_per_frame']:.2f} calls per frame")


def _k4_kernel(state, p, per_frame):
    """K4 on a local BA problem of the stereo path: the blocks in both
    tangent modes within 1e-4 of the plain assembly relative to each block
    tensor's max-abs, two launches bitwise equal, and the LM loop over K4
    against the loop over the plain assembly: the same accept sequence, R
    within 1e-5, t within 1e-4, the final cost within 1e-3 relative, and
    the landmarks within 1e-2 chi2 units (dX^T Hll dX at the plain
    solution).
    A landmark seen once, or from nearby keyframes, is barely constrained
    in depth: float32 rounding of its blocks moves it by ~1e-3 m, and
    moves the plain loop as far when its sums run in float64 (PERF.md)."""
    from morb_slam_tpu_torch.optim import ba
    from morb_slam_tpu_torch.pipeline import local_mapping
    order = ba.obs_order(p)
    err = 0.0
    for body in (False, True):
        got = ba.assemble(p, p.R, p.t, p.X, order, body=body)
        want = ba.assemble_plain(p, p.R, p.t, p.X, body=body)
        rel = {}
        for name, a, b in zip(ba.BlockSums._fields, got, want):
            rel[name] = float((a - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
        again = ba.assemble(p, p.R, p.t, p.X, order, body=body)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"K4 ba_assemble ({'body' if body else 'camera'} tangent): "
            f"blocks within {max(rel.values()):.2e} of plain relative to "
            f"their max-abs ({', '.join(f'{k} {v:.1e}' for k, v in rel.items())}"
            f"); two launches bitwise equal: {same}")
        check(max(rel.values()) <= 1e-4 and same, ("K4 blocks", body, rel,
                                                   same))
        err = max(err, max(rel.values()))
    n_it = local_mapping.BA_ITERS
    got = ba.ba_solve(p, n_iters=n_it)
    orig = ba.assemble
    ba.assemble = lambda p_, R, t, X, order=None, body=False: \
        ba.assemble_plain(p_, R, t, X, body)
    try:
        want = ba.ba_solve(p, n_iters=n_it)
        plain_solve_ms = device_ms(lambda: ba.ba_solve(p, n_iters=n_it), None,
                                   reps=3)
    finally:
        ba.assemble = orig
    Hll = ba.assemble_plain(p, *want[:3]).Hll

    def diffs(sol):
        dX = sol[2] - want[2]
        return (float((sol[0] - want[0]).abs().max()),
                float((sol[1] - want[1]).abs().max()),
                float(dX.abs().max()),
                float(torch.einsum('li,lij,lj->l', dX, Hll, dX).max()),
                float((sol[3]["costs"][-1] - want[3]["costs"][-1]).abs()
                      / want[3]["costs"][-1].abs()))
    e_R, e_t, e_X, e_Xh, e_c = diffs(got)
    acc_g, acc_w = got[3]["accepted"].tolist(), want[3]["accepted"].tolist()
    log(f"K4 ba_solve ({n_it} LM iterations over K4 vs the plain assembly): "
        f"R within {e_R:.2e}, t within {e_t:.2e}, X within {e_X:.2e} m and "
        f"{e_Xh:.2e} chi2 units, final cost within {e_c:.2e} relative, accepts "
        f"{acc_g} vs {acc_w}")
    check(e_R <= 1e-5 and e_t <= 1e-4 and e_Xh <= 1e-2 and e_c <= 1e-3
          and acc_g == acc_w, ("K4 ba_solve", e_R, e_t, e_X, e_Xh, e_c,
                               acc_g, acc_w))
    (b4, by4), shape = _ba_bound(p)
    call = lambda: ba.assemble(p, p.R, p.t, p.X, order)
    state.setdefault("kernel_rows", []).append(dict(
        name="ba_assemble", route="cuda",
        source="morb_slam_tpu_torch/csrc/ba_assemble.cu",
        replaces="morb_slam_tpu/optim/ba.py:125", max_abs_err=err,
        max_abs_err_is="relative to each block tensor's max-abs",
        ms=device_ms(call, "ba_assemble_kernel"), call_ms=time_ms(call),
        plain_ms=time_ms(lambda: ba.assemble_plain(p, p.R, p.t, p.X),
                         reps=5, inner=2),
        bound_ms=b4, bound_by=by4, library_ms=None,
        kernels_per_call=kernels_per_call(call), ptxas=_ptxas("ba_assemble"),
        ba_solve_device_ms=device_ms(lambda: ba.ba_solve(p, n_iters=n_it),
                                     None, reps=3),
        ba_solve_plain_assembly_device_ms=plain_solve_ms,
        ba_solve_vs_plain=dict(R=e_R, t=e_t, X_m=e_X, X_chi2=e_Xh,
                               cost_rel=e_c),
        ba_solve_ms=time_ms(lambda: ba.ba_solve(p, n_iters=n_it), reps=3,
                            inner=2),
        stereo_launches_per_frame=per_frame,
        shape=f"one local BA problem of the stereo path, {shape}"))


def phase_rgbd(state):
    from morb_slam_tpu_torch import system
    from morb_slam_tpu_torch.io import config
    world, poses = _world(state)
    fx, fy, cx, cy = TUM_K
    Kmat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    pix = pixel_grid(TUM_W, TUM_H, DEV)
    frames = []
    for i in range(N_RGBD):
        img, depth = world.render_points(*poses[i], pix, Kmat,
                                         (TUM_H, TUM_W))
        frames.append((img.clamp(0, 255).to(torch.uint8), depth))
    torch.cuda.synchronize()
    settings = config.Settings(
        sensor="rgbd", cam1=config.CameraSettings(
            model="PinHole", fx=fx, fy=fy, cx=cx, cy=cy, width=TUM_W,
            height=TUM_H), baseline=TUM_BF / fx, bf=TUM_BF, n_features=1000,
        n_levels=8, scale_factor=1.2)
    dt = 1 / 30
    sysm = system.System(settings, system.Sensor.RGBD,
                         tracker_overrides=dict(max_kf=256, max_lm=16384))
    inserts = _timed_inserts(sysm.tracker)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    states, fm, secs, _ = _track_run(
        sysm.tracker,
        lambda i, ts: sysm.track_rgbd(frames[i][0], frames[i][1], ts),
        N_RGBD, dt, inserts)
    launches = _read_counters(["fast_select", "orb_describe",
                               "hamming_top2", "pose_opt", "ba_assemble",
                               "pyramid_blur"], "rgbd", state)
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    n_ok = sum(s == "OK" for s in states)
    ate, scale, ate_se3, extent, n_traj = _ate(sysm.tracker, poses, dt)
    log(f"rgbd trajectory: {n_traj} poses, Sim3 ATE {ate:.4f} m, scale "
        f"{scale:.4f}, SE3 ATE {ate_se3:.4f} m, over {extent:.3f} m")
    check(states[0] == "OK", "rgbd did not initialize on frame 0")
    check(n_ok > 0.85 * N_RGBD, f"rgbd: only {n_ok} of {N_RGBD} OK")
    check(abs(scale - 1.0) < 0.05, ("rgbd scale", scale))
    out = dict(
        fps=(N_RGBD - 20) / secs,
        frame_ms_p50=float(np.percentile(fm, 50)),
        frame_ms_p90=float(np.percentile(fm, 90)),
        frames_ok=n_ok, kf_inserts=len(inserts),
        kf_insert_ms_each=float(np.mean(inserts)) if inserts else None,
        ate_sim3_m=ate, sim3_scale=scale, ate_se3_m=ate_se3,
        extent_m=extent,
        peak_device_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_frame={k: v / N_RGBD for k, v in launches.items()})
    log("rgbd path:", json.dumps(out))
    state["rgbd"] = out


def phase_reloc(state):
    import tempfile
    import warnings
    from morb_slam_tpu_torch import system
    from morb_slam_tpu_torch.io import config, serialization
    from morb_slam_tpu_torch.pipeline import tracking
    world, poses = _world(state)
    voc = _vocabulary(state)
    seq = list(poses[:N_MAP]) + [None] * N_BLANK + [poses[i] for i in REVISIT]
    blank = torch.zeros((H, W), dtype=torch.uint8, device=DEV)
    frames = [world.render(*p).clamp(0, 255).to(torch.uint8)
              if p is not None else blank for p in seq]
    torch.cuda.synchronize()
    settings = config.Settings(
        cam1=config.CameraSettings(model="PinHole", fx=FX, fy=FX, cx=W / 2,
                                   cy=H / 2, width=W, height=H),
        n_features=1200, n_levels=8, scale_factor=1.2, loop_closing=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "voc.npz")
        serialization.save_vocabulary(path, voc)
        sysm = system.System(settings, system.Sensor.MONOCULAR,
                             vocabulary_path=path,
                             tracker_overrides=dict(
                                 max_kf=256, max_lm=16384,
                                 min_init_matches=80, min_init_points=50))
    tracker = sysm.tracker
    check(tracker.db is not None and tracker.loop_closer is None,
          "the System built no keyframe database")
    inserts = _timed_inserts(tracker)

    # every relocalization attempt: frame, outcome, wall time, host syncs
    # and their sites, the BoW candidates
    attempts, cands = [], []
    cur = {"i": -1}
    orig_try = tracker._try_relocalize
    orig_top = tracking.kfdb.top_candidates

    def top_candidates(*a, **kw):
        out = orig_top(*a, **kw)
        cands.append((cur["i"], out[0], out[1]))
        return out

    def try_reloc(fr):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            ok = orig_try(fr)
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        syncs = [w for w in ws if "synchroniz" in str(w.message)]
        rec = dict(frame=cur["i"], ok=ok, ms=ms, syncs=len(syncs),
                   sites=collections.Counter(
                       "/".join(os.path.normpath(w.filename).split(os.sep)
                                [-2:]) + f":{w.lineno}" for w in syncs))
        if ok:
            rec.update(inliers=tracker._ref_matches, ref_kf=tracker.ref_kf,
                       R=tracker.R_last.cpu().numpy(),
                       t=tracker.t_last.cpu().numpy())
        attempts.append(rec)
        return ok
    tracker._try_relocalize = try_reloc
    tracking.kfdb.top_candidates = top_candidates
    _reset_counters()
    try:
        states, fm, secs, _ = _track_run(
            tracker, lambda i, ts: (cur.__setitem__("i", i),
                                    sysm.track_monocular(frames[i], ts))[1],
            len(frames), 1.0, inserts)
    finally:
        tracking.kfdb.top_candidates = orig_top
    launches = _read_counters(["fast_select", "orb_describe", "hamming_top2",
                               "pose_opt", "vocab_transform", "bow_l1",
                               "ba_assemble", "pyramid_blur"], "reloc",
                              state)
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    n_map = N_MAP + N_BLANK
    check("RECENTLY_LOST" in states[N_MAP:n_map], "never lost in the blank")
    wins = [a for a in attempts if a["ok"] and a["frame"] >= n_map]
    check(wins, ("no BoW relocalization on the revisit",
                 [(a["frame"], a["ok"]) for a in attempts]))
    win = wins[0]
    first_ok = next(i for i in range(n_map, len(states)) if states[i] == "OK")
    check(first_ok == win["frame"],
          ("the revisit recovered before the BoW branch did", first_ok,
           win["frame"]))
    n_ok_after = sum(s == "OK" for s in states[first_ok:])
    check(n_ok_after >= 0.8 * (len(states) - first_ok),
          ("tracking did not hold after relocalizing", states[first_ok:]))
    # the relocalized camera centre against the keyframe mapped nearest
    # that pose (culled ones keep their last pose, as in the JAX test) and
    # against the centre tracked at that pose while mapping (map units;
    # timestamps are frame indices)
    pose_i = REVISIT[win["frame"] - n_map]
    m = tracker.m
    n_kf = tracker.n_kf_host
    kf_ts = m.kf_ts[:n_kf].cpu().numpy()
    k = int(np.argmin(np.where(kf_ts < N_MAP, np.abs(kf_ts - pose_i),
                               np.inf)))
    c_kf = -(m.kf_R[k].T @ m.kf_t[k]).cpu().numpy()
    c_est = -(win["R"].T @ win["t"])
    centre_err = float(np.linalg.norm(c_est - c_kf))
    tracked = dict(tracker.trajectory_world()).get(float(pose_i))
    err_tracked = None if tracked is None else \
        float(np.linalg.norm(c_est - tracked))
    ate, scale, _, _, n_traj = _ate(tracker, seq, 1.0)
    c0 = -(poses[0][0].T @ poses[0][1])
    c1 = -(poses[N_MAP - 1][0].T @ poses[N_MAP - 1][1])
    extent = float(np.linalg.norm(c1 - c0))
    log(f"reloc: BoW relocalization on frame {win['frame']} (pose {pose_i}) "
        f"with {win['inliers']} inliers against keyframe {win['ref_kf']}; "
        f"centre {centre_err:.4f} map units from keyframe {k} (ts "
        f"{kf_ts[k]:.0f}), {err_tracked} from the centre tracked at that "
        f"pose; Sim3 ATE {ate:.4f} m over {n_traj} poses, "
        f"{extent:.3f} m mapped (gate {0.023 * extent:.4f})")
    check(centre_err < 0.15, ("relocalized centre", centre_err))
    check(math.isfinite(ate) and ate < 0.023 * extent, ("reloc ATE", ate))
    won = [(int(i), s) for f, i, s in
           ((f, i, s) for f, ids, sc in cands if f == win["frame"]
            for i, s in zip(ids.tolist(), sc.tolist()))]
    sites = collections.Counter()
    for a in attempts:
        sites.update(a["sites"])
    out = dict(
        reloc_frame=win["frame"], revisited_pose=pose_i,
        candidates=[dict(kf=i, score=s) for i, s in won],
        inliers=win["inliers"], ref_kf=win["ref_kf"],
        centre_err_vs_nearest_kf=centre_err, nearest_kf=k,
        nearest_kf_ts=float(kf_ts[k]),
        nearest_kf_valid=bool(m.kf_valid[k]),
        centre_err_vs_tracked_same_pose=err_tracked,
        ate_sim3_m=ate, sim3_scale=scale, traj_poses=n_traj,
        extent_mapped_m=extent,
        attempts=len(attempts), attempts_ok=sum(a["ok"] for a in attempts),
        attempt_ms_p50=float(np.median([a["ms"] for a in attempts])),
        attempt_ms_success=win["ms"],
        host_syncs_per_attempt=float(np.mean([a["syncs"] for a in attempts])),
        host_sync_sites=dict(sites.most_common(10)),
        launches=launches,
        frames=len(frames), frames_ok=sum(s == "OK" for s in states),
        kf_inserts=len(inserts),
        kf_insert_ms_each=float(np.mean(inserts)) if inserts else None,
        db_keyframes=int(tracker.db.valid.sum()),
        fps=(len(frames) - 20) / secs,
        frame_ms_p50=float(np.percentile(fm, 50)),
        vocabulary=dict(k=VOC_K, depth=VOC_DEPTH, words=voc.n_words,
                        **state["voc_train"]))
    log("reloc path:", json.dumps(out))
    state["reloc"] = out


def _vi_batches(seed, n_all):
    """Each frame's IMU samples since the previous frame, with the noise of
    `seed`, rotated from camera into body axes (a_b = R_bc a_c; zero lever
    arm)."""
    rng = np.random.default_rng(seed)
    R_bc = R_B_C0.astype(np.float32)
    batches = []
    for i in range(n_all):
        ts_i, acc, gyr = imu_between((i - 1) * VI_DT, i * VI_DT, rng=rng,
                                     **_imu_noise())
        batches.append((ts_i, acc @ R_bc.T, gyr @ R_bc.T))
    return batches


def _vi_system(state):
    import dataclasses
    from morb_slam_tpu_torch import system
    from morb_slam_tpu_torch.io import config
    T_b_c1 = np.eye(4)
    T_b_c1[:3, :3] = R_B_C0
    settings = dataclasses.replace(
        _rig(state)["settings"], sensor="stereo-inertial",
        imu=config.ImuSettings(**IMU_NOISE, T_b_c1=T_b_c1))
    return system.System(settings, system.Sensor.IMU_STEREO,
                         tracker_overrides=dict(max_kf=256, max_lm=16384))


def vi_seed_sweep(state, seeds):
    """The vi path's 120 frames once per IMU noise seed (the routine run
    uses seed 7): frames OK, the IMU-init stage reached, SE3 and Sim3 ATE
    and the Sim3 scale of each; no gate, one JSON line."""
    gt = [analytic_pose(i * VI_DT) for i in range(N_VI)]
    pairs = [_raw_pair(state, *p) for p in gt]
    out = []
    for seed in seeds:
        batches = _vi_batches(seed, N_VI)
        sysm = _vi_system(state)
        t0 = time.perf_counter()
        states = [sysm.track_stereo(pairs[i][0], pairs[i][1], i * VI_DT,
                                    imu_batch=batches[i])[0]
                  for i in range(N_VI)]
        tr = sysm.tracker
        tr.flush()
        ate, scale, ate_se3, extent, _ = _ate(tr, gt, VI_DT)
        out.append(dict(seed=seed, frames_ok=sum(s == "OK" for s in states),
                        imu_ready=tr.imu_ready, viba_stage=tr.viba_stage,
                        ate_se3_m=ate_se3, ate_sim3_m=ate, sim3_scale=scale,
                        extent_m=extent, gate_se3_m=0.04 * extent,
                        s=time.perf_counter() - t0))
        log(f"vi seed {seed}:", json.dumps(out[-1]))
    log(json.dumps({"vi_seed_sweep": out}))


def phase_vi(state):
    from morb_slam_tpu_torch.optim import ba, inertial, vi_ba
    from morb_slam_tpu_torch.pipeline import local_mapping
    n_all = N_VI + 5
    t0 = time.perf_counter()
    gt = [analytic_pose(i * VI_DT) for i in range(n_all)]
    pairs = [_raw_pair(state, *p) for p in gt]
    batches = _vi_batches(7, n_all)
    torch.cuda.synchronize()
    log(f"vi: {n_all} raw pairs rendered on the card and "
        f"{sum(len(b[0]) for b in batches)} IMU samples made in "
        f"{time.perf_counter() - t0:.1f} s")
    sysm = _vi_system(state)
    tracker = sysm.tracker
    check(tracker.calib is not None and tracker.cfg.inertial,
          "the System built no IMU calibration")
    inserts = _timed_inserts(tracker)
    stages = _imu_stage_timer(tracker)

    def feed(i, ts):
        return sysm.track_stereo(pairs[i][0], pairs[i][1], ts,
                                 imu_batch=batches[i])
    targets = [(local_mapping, "mapping_step"),
               (local_mapping, "mapping_step_inertial"),
               (local_mapping, "full_inertial_ba"), (vi_ba, "vi_ba_solve"),
               (inertial, "inertial_only_optimize"), (ba, "ba_solve")]
    timed = ("mapping_step", "mapping_step_inertial", "full_inertial_ba",
             "inertial_only_optimize")
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _CountCalls(targets, timed,
                     keep_first=("inertial_only_optimize",)) as calls, \
            _EventCalls(vi_ba, "optimize_pose_inertial") as k12_calls:
        states, fm, secs, _ = _track_run(tracker, feed, N_VI, VI_DT, inserts,
                                         timed_from=VI_TIMED)
    launches = _read_counters(["fast_select", "orb_describe", "hamming_top2",
                               "pose_opt", "stereo_sad", "remap_bilinear",
                               "ba_assemble", "preintegrate",
                               "pose_inertial", "vi_edges", "pyramid_blur",
                               "inertial_init"], "vi", state)
    state["k17_problem"] = calls.first_args["inertial_only_optimize"]
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    fired = [s for s in stages if s["fired"]]
    log(f"vi: IMU-init stages fired {[(s['stage'], s['ts']) for s in fired]}"
        f" of {len(stages)} due attempts; imu_ready {tracker.imu_ready}, "
        f"viba_stage {tracker.viba_stage}")
    n_ok = sum(s == "OK" for s in states)
    ate, scale, ate_se3, extent, n_traj = _ate(tracker, gt, VI_DT)
    log(f"vi trajectory: {n_traj} poses, SE3 ATE {ate_se3:.4f} m (gate "
        f"{0.04 * extent:.4f}; 0.0515 at commit 001dca8), Sim3 ATE "
        f"{ate:.4f} m, scale {scale:.4f}, over {extent:.3f} m")
    k13 = _k13_per_solve("vi", calls, launches["vi_edges"])
    check(n_ok > 0.85 * N_VI, f"vi: only {n_ok} of {N_VI} OK")
    check(tracker.imu_ready and tracker.viba_stage >= 2,
          ("vi: IMU init", tracker.imu_ready, tracker.viba_stage))
    check(abs(scale - 1.0) < 0.06, ("vi scale", scale))
    check(ate_se3 < 0.04 * extent, ("vi SE3 ATE", ate_se3, extent))

    def mean(x):
        return float(np.mean(x)) if x else None
    out = dict(
        fps=(N_VI - VI_TIMED) / secs, timed_frames=[VI_TIMED, N_VI - 1],
        frame_ms_p50=float(np.percentile(fm, 50)),
        frame_ms_p90=float(np.percentile(fm, 90)),
        frames_ok=n_ok, imu_ready=tracker.imu_ready,
        viba_stage=tracker.viba_stage, imu_init_stages=fired,
        imu_init_attempts=len(stages),
        inertial_only_optimize_ms=calls.ms["inertial_only_optimize"],
        full_inertial_ba_ms=calls.ms["full_inertial_ba"],
        kf_inserts=len(inserts), kf_insert_ms_each=mean(inserts),
        mapping_step_visual_ms=calls.ms["mapping_step"],
        mapping_step_inertial_ms=calls.ms["mapping_step_inertial"],
        mapping_step_visual_ms_mean=mean(calls.ms["mapping_step"]),
        mapping_step_inertial_ms_mean=mean(calls.ms["mapping_step_inertial"]),
        local_ba_calls=calls.counts["ba_solve"],
        vi_ba_solve_calls=calls.counts["vi_ba_solve"], **k13,
        ate_se3_m=ate_se3, ate_sim3_m=ate, sim3_scale=scale,
        extent_m=extent, landmarks=int(tracker.m.lm_valid.sum()),
        peak_device_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_frame={k: v / N_VI for k, v in launches.items()},
        pose_inertial_call_ms=k12_calls.summary())
    log(f"vi: K11 {launches['preintegrate'] / N_VI:.2f}, K12 "
        f"{launches['pose_inertial'] / N_VI:.2f} and K2 "
        f"{launches['orb_describe'] / N_VI:.2f} launches per frame; K12 "
        f"call_ms on the path {out['pose_inertial_call_ms']}")
    table = state.get("profile_out")
    kern = _path_profile(tracker, lambda i: feed(i, i * VI_DT),
                         range(N_VI, n_all), "vi", out, inserts,
                         table and table.replace(".txt", "") + "_vi.txt")
    for name in ("pose_inertial", "preintegrate", "ba_assemble"):
        ev = [v for k, v in kern.items() if f"{name}_kernel" in k]
        if ev and ev[0][0]:
            out[f"{name}_on_path"] = dict(
                device_ms_per_call=ev[0][1] / ev[0][0] / 1e3,
                calls_profiled=ev[0][0])
    log("vi path:", json.dumps(out))
    state["vi"] = out
    state["plain_rows"] += _vi_plain_rows(calls, state)
    _log_plain_rows(state["plain_rows"][-1:])


def _k13_per_solve(path, calls, k13):
    """K13 calls on a path against its vi_ba_solve calls: one at the start
    state and one at each candidate, n + 1 for an n-iteration solve."""
    solves = calls.kwargs["vi_ba_solve"]
    want = sum(kw.get("n_iters", 8) + 1 for kw in solves)
    log(f"{path}: {k13} K13 calls over {len(solves)} vi_ba_solve calls "
        f"({k13 / max(len(solves), 1):.2f} a solve; n + 1 a solve makes "
        f"{want})")
    check(k13 == want, (f"{path}: K13 calls", k13, want))
    return dict(k13_calls=k13, k13_calls_per_solve=k13 / max(len(solves), 1),
                k13_calls_n_plus_1=want)


def _vi_plain_rows(calls, state):
    """inertial_only_optimize (K17 inside) on the vi path's last problem:
    device time per call under its profiler range, the event time of the
    call that holds it, the bound from this problem's shape, calls per
    frame. The vi path's last vi_ba_solve problem is kept for K13's row."""
    from morb_slam_tpu_torch.optim import inertial
    check(calls.counts["vi_ba_solve"] and
          calls.counts["inertial_only_optimize"],
          "no inertial BA or IMU initialization on the vi path")
    (pv,), kw = calls.last_args["vi_ba_solve"]
    state["k13_problem"] = (pv, kw)
    a, kw_io = calls.last_args["inertial_only_optimize"]

    held = {}

    def io_profile():
        with profiled(cpu=True) as prof:
            inertial.inertial_only_optimize(*a, **kw_io)
        held["prof"] = prof
        return prof
    io_ms, _, io_span = range_device_ms("inertial_only_optimize", io_profile)
    # where the device time goes: the torch ops' kernels under the range
    # (ms per optimize, the largest first) and K17's systems (ctypes
    # launches, tied to no op): each from its edge kernel's start to its
    # assembly kernel's end, since the assembly's device time holds its
    # wait on the edges (programmatic dependent launch)
    by_kernel = sorted(((k, c, us / 1e3) for k, (c, us) in _range_kernels(
        held["prof"], "inertial_only_optimize").items()),
        key=lambda r: -r[2])
    k17_spans = kernel_spans(held["prof"], "init_edge_kernel",
                             "init_assemble_kernel")
    ki, kf_valid = a[0], a[3]
    prev = torch.clamp(ki.prev, min=0).long()
    n_e = int((ki.valid & kf_valid & kf_valid[prev]).sum())
    n_par = 9 + 3 * (n_e + 1)
    it = kw_io.get("n_iters", 30)
    K = ki.valid.shape[0]
    # the preintegration store (~162 floats per keyframe slot) and the
    # poses in; per iteration and used edge ~60 flops per residual row and
    # tangent, the normal equations over the used parameters and their
    # solve
    b_io, by_io = bound(K * (162 + 12) * 4,
                        it * (n_par * n_e * 9 * 60 + n_e * 9 * n_par ** 2 * 2
                              + n_par ** 3 / 3))
    return [
        dict(name="inertial_only_optimize", route="cuda (K17 inside)",
             source="morb_slam_tpu_torch/optim/inertial.py",
             replaces="morb_slam_tpu/optim/inertial.py:304", ms=io_ms,
             span_ms=io_span, k17_span_ms=sum(k17_spans),
             k17_systems=len(k17_spans),
             device_ms_by_kernel=[dict(kernel=k[:80], launches=c, ms=ms)
                                  for k, c, ms in by_kernel[:8]],
             plain_ms=time_ms(lambda: inertial.inertial_only_optimize(
                 *a, **kw_io), reps=2, inner=1, warmup=1),
             bound_ms=b_io, bound_by=by_io, library_ms=None,
             launches=calls.counts["inertial_only_optimize"],
             launches_per_frame=calls.counts["inertial_only_optimize"]
             / N_VI, max_abs_err=None,
             shape=f"{K} keyframe slots, {n_e} edges used, {it} "
                   f"iterations")]


# ---------------------------------------------------------------------------
# loop closing, Atlas merge and the detached global BA
# ---------------------------------------------------------------------------

# System's default capacities (tracking.TrackerConfig)
LOOP_K, LOOP_F, LOOP_L = 512, 1200, 32768
# the tests' ring orbit: 1.3 circuits per 300 frames; run to 1.5 circuits
# (346 frames): at the rig's 79-degree field of view tracking re-finds the
# first keyframes' landmarks from ~frame 215, which hides the loop from the
# BoW query until late: 300 frames end before either package closes it
# reliably (PERF.md)
N_LOOP, LOOP_DT, LOOP_PERIOD = 346, 0.05, 300 / 1.3
LOOP_VOC_K, LOOP_VOC_DEPTH = 8, 3
# the bench's multi_session_merge_run: 28 frames out, 27 back
MERGE_W, MERGE_H, MERGE_FX, MERGE_OUT = 384, 288, 300.0, 28


def _global_problem(seed=0, n_valid_kf=120, n_valid_lm=20000, per_kf=700,
                    stereo_share=0.3):
    """A global BA problem at the loop phase's capacities, laid out as
    `global_ba._build_global_problem` lays out a map: K = 512 keyframe
    slots of 1200 feature slots (120 keyframes valid, keyframe 0 fixed),
    L = 32,768 landmark slots (20,000 valid); each valid keyframe observes
    700 landmarks of a window that slides along the path, 30% of them in
    stereo, 2 px noise."""
    from morb_slam_tpu_torch import lie
    from morb_slam_tpu_torch.optim import ba
    rng = np.random.default_rng(seed)
    K, F, L = LOOP_K, LOOP_F, LOOP_L
    X = np.zeros((L, 3))
    X[:n_valid_lm] = np.stack([rng.uniform(-4, 4, n_valid_lm),
                               rng.uniform(-2, 2, n_valid_lm),
                               rng.uniform(3, 9, n_valid_lm)], -1)
    R = np.tile(np.eye(3), (K, 1, 1))
    t = np.zeros((K, 3))
    R[:n_valid_kf] = lie.so3_exp(torch.tensor(rng.normal(
        0, 0.03, (n_valid_kf, 3)), dtype=torch.float32)).numpy()
    t[:n_valid_kf] = rng.normal(0, 0.1, (n_valid_kf, 3))
    obs_lm = np.zeros((K, F), np.int64)
    mask = np.zeros((K, F), bool)
    win = 3000
    for k in range(n_valid_kf):
        lo = int((n_valid_lm - win) * k / max(n_valid_kf - 1, 1))
        obs_lm[k, :per_kf] = lo + rng.choice(win, per_kf, replace=False)
        mask[k, :per_kf] = True
    kf = np.repeat(np.arange(K), F)
    lm = obs_lm.reshape(-1)
    Xc = np.einsum('oij,oj->oi', R[kf], X[lm]) + t[kf]
    z = np.where(np.abs(Xc[:, 2]) < 1e-6, 1.0, Xc[:, 2])
    uv = Xc[:, :2] / z[:, None] + rng.normal(0, 2.0 / FX, (K * F, 2))
    ur = np.where(rng.random(K * F) < stereo_share,
                  (Xc[:, 0] - 0.11) / z, np.nan)
    dev = DEV
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev)
    i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                  device=dev)
    b = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.bool, device=dev)
    kf_valid = np.arange(K) < n_valid_kf
    return ba.make_problem(
        R=f(R), t=f(t), X=f(X), obs_kf=i(kf), obs_lm=i(lm), obs_uv=f(uv),
        obs_info=f(FX ** 2 * 1.2 ** (-2.0 * rng.integers(0, 8, K * F))),
        obs_mask=b(mask.reshape(-1)), kf_opt=b(kf_valid & (np.arange(K) > 0)),
        lm_opt=b(np.arange(L) < n_valid_lm), obs_ur=f(ur), baseline=0.11)


def _schur_bound(p):
    """K14's least time for one S x: every active observation's 72-byte
    block and its keyframe and landmark ids (8 B) read once, Hpp, Hll^-1,
    x and the flags read once, S x written once (y is internal; the sorted
    orders and their segment starts are the kernel's own layout, which the
    function does not need); 36 flops per observation and pass, 15 per
    landmark, 72 per keyframe."""
    K, L = p.R.shape[0], p.X.shape[0]
    n_obs = int(p.obs_mask.sum())
    nbytes = n_obs * (72 + 8) + K * (144 + 24 + 1) + L * (36 + 1) + K * 24
    return bound(nbytes, n_obs * 72 + L * 15 + K * 72), n_obs


def _pcg_bound(p, iters):
    """K14's least time for one whole solve: the inputs read once (every
    active observation's block and ids as in `_schur_bound`, Hpp, Minv, bp
    and kf_opt a keyframe, Hll^-1, bl and lm_opt a landmark), dxp and dxl
    written once; per CG iteration S x (72 flops an observation, 15 a
    landmark, 72 a keyframe) and ~132 flops a keyframe of vector work (two
    dot products, the x, r and p updates, Minv r), the right-hand side and
    the back-substitution one pass each."""
    K, L = p.R.shape[0], p.X.shape[0]
    n_obs = int(p.obs_mask.sum())
    nbytes = n_obs * (72 + 8) + K * (144 + 144 + 24 + 1) \
        + L * (36 + 12 + 1) + K * 24 + L * 12
    ops = iters * (n_obs * 72 + L * 15 + K * (72 + 132)) \
        + 2 * (n_obs * 36 + L * 15) + K * 72
    return bound(nbytes, ops)


def _pcg_check(args, cg_iters, where):
    """K14's solve against pcg_solve_plain on the same inputs: dxp and dxl
    within testing.PCG_TOL of the plain result's max-abs after cg_iters
    iterations and within testing.PCG_TOL_FIRST after 0, 1 and 2 (before CG
    has converged onto the same answer whatever its alpha, beta and
    preconditioner); bitwise equal on two launches and at a grid of 7
    blocks. Returns the relative errors after cg_iters iterations and
    after the first ones."""
    from morb_slam_tpu_torch import testing
    from morb_slam_tpu_torch.optim import ba

    def rel_of(n_it):
        got = ba.pcg_solve(*args, n_it)
        want = ba.pcg_solve_plain(*args, n_it)
        return got, {n: float((a - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)
            for n, a, b in zip(("dxp", "dxl"), got, want)}
    got, rel = rel_of(cg_iters)
    first = {n_it: rel_of(n_it)[1] for n_it in (0, 1, 2)}
    again = ba.pcg_solve(*args, cg_iters)
    small = ba._pcg_launch(*args, cg_iters, grid=7)
    same = all(torch.equal(a, b) for a, b in zip(got, again)) and \
        all(torch.equal(a, b) for a, b in zip(got, small))
    first_max = max(max(r.values()) for r in first.values())
    log(f"K14 schur_pcg solve ({where}, {cg_iters} CG iterations): dxp "
        f"within {rel['dxp']:.2e}, dxl within {rel['dxl']:.2e} of the plain "
        f"solve's max-abs (tolerance {testing.PCG_TOL}); after 0 / 1 / 2 "
        f"iterations {' / '.join(f'{max(r.values()):.2e}' for r in first.values())} "
        f"(tolerance {testing.PCG_TOL_FIRST}); bitwise equal on two "
        f"launches and at 7 blocks: {same}")
    check(max(rel.values()) <= testing.PCG_TOL and
          first_max <= testing.PCG_TOL_FIRST and same,
          ("K14 solve vs plain", where, rel, first, same))
    return rel, first


def _gba_kernels(rows):
    """K4's per-observation mode and K14 against their plain versions at
    the loop phase's capacities: max relative errors, two launches bitwise
    equal, times and bounds."""
    from morb_slam_tpu_torch.optim import ba
    t0 = time.perf_counter()
    p = _global_problem()
    order = ba.obs_order(p)
    got = ba.assemble(p, p.R, p.t, p.X, order, per_obs=True)
    want = ba.assemble_obs_plain(p, p.R, p.t, p.X)
    rel = {}
    for name, a, b in zip(ba.ObsBlocks._fields, got, want):
        rel[name] = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
    again = ba.assemble(p, p.R, p.t, p.X, order, per_obs=True)
    same4 = all(torch.equal(a, b) for a, b in zip(got, again))
    masked_zero = not bool(got.Wpl[~p.obs_mask].any())
    n_obs = int(p.obs_mask.sum())
    log(f"K4 per-observation mode ({n_obs} of {p.obs_mask.numel()} "
        f"observations active): blocks within {max(rel.values()):.2e} of "
        f"plain relative to their max-abs ({', '.join(f'{k} {v:.1e}' for k, v in rel.items())}); "
        f"Wpl against _obs_terms' Jp^T w Jl {rel['Wpl']:.2e}; two launches "
        f"bitwise equal: {same4}; masked slots' blocks zero: {masked_zero}")
    check(max(rel.values()) <= 1e-4 and same4 and masked_zero,
          ("K4 per-obs", rel, same4, masked_zero))
    args = ba.pcg_args(p, want, torch.tensor(1e-3, device=DEV), order)
    _, _, Hpp, _, Hll_inv, _, bl, _ = args
    x = torch.randn(p.R.shape[0], 6, device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(3))
    y0 = torch.einsum('lab,lb->la', Hll_inv, bl)
    W, Wa, xa, Ha = want.Wpl, want.Wpl.abs(), x.abs(), Hll_inv.abs()
    ya = ba.schur_lm_pass_plain(p, Wa, xa, Ha)
    kf = p.kf_opt.float()[:, None]
    # (kernel, plain, the magnitude of each entry's summed terms: the
    # same sums over absolute values; the back-substitution's
    # bl - B^T x cancels, so its rounding is bounded by the terms, which
    # -|x| makes it add)
    uses = {
        "S x": (lambda: ba.schur_matvec(p, W, Hpp, Hll_inv, x, order),
                lambda: ba.schur_kf_pass_plain(
                    p, W, ba.schur_lm_pass_plain(p, W, x, Hll_inv),
                    Hpp=Hpp, x=x),
                -ba.schur_kf_pass_plain(p, Wa, ya, a=-torch.einsum(
                    'kab,kb->ka', Hpp.abs(), xa * kf))),
        "rhs": (lambda: ba.schur_kf_pass(p, W, y0, order, a=want.bp),
                lambda: ba.schur_kf_pass_plain(p, W, y0, a=want.bp),
                -ba.schur_kf_pass_plain(p, Wa, y0.abs(),
                                        a=-want.bp.abs())),
        "back-substitution": (
            lambda: ba.schur_lm_pass(p, W, x, Hll_inv, order, c=bl),
            lambda: ba.schur_lm_pass_plain(p, W, x, Hll_inv, c=bl),
            ba.schur_lm_pass_plain(p, Wa, -xa, Ha, c=bl.abs()))}
    err14, same14 = {}, True
    for use, (kern, plain, mag) in uses.items():
        a, b = kern(), plain()
        err14[use] = float(((a - b).abs() / mag.clamp(min=1e-30)).max())
        same14 &= torch.equal(a, kern())
    log(f"K14 schur_pcg: within {max(err14.values()):.2e} of plain relative "
        f"to each entry's term magnitude ({', '.join(f'{k} {v:.1e}' for k, v in err14.items())}); "
        f"two launches bitwise equal: {same14}")
    check(max(err14.values()) <= 1e-5 and same14, ("K14", err14, same14))
    (b14, by14), _ = _schur_bound(p)
    matvec = uses["S x"][0]
    ms14 = device_ms(matvec, "schur_lm_kernel") + \
        device_ms(matvec, "schur_kf_kernel")
    rel_s, first_s = _pcg_check(args, 40, "the loop phase's capacities")

    def solve():
        return ba.pcg_solve(*args, 40)
    b_s, by_s = _pcg_bound(p, 40)
    rows.append(dict(
        name="schur_pcg", route="cuda",
        source="morb_slam_tpu_torch/csrc/schur_pcg.cu",
        replaces="morb_slam_tpu/optim/ba.py:373", max_abs_err=max(
            rel_s.values()),
        max_abs_err_is="the solve's dxp and dxl, relative to the plain "
                       "solve's max-abs",
        first_iters_max_abs_err={n: max(r.values())
                                 for n, r in first_s.items()},
        first_iters_max_abs_err_is="the same after 0, 1 and 2 CG "
                                   "iterations",
        passes_max_abs_err=max(err14.values()),
        passes_max_abs_err_is="relative to each output entry's term "
                              "magnitude (S x, the right-hand side, the "
                              "back-substitution)",
        ms=device_ms(solve, "schur_pcg_kernel"),
        ms_is="one whole solve: the right-hand side, 40 CG iterations and "
              "the back-substitution in one cooperative launch (replaced "
              "by the loop path's own problem where the loop phase ran)",
        ms_sx=ms14, ms_sx_is="one S x through the pass launches (the "
                             "landmark pass and the keyframe pass)",
        ms_by="profiler" if not EVENT_TIMED & {
            "schur_pcg_kernel", "schur_lm_kernel", "schur_kf_kernel"}
        else "cuda events",
        call_ms=time_ms(solve, reps=10, inner=2),
        call_ms_sx=time_ms(matvec),
        plain_ms=time_ms(lambda: ba.pcg_solve_plain(*args, 40), reps=3,
                         inner=1),
        plain_ms_sx=time_ms(uses["S x"][1], reps=5, inner=2),
        bound_ms=b_s, bound_by=by_s, bound_ms_sx=b14, bound_sx_by=by14,
        bound_ms_82_passes=b14 * 41,
        bound_ms_82_passes_is="one S x's bound (two passes) x 41: the 82 "
                              "passes of a solve, comparable with the rows "
                              "of the pass launches",
        library_ms=None,
        library_note="none: no single PyTorch call computes the implicit "
                     "Schur product or its CG solve",
        ptxas=_ptxas("schur_pcg"),
        shape=f"K = {LOOP_K}, L = {LOOP_L}, O = {p.obs_mask.numel()} "
              f"({n_obs} active, 30% stereo)"))
    call4 = lambda: ba.assemble(p, p.R, p.t, p.X, order, per_obs=True)
    (b4, by4), _ = _ba_bound(p, per_obs=True)
    rows.append(dict(
        name="ba_assemble_per_obs", route="cuda",
        source="morb_slam_tpu_torch/csrc/ba_assemble.cu",
        replaces="morb_slam_tpu/optim/ba.py:305", max_abs_err=max(
            rel.values()),
        max_abs_err_is="relative to each block tensor's max-abs",
        ms=device_ms(call4, "ba_assemble_kernel"),
        ms_is="the whole assembly in one launch, the masked slots' zero "
              "blocks of Wpl included (the kernel writes every slot; the "
              "wrapper runs no fill of Wpl)",
        kernels_per_call=kernels_per_call(call4),
        ptxas=_ptxas("ba_assemble"),
        ms_by="profiler" if "ba_assemble_kernel" not in EVENT_TIMED
        else "cuda events",
        call_ms=time_ms(call4),
        plain_ms=time_ms(lambda: ba.assemble_obs_plain(p, p.R, p.t, p.X),
                         reps=5, inner=2),
        bound_ms=b4, bound_by=by4, library_ms=None,
        library_note="none: no single call does a robust BA assembly",
        shape=f"K = {LOOP_K}, L = {LOOP_L}, O = {p.obs_mask.numel()} "
              f"({n_obs} active, 30% stereo), Wpl (O, 6, 3)"))
    log(f"global BA kernels checked in {time.perf_counter() - t0:.1f} s")


class _PlainPCG:
    """ba_solve_pcg over the plain versions of K4's per-observation mode
    and K14's solve, or (`solve_only`) of K14's solve alone (module
    attributes swapped for the duration)."""

    def __init__(self, solve_only=False):
        self.solve_only = solve_only

    def __enter__(self):
        from morb_slam_tpu_torch.optim import ba
        self.saved = (ba.assemble, ba.pcg_solve)
        if not self.solve_only:
            ba.assemble = lambda p, R, t, X, order=None, body=False, \
                per_obs=False: (ba.assemble_obs_plain if per_obs else
                                ba.assemble_plain)(p, R, t, X, body)
        ba.pcg_solve = ba.pcg_solve_plain
        return self

    def __exit__(self, *exc):
        from morb_slam_tpu_torch.optim import ba
        ba.assemble, ba.pcg_solve = self.saved


def _loop_vocabulary(state, pairs):
    """The k = 8, depth = 3 vocabulary trained on the host (the port's
    numpy `train`) from the descriptors of every 25th rectified left
    image, extracted by the port on the card, saved to a temporary .npz."""
    import tempfile
    from morb_slam_tpu_torch import frontend
    from morb_slam_tpu_torch.io import serialization
    from morb_slam_tpu_torch.ops import rectify
    from morb_slam_tpu_torch.vocab import tree
    maps = _rig(state)["maps"]
    mm = torch.stack([maps.map1, maps.map2])
    cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
    descs = []
    for left, right in pairs[::25]:
        img = rectify.remap_bilinear(torch.stack([left, right]).float(),
                                     mm)[0]
        f = frontend.extract_orb(img, cfg)
        descs.append(f.desc[f.valid].cpu().numpy())
    descs = np.concatenate(descs)
    t0 = time.perf_counter()
    voc = tree.train(descs.view(np.uint32), k=LOOP_VOC_K,
                     depth=LOOP_VOC_DEPTH, iters=4)
    secs = time.perf_counter() - t0
    path = os.path.join(tempfile.mkdtemp(), "ring_voc.npz")
    serialization.save_vocabulary(path, voc)
    log(f"loop vocabulary: k {LOOP_VOC_K}, depth {LOOP_VOC_DEPTH}, "
        f"{voc.n_words} words from {descs.shape[0]} descriptors of "
        f"{len(pairs[::25])} frames in {secs:.1f} s")
    return path


class _LoopProbe:
    """Instrument one loop-phase run: each maybe_close's milliseconds and
    host syncs (the card synchronized around it), the milliseconds of
    correct_loop, the pose graph, search_and_fuse and each GBA slice (with
    the K14 solves in it and whether it ran inside the closing
    maybe_close), the GBA jobs' problems and carries."""

    def __init__(self, inserts):
        from morb_slam_tpu_torch.optim import ba, pose_graph
        from morb_slam_tpu_torch.pipeline import global_ba, loop_closing
        self.targets = [(loop_closing.LoopCloser, "maybe_close"),
                        (loop_closing, "correct_loop"),
                        (pose_graph, "optimize"),
                        (loop_closing, "search_and_fuse"),
                        (loop_closing, "verify_candidate"),
                        (loop_closing, "guided_sim3_verify"),
                        (global_ba.GBAJob, "advance")]
        self.ms = collections.defaultdict(list)
        self.syncs = []
        self.counts = collections.defaultdict(list)   # verification counts
        self.slices = []
        self.jobs = []
        self.in_close = False
        self.last_args = {}
        self.ba = ba
        self.inserts = inserts      # ms of each keyframe insert so far

    def __enter__(self):
        import warnings
        self.saved = [getattr(m, n) for m, n in self.targets]
        for (mod, name), fn in zip(self.targets, self.saved):
            def wrap(*a, _fn=fn, _name=name, **kw):
                self.last_args[_name] = (a, kw)
                if _name == "guided_sim3_verify" and \
                        not hasattr(self, "first_guided"):
                    # K18's check replays the first verified candidate on
                    # a copy of the map as it stood then
                    self.first_guided = _cloned((a, kw))
                if _name == "advance":
                    job = a[0]
                    if job not in self.jobs:
                        self.jobs.append(job)
                    job.__dict__.setdefault("carries", []).append(job.carry)
                    k14 = dict(self.ba.PCG_LAUNCHES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if _name == "maybe_close":
                    torch.cuda.set_sync_debug_mode("warn")
                    with warnings.catch_warnings(record=True) as rec:
                        warnings.simplefilter("always")
                        self.in_close = True
                        try:
                            r = _fn(*a, **kw)
                        finally:
                            self.in_close = False
                            torch.cuda.set_sync_debug_mode(0)
                    sites = [w for w in rec
                             if "synchroniz" in str(w.message)]
                    self.syncs.append(len(sites))
                    self.sync_sites = collections.Counter(
                        "/".join(os.path.normpath(w.filename)
                                 .split(os.sep)[-2:]) + f":{w.lineno}"
                        for w in sites)
                else:
                    r = _fn(*a, **kw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                self.ms[_name].append(ms)
                if _name in ("verify_candidate", "guided_sim3_verify"):
                    # the caller reads this count on the host anyway
                    self.counts[_name].append(int(r[3]))
                if _name == "advance":
                    self.slices.append(dict(
                        job=self.jobs.index(a[0]), ms=ms,
                        in_close=self.in_close,
                        k14=self.ba.PCG_LAUNCHES["kernel"] - k14["kernel"],
                        k14_plain=self.ba.PCG_LAUNCHES["plain"]
                        - k14["plain"]))
                if _name == "maybe_close" and r:
                    # the insert calling it is the next one to be timed
                    self.closing = dict(maybe_close_ms=ms,
                                        syncs=self.syncs[-1],
                                        sync_sites=dict(
                                            self.sync_sites.most_common(8)),
                                        insert=len(self.inserts))
                return r
            setattr(mod, name, wrap)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)


def _loop_gap(est_of, n, period):
    gaps = [np.linalg.norm(est_of[i] - est_of[i - period])
            for i in range(period, n) if i in est_of and i - period in est_of]
    return float(np.mean(gaps)) if gaps else float("inf")


def phase_loop(state, variant=None):
    """A live stereo loop through System with loop closing on: the tests'
    ring world at the EuRoC rig, 1.5 circuits in 346 frames, at the JAX
    loop test's tracker settings, every frame decided at once. A `variant`
    (settings, pipelined) runs it at the "test" settings or the System's
    own ("system": no tracker overrides), pipelined or not, and reports the
    loop's gates without enforcing them; a third entry "plain solve" runs
    the global BA over K14's plain solve (K4 and every other kernel
    stay)."""
    from morb_slam_tpu_torch import alignment, system
    from morb_slam_tpu_torch.optim import ba
    from morb_slam_tpu_torch.pipeline import loop_closing
    gated = variant is None
    settings, pipelined, solve = (tuple(variant or ("test", False))
                                  + ("kernel",))[:3]
    rig = _rig(state)
    t0 = time.perf_counter()
    world = RingWorld(np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]]),
                      W, H, DEV)
    poses = ring_path(N_LOOP, circuits=N_LOOP / LOOP_PERIOD)
    pairs = [_raw_pair(state, R, t, world=world) for R, t in poses]
    torch.cuda.synchronize()
    log(f"loop: ring world and {N_LOOP} raw pairs rendered on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    voc_path = _loop_vocabulary(state, pairs)
    sysm = system.System(rig["settings"], system.Sensor.STEREO,
                         vocabulary_path=voc_path,
                         tracker_overrides=None if settings == "system"
                         else dict(th_depth=60.0, vel_rot_damp=0.9,
                                   min_stereo_init_feats=150))
    tr = sysm.tracker
    gates = {}

    def gate(name, ok, what):
        gates[name] = bool(ok)
        if gated:
            check(ok, what)
    check(tr.loop_closer is not None, "System built no loop closer")
    check((tr.cfg.max_kf, tr.cfg.n_feat, tr.cfg.max_lm) ==
          (LOOP_K, LOOP_F, LOOP_L), "System's capacities changed")
    tr.pipelined = pipelined
    inserts = _timed_inserts(tr)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    states, live_of = [], {}
    plain = contextlib.nullcontext() if solve == "kernel" else \
        _PlainPCG(solve_only=True)
    with _LoopProbe(inserts) as probe, plain:
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        for i in range(N_LOOP):
            st, pose = sysm.track_stereo(pairs[i][0], pairs[i][1],
                                         i * LOOP_DT)
            states.append(st)
            if pose is not None and st == "OK":
                Rc, tc = (x.cpu().numpy() for x in pose)
                live_of[i] = -Rc.T @ tc
        torch.cuda.synchronize()
        secs = time.perf_counter() - t_run
        n_slices_before_flush = len(probe.slices)
        tr.flush()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    log(f"loop: {tr.kf_seq} keyframe inserts, {len(probe.ms['maybe_close'])} "
        f"maybe_close calls, Sim3 RANSAC inliers per verified candidate "
        f"{probe.counts['verify_candidate']}, guided matches "
        f"{probe.counts['guided_sim3_verify']} (gates "
        f"{loop_closing.MIN_SIM3_INLIERS} / "
        f"{loop_closing.MIN_ACCEPT_MATCHES})")
    # a variant need not verify a candidate or close the loop
    loop_kernels = ["sim3_window", "sim3_refine", "schur_pcg",
                    "ba_assemble_per_obs", "pose_graph"]
    launches = _read_counters(
        ["fast_select", "orb_describe", "hamming_top2", "pose_opt",
         "pyramid_blur",
         "stereo_sad", "remap_bilinear", "ba_assemble", "vocab_transform",
         "bow_l1"] + (loop_kernels if gated else []), "loop", state,
        allow_plain=() if solve == "kernel" else ("schur_pcg",
                                                  "schur_passes"))
    launches.update({k: _kernel_counters()[k]["kernel"] for k in loop_kernels})
    n_ok = sum(s == "OK" for s in states)
    gate("loop closed", tr.n_loops_closed >= 1,
         "no loop closed on the ring circuit")
    gate("frames OK", n_ok > 0.9 * N_LOOP,
         f"loop: only {n_ok} of {N_LOOP} frames OK")
    check(tr._gba_job is None, "flush() left the global BA running")
    for j in range(len(probe.jobs)):
        n_sl = sum(1 for sl in probe.slices if sl["job"] == j)
        log(f"GBA job {j}: {n_sl} slices")
    last_job = len(probe.jobs) - 1
    gate("GBA slices", last_job >= 0 and sum(
        1 for sl in probe.slices if sl["job"] == last_job) == 4,
        "the last GBA job did not run its 4 slices")
    if solve == "kernel":
        check(all(sl["k14"] > 0 for sl in probe.slices),
              "a GBA slice launched no K14")
    else:
        check(all(sl["k14"] == 0 and sl["k14_plain"] > 0
                  for sl in probe.slices),
              "a GBA slice over the plain solve launched K14")
    post_of = {int(round(ts / LOOP_DT)): p for ts, p in
               tr.trajectory_world()}
    period = int(round(LOOP_PERIOD))
    gap_raw = _loop_gap(live_of, N_LOOP, period)
    gap_post = _loop_gap(post_of, N_LOOP, period)
    gt = {i: -(np.asarray(R, np.float64).T @ t) for i, (R, t) in
          enumerate(poses)}
    common = sorted(set(live_of) & set(post_of))

    def ate(est_of):
        est = torch.tensor(np.stack([est_of[i] for i in common]),
                           dtype=torch.float32)
        ref = torch.tensor(np.stack([gt[i] for i in common]),
                           dtype=torch.float32)
        return float(alignment.ate_rmse(est, ref, with_scale=False)[0])
    ate_raw, ate_post = ate(live_of), ate(post_of)
    log(f"loop: {tr.n_loops_closed} closed, {n_ok}/{N_LOOP} OK, loop gap "
        f"{gap_post:.4f} after correction vs {gap_raw:.4f} raw (gate 0.3; "
        f"0.2588 at commit 001dca8 on the routine settings), SE3 ATE "
        f"{ate_post:.4f} vs raw {ate_raw:.4f} m (gate 1.1 x raw)")
    gate("loop gap", gap_post < 0.3 and gap_post <= gap_raw + 1e-6,
         ("loop gap", gap_post, gap_raw))
    gate("SE3 ATE", ate_post < 1.1 * ate_raw,
         ("loop SE3 ATE", ate_post, ate_raw))

    close = getattr(probe, "closing", {})
    first = [sl for sl in probe.slices if sl["in_close"]]
    later = [sl for sl in probe.slices if not sl["in_close"]]
    out = dict(
        fps=N_LOOP / secs, frames_ok=n_ok, loops_closed=tr.n_loops_closed,
        kf_inserts=len(inserts),
        kf_insert_ms_p50=float(np.percentile(inserts, 50)),
        kf_insert_ms_max=float(np.max(inserts)),
        loop_gap=gap_post, loop_gap_raw=gap_raw, ate_se3_m=ate_post,
        ate_se3_raw_m=ate_raw,
        closing=dict(insert_ms=inserts[close["insert"]] if close else None,
                     maybe_close_ms=close.get("maybe_close_ms"),
                     correct_loop_ms=probe.ms["correct_loop"],
                     pose_graph_ms=probe.ms["optimize"],
                     search_and_fuse_ms=probe.ms["search_and_fuse"],
                     first_two_gba_slices_ms=[sl["ms"] for sl in first]),
        maybe_close_calls=len(probe.ms["maybe_close"]),
        maybe_close_ms_p50=float(np.percentile(probe.ms["maybe_close"], 50)),
        host_syncs_per_maybe_close=dict(
            mean=float(np.mean(probe.syncs)), max=int(np.max(probe.syncs)),
            closing=close.get("syncs"),
            closing_sites=close.get("sync_sites")),
        sim3_inliers=probe.counts["verify_candidate"],
        guided_matches=probe.counts["guided_sim3_verify"],
        later_gba_slices_ms=[sl["ms"] for sl in later],
        k14_launches_per_slice=[sl["k14"] for sl in probe.slices],
        plain_solves_per_slice=[sl["k14_plain"] for sl in probe.slices],
        solve=solve,
        slices_before_flush=n_slices_before_flush,
        gba_jobs=len(probe.jobs),
        peak_device_mem_gib=peak / 2 ** 30,
        launches={k: v for k, v in launches.items()}, gates=gates)
    if not gated:
        log(f"loop path, {settings} settings, pipelined {pipelined}, "
            f"solve {solve}:", json.dumps(out))
        return

    # one GBA slice on the path's own problem: device time, the kernels'
    # slice against the plain versions' slice, peak memory of a slice
    job = probe.jobs[-1]
    carry = job.carries[1]           # the state before the second slice
    p = job.prob
    slice_fn = lambda: ba.ba_solve_pcg(p, n_iters=job.slice_iters,
                                       cg_iters=job.cg_iters, carry=carry)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = slice_fn()
    torch.cuda.synchronize()
    slice_peak = torch.cuda.max_memory_allocated() - base
    dense_bt = p.R.shape[0] * p.X.shape[0] * 72
    with _PlainPCG():
        want = slice_fn()
    acc_g, acc_w = got[3]["accepted"].tolist(), want[3]["accepted"].tolist()
    c_rel = float(((got[3]["costs"] - want[3]["costs"]).abs()
                   / want[3]["costs"].abs()).max())
    log(f"GBA slice over K4 + K14 vs the plain versions: accepts {acc_g} vs "
        f"{acc_w}, costs within {c_rel:.2e} relative; the slice's peak "
        f"device memory {slice_peak / 2 ** 20:.1f} MiB over its inputs (a "
        f"dense coupling would be {dense_bt / 2 ** 20:.0f} MiB)")
    check(acc_g == acc_w and c_rel <= 1e-3, ("GBA slice vs plain", acc_g,
                                             acc_w, c_rel))
    check(slice_peak < dense_bt, ("a GBA slice allocated as much as a "
                                  "dense coupling", slice_peak, dense_bt))
    slice_dev = device_ms(slice_fn, None, reps=2)
    # each later slice replayed from its own start state
    later_dev = [device_ms(lambda c=c: ba.ba_solve_pcg(
        p, n_iters=job.slice_iters, cg_iters=job.cg_iters, carry=c), None,
        reps=1) for c in job.carries[2:]]
    # K14's whole solve on the path's own problem: the first LM step of
    # the replayed slice
    Rc, tc, Xc, lam_c, _ = carry
    order = ba.obs_order(p)
    args = ba.pcg_args(p, ba.assemble(p, Rc, tc, Xc, order, per_obs=True),
                       lam_c, order)
    rel_s, first_s = _pcg_check(args, job.cg_iters,
                                "the loop path's GBA problem")

    def solve():
        return ba.pcg_solve(*args, job.cg_iters)
    b_s, by_s = _pcg_bound(p, job.cg_iters)
    pcg = dict(ms=device_ms(solve, "schur_pcg_kernel"),
               call_ms=time_ms(solve, reps=10, inner=2), bound_ms=b_s,
               bound_by=by_s, bound_ms_82_passes=_schur_bound(p)[0][0] * 41,
               vs_plain_rel=rel_s, vs_plain_rel_first_iters=first_s,
               cg_iters=job.cg_iters,
               active_obs=int(p.obs_mask.sum()))
    row = next((r for r in state.get("kernel_rows", [])
                if r["name"] == "schur_pcg"), None)
    if row is not None:
        row.update(ms_capacities=row["ms"],
                   bound_ms_capacities=row["bound_ms"],
                   max_abs_err=max(row["max_abs_err"], *rel_s.values()),
                   first_iters_max_abs_err={
                       n: max(row["first_iters_max_abs_err"][n],
                              *first_s[n].values()) for n in first_s},
                   ms=pcg["ms"], bound_ms=b_s, bound_by=by_s,
                   bound_ms_82_passes=pcg["bound_ms_82_passes"],
                   call_ms=pcg["call_ms"],
                   shape_of_ms=f"the loop path's GBA problem: "
                               f"{pcg['active_obs']} active observations")
    out["gba_slice"] = dict(
        device_ms=slice_dev, later_slices_device_ms=later_dev,
        ms=time_ms(slice_fn, reps=3, inner=1),
        active_obs=int(p.obs_mask.sum()), kfs=int(p.kf_opt.sum()) + 1,
        landmarks=int(p.lm_opt.sum()), vs_plain_cost_rel=c_rel,
        accepts=acc_g, peak_mib=slice_peak / 2 ** 20,
        dense_coupling_mib=dense_bt / 2 ** 20, pcg_solve=pcg)
    log("loop path:", json.dumps(out))
    state["loop"] = out
    state["k18_inputs"] = probe.first_guided
    state["plain_rows"] += _loop_plain_rows(probe, len(inserts), state)
    _log_plain_rows(state["plain_rows"][-1:])


def _loop_plain_rows(probe, n_inserts, state):
    """guided_sim3_verify (K18 inside) on the loop path's last call: device
    time per call under its profiler range, the range's span, the bound
    from these inputs, calls per keyframe insert. The path's last essential
    graph is kept for K15's row."""
    from morb_slam_tpu_torch.pipeline import loop_closing
    (g,), kw = probe.last_args["optimize"]
    state["k15_graph"] = (g, kw)
    a, kw_g = probe.last_args["guided_sim3_verify"]

    def gv_profile():
        with profiled(cpu=True) as prof:
            loop_closing.guided_sim3_verify(*a, **kw_g)
        return prof
    gv_ms, _, gv_span = range_device_ms("guided_sim3_verify", gv_profile)
    F = a[0].kf_feat_lm.shape[1]
    # the two keyframes' features and landmarks in (~80 B a slot); the
    # F x F window gate (~8 flops a pair), K3's two searches, 12 GN steps
    # of 8 residual evaluations (primal + 7 tangents) of ~120 flops per
    # feature
    b_gv, by_gv = bound(2 * F * 80, F * F * (8 + 2 * 8 * 6) + 12 * 8 * 120 * F)
    return [
        dict(name="guided_sim3_verify", route="cuda (K18 inside)",
             source="morb_slam_tpu_torch/pipeline/loop_closing.py",
             replaces="morb_slam_tpu/pipeline/loop_closing.py:78",
             ms=gv_ms, span_ms=gv_span,
             plain_ms=time_ms(lambda: loop_closing.guided_sim3_verify(
                 *a, **kw_g), reps=3, inner=1, warmup=1),
             bound_ms=b_gv, bound_by=by_gv, library_ms=None,
             launches=len(probe.ms["guided_sim3_verify"]),
             launches_per_frame=len(probe.ms["guided_sim3_verify"])
             / N_LOOP,
             launches_per_insert=len(probe.ms["guided_sim3_verify"])
             / max(n_inserts, 1),
             max_abs_err=None, shape=f"F = {F} feature slots per keyframe")]


def phase_merge(state):
    """The bench's multi-session merge on the card: mono, the plane world
    out and back, a new map at the turn; the stashed map must weld back."""
    from morb_slam_tpu_torch import alignment, frontend, system
    from morb_slam_tpu_torch.io import config
    from morb_slam_tpu_torch.pipeline import loop_closing
    from morb_slam_tpu_torch.vocab import tree
    K = np.array([[MERGE_FX, 0, MERGE_W / 2], [0, MERGE_FX, MERGE_H / 2],
                  [0, 0, 1.0]])
    world = PlaneWorld(K, MERGE_W, MERGE_H, DEV)
    fwd = camera_path(MERGE_OUT)
    seq = fwd + fwd[-2::-1]
    frames = [world.render(*p).clamp(0, 255).to(torch.uint8) for p in seq]
    ocfg = frontend.OrbConfig(n_features=300, n_levels=4)
    descs = [frontend.extract_orb(frames[i].float(), ocfg)
             for i in range(0, len(seq), 6)]
    descs = np.concatenate([f.desc[f.valid].cpu().numpy() for f in descs])
    voc = tree.train(descs.view(np.uint32), k=6, depth=3, iters=3)
    settings = config.Settings(
        cam1=config.CameraSettings(model="PinHole", fx=MERGE_FX, fy=MERGE_FX,
                                   cx=MERGE_W / 2, cy=MERGE_H / 2,
                                   width=MERGE_W, height=MERGE_H),
        n_features=500, n_levels=4, scale_factor=1.2)
    sysm = system.System(settings, system.Sensor.MONOCULAR, vocabulary=voc,
                         tracker_overrides=dict(max_kf=64, max_lm=8000,
                                                min_init_matches=60,
                                                min_init_points=40))
    tr = sysm.tracker
    merges = []
    orig = tr.loop_closer.maybe_merge

    def merge(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(*a, **kw)
        torch.cuda.synchronize()
        merges.append(((time.perf_counter() - t0) * 1e3, r))
        return r
    tr.loop_closer.maybe_merge = merge
    states = []
    _reset_counters()
    with _CountCalls([(loop_closing, "guided_sim3_verify")]) as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(len(seq)):
            if i == len(fwd):
                tr.flush()
                tr.create_map_in_atlas()
            states.append(sysm.track_monocular(frames[i], ts=float(i))[0])
        tr.flush()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    # the weld verifies by RANSAC alone (verify_merge); a guided
    # verification runs only where maybe_close finds a loop candidate, and
    # then through K18
    n_guided = calls.counts["guided_sim3_verify"]
    launches = _read_counters(
        ["fast_select", "orb_describe", "hamming_top2", "pose_opt",
         "pyramid_blur", "ba_assemble", "vocab_transform", "bow_l1"]
        + (["sim3_window", "sim3_refine"] if n_guided else []), "merge",
        state)
    merged = any(st.merged_into_gen >= 0 for st in tr.stash)
    traj = tr.trajectory_world()
    est = torch.tensor(np.asarray([p for _, p in traj]), dtype=torch.float32)
    gt = torch.tensor(np.asarray([-(seq[int(round(ts))][0].T
                                    @ seq[int(round(ts))][1])
                                  for ts, _ in traj]), dtype=torch.float32)
    rmse = float(alignment.ate_rmse(est, gt, with_scale=True)[0])
    extent = MERGE_OUT * 0.05
    n_ok = sum(s == "OK" for s in states)
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    out = dict(frames=len(seq), frames_ok=n_ok, merged=merged,
               ate_sim3_m=rmse, extent_m=extent, gate_m=0.08 * extent,
               trajectory_poses=len(traj), seconds=secs,
               maybe_merge_calls=len(merges),
               guided_sim3_verify_calls=n_guided, launches=launches,
               merge_ms=[ms for ms, r in merges if r],
               maybe_merge_ms_p50=float(np.percentile(
                   [ms for ms, _ in merges], 50)) if merges else None)
    log("merge path:", json.dumps(out))
    check(merged, "the stashed map was never merged back")
    check(rmse < 0.08 * extent, ("merge Sim3 ATE", rmse, extent))
    state["merge"] = out



# ---------------------------------------------------------------------------
# the inertial loop branch and KB8 fisheye mono-inertial; K13 and K15
# ---------------------------------------------------------------------------

# test_stereo_inertial_ring_circuit_gauge (tests/test_inertial_e2e.py:136):
# a 384x288 rectified pinhole pair, baseline 0.1, 300 frames at 1.3
# circuits, IMU at 200 Hz with per-sample noise 2.4e-3 / 2.8e-2, seed 2
VL_N, VL_CIRC, VL_DT, VL_B = 300, 1.3, 0.05, 0.1
VL_W, VL_H, VL_FX = 384, 288, 300.0
# bench.py:185 mono_inertial_fisheye_run: KB8 cam1, a 640x480 pinhole
# render (focal 240) remapped into it, IMU seed 4, frames 70-99 timed
FE_W, FE_H, FE_F, FE_KS = 384, 288, 170.0, (0.03, -0.012, 0.004, -0.001)
FE_WP, FE_HP, FE_FP = 640, 480, 240.0
FE_N, FE_WARM = 100, 70
# the inertial drifted-revisit map (as tests/test_torch_loop_inertial.py
# builds it): 20 keyframes 0.5 s apart out and back along x, the second
# half drifted by a yaw and a translation (scale drift 1)
LD_N, LD_DT, LD_T, LD_XM = 20, 0.5, 9.5, 3.8
LD_K, LD_F, LD_L = 24, 256, 1024
LD_W, LD_H, LD_FX = 384, 288, 300.0


def ring_pose(t, circuits=VL_CIRC, n_frames=VL_N, r_cam=2.5, fps=20.0):
    """The tests' continuous ring orbit (frame i = t * fps), float64."""
    th = 2 * np.pi * circuits * (t * fps) / n_frames
    sn, cs = np.sin(th), np.cos(th)
    R_cw = np.array([[cs, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, cs]]).T
    return R_cw, -R_cw @ (r_cam * np.array([sn, 0.0, cs]))


def _tilts(R_true_of, R_est_of):
    """Pitch / roll of each estimated camera rotation against the true one:
    the angle the world z (gravity) axis makes after R_est^T R_true, as
    the JAX ring test measures it (by atan2, exact below 1e-4 rad too)."""
    out = []
    for k in R_est_of:
        A = np.asarray(R_true_of[k], np.float64).T @ np.asarray(
            R_est_of[k], np.float64)
        v = A.T @ [0, 0, 1.0]
        out.append(float(np.arctan2(np.hypot(v[0], v[1]), v[2])))
    return out


def _scaled_gaps(H, b, H0, b0):
    """K13 / K15 against plain under Jacobi scaling: max |dH_ij| /
    sqrt(H_ii H_jj), and max |db_i| / sqrt(H_ii) over the scaled max-abs
    of b0 (the plain version's diagonal; a zero diagonal counts as 1)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H0), min=0.0))
    d = torch.where(d > 0, d, torch.ones_like(d))
    eH = float(((H - H0).abs() / d[:, None] / d[None, :]).max())
    eb = float(((b - b0).abs() / d).max() / (b0 / d).abs().max().clamp(
        min=1e-30))
    return eH, eb


def _rotvec(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def ld_pose(t):
    """The drifted map's true path: identity orientation, the centre out
    and back along x by a raised cosine (LD_XM at t = LD_T / 2)."""
    x = LD_XM * 0.5 * (1.0 - np.cos(2 * np.pi * t / LD_T))
    return np.eye(3), -np.array([x, 0.0, 0.0])


def inertial_drifted_map(m_np, rot_drift=(0.0, 0.0, 0.04),
                         t_drift=(0.25, -0.1, 0.15), seed=7):
    """Fill an empty map's numpy arrays (LD_K keyframe slots of LD_F
    features, LD_L landmarks) with the inertial drifted-revisit state:
    keyframes 0-9 map a corridor outbound with clean landmarks, 10-19
    revisit the same points through duplicate landmarks whose positions,
    poses and world velocities carry a rigid drift (R_d, t_d); kf_v the
    path's velocity (rotated by R_d on the late side), kf_bias 0. Returns
    (m_np, descriptors, true centres)."""
    rng = np.random.default_rng(seed)
    NP_ = 400
    Xw = np.stack([np.linspace(0, 12, NP_), rng.uniform(-1.2, 1.2, NP_),
                   rng.uniform(4.0, 6.0, NP_)], axis=1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (NP_, 8), dtype=np.uint32)
    R_d = _rotvec(rot_drift).astype(np.float32)
    t_d = np.asarray(t_drift, np.float32)
    X_dup = (Xw @ R_d.T + t_d).astype(np.float32)
    centers, views = {}, {}
    for i in range(LD_N):
        late = i >= LD_N // 2
        t = i * LD_DT
        c = -ld_pose(t)[1].astype(np.float32)
        v = np.array([LD_XM * np.pi / LD_T * np.sin(2 * np.pi * t / LD_T),
                      0.0, 0.0], np.float32)
        centers[i] = c
        vis = np.where(np.abs(Xw[:, 0] - c[0] - 1.2) < 2.2)[0][:LD_F]
        views[i] = vis
        Xc = Xw[vis] - c                          # R_cw = I (true pose)
        if late:
            m_np["kf_R"][i] = R_d.T
            m_np["kf_t"][i] = -c - R_d.T @ t_d
            m_np["kf_v"][i] = R_d @ v
            lm_ids = 512 + vis
        else:
            m_np["kf_R"][i] = np.eye(3, dtype=np.float32)
            m_np["kf_t"][i] = -c
            m_np["kf_v"][i] = v
            lm_ids = vis
        n = len(vis)
        m_np["kf_valid"][i] = True
        m_np["kf_ts"][i] = t
        m_np["kf_prev"][i] = i - 1
        xn = Xc[:, :2] / Xc[:, 2:3]
        m_np["kf_feat_xn"][i, :n] = xn
        m_np["kf_feat_uv"][i, :n] = xn * LD_FX + np.array(
            [LD_W / 2, LD_H / 2], np.float32)
        m_np["kf_feat_desc"][i, :n] = desc[vis]
        m_np["kf_feat_valid"][i, :n] = True
        m_np["kf_feat_lm"][i, :n] = lm_ids
    half = LD_N // 2
    early = np.unique(np.concatenate([views[i] for i in range(half)]))
    late_ = np.unique(np.concatenate([views[i] for i in range(half, LD_N)]))
    m_np["lm_pos"][early] = Xw[early]
    m_np["lm_valid"][early] = True
    m_np["lm_desc"][early] = desc[early]
    m_np["lm_pos"][512 + late_] = X_dup[late_]
    m_np["lm_valid"][512 + late_] = True
    m_np["lm_desc"][512 + late_] = desc[late_]
    m_np["lm_normal"][:, 2] = -1.0
    m_np["lm_dist_max"][:] = 12.0
    for i in range(LD_N):
        ids = views[i] if i < half else 512 + views[i]
        first = m_np["lm_ref_kf"][ids] < 0
        m_np["lm_ref_kf"][ids[first]] = i
        m_np["lm_first_ts"][ids[first]] = i * LD_DT
    m_np["n_kf"] = np.asarray(LD_N)
    m_np["n_lm"] = np.asarray(912)
    return m_np, desc, centers


def ld_imu_samples():
    """Each keyframe k >= 1's noiseless IMU samples over (t_{k-1}, t_k]
    of the drifted map's true path: (timestamps, acc, gyro)."""
    return [imu_between((k - 1) * LD_DT, k * LD_DT, pose_fn=ld_pose)
            for k in range(1, LD_N)]


def _ld_tracker(dev, rot_drift=(0.0, 0.0, 0.04)):
    """The port's inertial tracker on the drifted map (imu_ready, the
    KfImu chain preintegrated by the port on `dev`, the database filled)
    and the keyframes' BoW vectors."""
    from morb_slam_tpu_torch import cameras, convert, imu
    from morb_slam_tpu_torch.mapstate import state as ms
    from morb_slam_tpu_torch.optim import inertial
    from morb_slam_tpu_torch.pipeline import tracking
    from morb_slam_tpu_torch.vocab import database as kfdb
    from morb_slam_tpu_torch.vocab import tree
    m_np = {k: v.numpy().copy() for k, v in
            ms.empty_map(LD_K, LD_F, LD_L)._asdict().items()}
    m_np, desc, centers = inertial_drifted_map(m_np, rot_drift)
    voc = tree.train(desc, k=6, depth=3, iters=4)
    calib = imu.make_calib(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5,
                           3e-3, 200.0)
    cfg = tracking.TrackerConfig(width=LD_W, height=LD_H, focal=LD_FX,
                                 n_feat=LD_F, max_kf=LD_K, max_lm=LD_L,
                                 n_levels=4)
    tr = tracking.Tracker(cameras.pinhole(LD_FX, LD_FX, LD_W / 2, LD_H / 2),
                          cfg, device=dev, voc=voc, imu_calib=calib)
    tr.m = convert.map_from_numpy(m_np, device=dev)
    ki = inertial.empty_kf_imu(LD_K, device=dev)
    for k, (ts, acc, gyr) in enumerate(ld_imu_samples(), start=1):
        n = len(ts)
        pre = imu.preintegrate(
            torch.tensor(acc, device=dev), torch.tensor(gyr, device=dev),
            torch.full((n,), 1.0 / IMU_NOISE["frequency"], device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.zeros(6, device=dev), tr.calib)
        ki = inertial.set_kf_imu(ki, k, pre, k - 1)
    tr.kf_imu, tr.imu_ready, tr.n_kf_host = ki, True, LD_N
    bows = []
    for i in range(LD_N):
        bow = tree.bow_vector(tr.voc, tree.transform(
            tr.voc, tr.m.kf_feat_desc[i], tr.m.kf_feat_valid[i]))
        tr.db = kfdb.add_keyframe(tr.db, i, bow)
        bows.append(bow)
    return tr, bows, centers


def _ld_close(dev):
    """maybe_close for keyframes 18 and 19 on the drifted inertial map:
    (fired, centre RMSE of keyframes 10-19 before and after, tilts after,
    the poses and velocities after)."""
    from morb_slam_tpu_torch.pipeline import loop_closing
    tr, bows, centers = _ld_tracker(dev)

    def rmse():
        R = tr.m.kf_R[10:20].cpu().numpy().astype(np.float64)
        t = tr.m.kf_t[10:20].cpu().numpy().astype(np.float64)
        c = -np.einsum('kji,kj->ki', R, t)
        gt = np.stack([centers[i] for i in range(10, 20)])
        return float(np.sqrt(np.mean(np.sum((c - gt) ** 2, axis=1))))
    before = rmse()
    closer = loop_closing.LoopCloser(tr.cfg)
    fired = [closer.maybe_close(tr, k, bows[k]) for k in (18, 19)]
    R = tr.m.kf_R[:LD_N].cpu().numpy()
    tilts = _tilts({k: np.eye(3) for k in range(LD_N)},
                   {k: R[k] for k in range(LD_N)})
    return dict(fired=fired, rmse_before=before, rmse_after=rmse(),
                tilts=tilts, R=R, t=tr.m.kf_t[:LD_N].cpu().numpy(),
                v=tr.m.kf_v[:LD_N].cpu().numpy())


def _vl_frames(dev):
    """The ring world's rectified pairs (uint8, on the card) and each
    frame's IMU samples since the previous frame (noise seed 2)."""
    K = np.array([[VL_FX, 0, VL_W / 2], [0, VL_FX, VL_H / 2], [0, 0, 1.0]])
    world = RingWorld(K, VL_W, VL_H, dev)
    poses = ring_path(VL_N, circuits=VL_CIRC)
    rng = np.random.default_rng(2)
    pairs, batches = [], []
    for i, (R, t) in enumerate(poses):
        c = -R.T @ t
        t_r = (-R @ (c + R.T @ np.array([VL_B, 0, 0], np.float32))).astype(
            np.float32)
        pairs.append(tuple(world.render(R, tt).clamp(0, 255).to(torch.uint8)
                           for tt in (t, t_r)))
        batches.append(imu_between((i - 1) * VL_DT, i * VL_DT, rng=rng,
                                   noise_g=2.4e-3, noise_a=2.8e-2,
                                   pose_fn=ring_pose))
    return pairs, batches


def _PLAIN_TARGETS():
    """The call sites counted on the vi_loop and fisheye paths: the LM
    solves (K13 inside), the IMU initialization (K17 inside) and the
    guided Sim(3) verification (K18 inside)."""
    from morb_slam_tpu_torch.optim import inertial, vi_ba
    from morb_slam_tpu_torch.pipeline import loop_closing
    return [(vi_ba, "vi_ba_solve"), (inertial, "inertial_only_optimize"),
            (loop_closing, "guided_sim3_verify")]


def _plain_calls(calls):
    return {k: v for k, v in calls.counts.items() if k != "vi_ba_solve"}


def phase_vi_loop(state):
    """The JAX stereo-inertial ring-circuit test through the port's System
    (IMU_STEREO with a vocabulary, loop closing on, unpipelined) at the
    test's configuration, then the inertial loop branch driven on the
    drifted inertial map: on the card and, for the poses, on the CPU."""
    from morb_slam_tpu_torch import frontend, system
    from morb_slam_tpu_torch.io import config
    from morb_slam_tpu_torch.optim import pose_graph, vi_ba
    from morb_slam_tpu_torch.pipeline import loop_closing
    from morb_slam_tpu_torch.vocab import tree
    t0 = time.perf_counter()
    pairs, batches = _vl_frames(DEV)
    torch.cuda.synchronize()
    log(f"vi_loop: {VL_N} ring pairs rendered on the card and "
        f"{sum(len(b[0]) for b in batches)} IMU samples in "
        f"{time.perf_counter() - t0:.1f} s")
    ocfg = frontend.OrbConfig(n_features=500, n_levels=4)
    descs = []
    for left, _ in pairs[::25]:
        f = frontend.extract_orb(left.float(), ocfg)
        descs.append(f.desc[f.valid].cpu().numpy())
    voc = tree.train(np.concatenate(descs).view(np.uint32), k=8, depth=3,
                     iters=4)
    settings = config.Settings(
        sensor="stereo-inertial",
        cam1=config.CameraSettings(model="Rectified", fx=VL_FX, fy=VL_FX,
                                   cx=VL_W / 2, cy=VL_H / 2, width=VL_W,
                                   height=VL_H),
        baseline=VL_B, th_depth=60.0, imu=config.ImuSettings(),
        n_features=500, n_levels=4, scale_factor=1.2)
    sysm = system.System(settings, system.Sensor.IMU_STEREO, vocabulary=voc,
                         tracker_overrides=dict(
                             max_kf=128, max_lm=16000,
                             min_stereo_init_feats=150, vel_rot_damp=0.9))
    tr = sysm.tracker
    check(tr.loop_closer is not None and tr.cfg.inertial,
          "vi_loop: System built no loop closer or no IMU calibration")
    tr.pipelined = False
    inserts = _timed_inserts(tr)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _CountCalls(_PLAIN_TARGETS()) as calls:
        states, fm = [], []
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        for i in range(VL_N):
            t1 = time.perf_counter()
            states.append(sysm.track_stereo(pairs[i][0], pairs[i][1],
                                            i * VL_DT,
                                            imu_batch=batches[i])[0])
            fm.append((time.perf_counter() - t1) * 1e3)
        tr.flush()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t_run
    lm_steps = sum(kw.get("n_iters", 8) for kw in calls.kwargs["vi_ba_solve"])
    k13 = vi_ba.INERTIAL_LAUNCHES["kernel"]
    k13_solve = _k13_per_solve("vi_loop", calls, k13)
    launches = _read_counters(
        ["fast_select", "orb_describe", "hamming_top2", "pose_opt",
         "pyramid_blur",
         "stereo_sad", "ba_assemble", "preintegrate", "pose_inertial",
         "vocab_transform", "bow_l1", "vi_edges", "inertial_init"],
        "vi_loop", state)
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    m = tr.m
    valid = m.kf_valid.cpu().numpy()
    kts = m.kf_ts.cpu().numpy()
    kR = m.kf_R.cpu().numpy()
    kt = m.kf_t.cpu().numpy()
    ks = [k for k in range(valid.shape[0]) if valid[k]]
    tilts = _tilts({k: ring_pose(float(kts[k]))[0] for k in ks},
                   {k: kR[k] for k in ks})
    C = {k: -kR[k].T @ kt[k] for k in ks}
    period = VL_N / VL_CIRC * VL_DT
    gaps = [float(np.linalg.norm(C[a] - C[b])) for a in ks for b in ks
            if abs((kts[a] - kts[b]) - period) < 0.15]
    gap = float(np.mean(gaps)) if gaps else float("inf")
    n_ok = sum(s == "OK" for s in states)
    finite = bool(torch.isfinite(m.kf_v).all() and
                  torch.isfinite(m.kf_bias).all())
    fm = np.asarray(fm)
    out = dict(
        fps=VL_N / secs, frame_ms_p50=float(np.percentile(fm, 50)),
        frame_ms_p90=float(np.percentile(fm, 90)), frames_ok=n_ok,
        imu_ready=tr.imu_ready, viba_stage=tr.viba_stage,
        kf_v_bias_finite=finite, max_tilt_rad=max(tilts),
        keyframes=len(ks), circuit_gap=gap, gap_pairs=len(gaps),
        kf_inserts=len(inserts),
        kf_insert_ms_each=float(np.mean(inserts)) if inserts else None,
        kf_insert_ms_p90=float(np.percentile(inserts, 90)) if inserts
        else None,
        vi_ba_solve_calls=calls.counts["vi_ba_solve"], lm_steps=lm_steps,
        k13_launches=k13, **k13_solve, bow_loop_fired=tr.n_loops_closed > 0,
        plain_target_calls=_plain_calls(calls),
        loops_closed=tr.n_loops_closed,
        peak_device_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches)
    log(f"vi_loop: {n_ok}/{VL_N} OK, imu_ready {tr.imu_ready}, max tilt "
        f"{max(tilts):.5f} rad over {len(ks)} keyframes, circuit gap "
        f"{gap:.4f} over {len(gaps)} pairs, {VL_N / secs:.2f} fps, "
        f"{lm_steps} LM steps, K13 launches {k13}, loops closed "
        f"{tr.n_loops_closed}")
    check(n_ok > 0.9 * VL_N, f"vi_loop: only {n_ok} of {VL_N} OK")
    check(tr.imu_ready, "vi_loop: the IMU never initialized")
    check(finite, "vi_loop: non-finite keyframe velocities or biases")
    check(max(tilts) < 0.01, ("vi_loop tilt", max(tilts)))
    check(gap < 0.2, ("vi_loop circuit gap", gap))

    # the inertial loop branch, driven on the drifted inertial map; K18's
    # inputs of its first verification kept for the check after the run
    _reset_counters()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with _CountCalls([(loop_closing, "window_match"),
                      (loop_closing, "sim3_refine")],
                     keep_first=("window_match", "sim3_refine")) as k18:
        got = _ld_close(DEV)
    torch.cuda.synchronize()
    ms_card = (time.perf_counter() - t1) * 1e3
    pg, k13b = pose_graph.LAUNCHES["kernel"], vi_ba.INERTIAL_LAUNCHES[
        "kernel"]
    branch_launches = _read_counters(["pose_graph", "vi_edges",
                                      "sim3_window", "sim3_refine"],
                                     "vi_loop branch", state)
    check(k18.counts["sim3_refine"] > 0,
          "vi_loop branch: no guided Sim(3) verification ran")
    k18_err, _, _, _ = _k18_agree(
        k18.first_args["window_match"][0], k18.first_args["sim3_refine"][0],
        "the vi_loop branch's first verification")
    t1 = time.perf_counter()
    with _CountCalls([(loop_closing, "sim3_refine")],
                     keep_first=("sim3_refine",)) as k18c:
        want = _ld_close("cpu")
    ms_cpu = (time.perf_counter() - t1) * 1e3
    dpose = max(float(np.abs(got[k] - want[k]).max()) for k in ("R", "t"))
    # the first verification's refinement inputs and result, CPU vs card
    ra_card = k18.first_args["sim3_refine"][0]
    ra_cpu = k18c.first_args["sim3_refine"][0]
    k18_in = max(float((u.cpu().float() - v.float()).abs().max())
                 for u, v in zip(ra_card, ra_cpu))
    s_card = float(loop_closing.sim3_refine(*ra_card)[0])
    s_cpu = float(loop_closing.sim3_refine_plain(*ra_cpu)[0])
    log(f"vi_loop branch's first refinement, CPU vs card: inputs within "
        f"{k18_in:.2e}, s {s_card!r} (card) vs {s_cpu!r} (CPU)")
    ratio = got["rmse_after"] / got["rmse_before"]
    out["branch"] = dict(
        fired=got["fired"], fired_cpu=want["fired"],
        rmse_before=got["rmse_before"], rmse_after=got["rmse_after"],
        rmse_ratio=ratio, max_tilt_rad=max(got["tilts"]),
        k15_launches=pg, k13_launches=k13b, vs_cpu_pose_max_abs=dpose,
        k18_vs_plain_max_abs=k18_err, k18_inputs_vs_cpu_max_abs=k18_in,
        k18_s_card=s_card, k18_s_cpu=s_cpu,
        vs_cpu_v_max_abs=float(np.abs(got["v"] - want["v"]).max()),
        ms_card=ms_card, ms_cpu_plain=ms_cpu, launches=branch_launches)
    log(f"vi_loop branch on the drifted inertial map: fired {got['fired']}"
        f" (CPU {want['fired']}), centre RMSE {got['rmse_before']:.4f} -> "
        f"{got['rmse_after']:.4f} (x{ratio:.3f}), max tilt "
        f"{max(got['tilts']):.2e} rad, K15 {pg} and K13 {k13b} launches, "
        f"poses within {dpose:.2e} of the CPU's plain run")
    check(got["fired"] == [False, True], ("branch fire sequence",
                                          got["fired"]))
    check(want["fired"] == [False, True], ("CPU branch fire sequence",
                                           want["fired"]))
    check(ratio < 0.4, ("branch centre RMSE ratio", ratio))
    check(max(got["tilts"]) < 0.01, ("branch tilt", max(got["tilts"])))
    check(dpose <= 1e-3, ("branch poses vs CPU", dpose))
    log("vi_loop path:", json.dumps(out))
    state["vi_loop"] = out


def fisheye_map():
    """bench.py:204-219's fisheye-pixel -> pinhole-source map (numpy,
    float64, then float32): KB8 theta_d(theta) inverted by 10 Newton
    steps, the source pixel through the 640x480 pinhole of focal 240."""
    u, v = np.meshgrid(np.arange(FE_W, dtype=np.float64),
                       np.arange(FE_H, dtype=np.float64))
    dx = (u - FE_W / 2) / FE_F
    dy = (v - FE_H / 2) / FE_F
    r_d = np.sqrt(dx ** 2 + dy ** 2)
    th = r_d.copy()
    k1, k2, k3, k4 = FE_KS
    for _ in range(10):
        t2 = th * th
        f = th * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - r_d
        fp = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        th = th - f / np.clip(fp, 0.5, None)
    r_p = np.tan(np.clip(th, 0, 1.45))
    scale = np.where(r_d > 1e-9, r_p / np.clip(r_d, 1e-9, None), 1.0)
    return np.stack([(FE_WP / 2 + FE_FP * dx * scale).astype(np.float32),
                     (FE_HP / 2 + FE_FP * dy * scale).astype(np.float32)],
                    -1)


def phase_fisheye(state):
    """bench.py's mono-inertial fisheye run through the port's System
    (IMU_MONOCULAR, a KannalaBrandt8 cam1): the plane world (seed 3)
    rendered at 640x480 on the card, remapped into the fisheye by K8,
    truncated to uint8 as the bench does; the mono-inertial e2e test's
    gates."""
    from morb_slam_tpu_torch import cameras, system
    from morb_slam_tpu_torch.io import config
    from morb_slam_tpu_torch.ops import rectify
    from morb_slam_tpu_torch.optim import vi_ba
    Kp = np.array([[FE_FP, 0, FE_WP / 2], [0, FE_FP, FE_HP / 2],
                   [0, 0, 1.0]])
    world = PlaneWorld(Kp, FE_WP, FE_HP, DEV, seed=3)
    fmap = torch.tensor(fisheye_map(), device=DEV)
    k8 = rectify.LAUNCHES["kernel"]
    rng = np.random.default_rng(4)
    gt, frames, batches = [], [], []
    for i in range(FE_N):
        R, tc = analytic_pose(i * 0.05)
        gt.append((R, tc))
        src = world.render(R.astype(np.float32), tc.astype(np.float32))
        frames.append(rectify.remap_bilinear(src.float(), fmap)
                      .clamp(0, 255).to(torch.uint8))
        batches.append(imu_between((i - 1) * 0.05, i * 0.05, rng=rng,
                                   noise_g=2.4e-3, noise_a=2.8e-2))
    k8 = rectify.LAUNCHES["kernel"] - k8
    settings = config.Settings(
        sensor="monocular-inertial",
        cam1=config.CameraSettings(model="KannalaBrandt8", fx=FE_F, fy=FE_F,
                                   cx=FE_W / 2, cy=FE_H / 2, dist=FE_KS,
                                   width=FE_W, height=FE_H),
        imu=config.ImuSettings(), n_features=500, n_levels=4,
        scale_factor=1.2)
    sysm = system.System(settings, system.Sensor.IMU_MONOCULAR,
                         tracker_overrides=dict(max_kf=96, max_lm=8000,
                                                min_init_matches=60,
                                                min_init_points=40))
    tr = sysm.tracker
    check(tr.cam.kind == cameras.CAM_FISHEYE,
          "fisheye: the System built no KB8 camera")
    inserts = _timed_inserts(tr)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _CountCalls(_PLAIN_TARGETS()) as calls:
        states, fm, secs, _ = _track_run(
            tr, lambda i, ts: sysm.track_monocular(frames[i], ts,
                                                   imu_batch=batches[i]),
            FE_N, 0.05, inserts, timed_from=FE_WARM)
    launches = _read_counters(
        ["fast_select", "orb_describe", "hamming_top2", "pose_opt",
         "ba_assemble", "preintegrate", "pose_inertial", "vi_edges",
         "pyramid_blur", "inertial_init"],
        "fisheye", state)
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    n_ok = sum(s == "OK" for s in states)
    ate, scale, ate_se3, extent, n_traj = _ate(tr, gt, 0.05)
    traj = np.asarray([p for _, p in tr.trajectory_world()])
    out = dict(
        mono_inertial_fisheye_fps=(FE_N - FE_WARM) / secs,
        timed_frames=[FE_WARM, FE_N - 1],
        frame_ms_p50=float(np.percentile(fm, 50)),
        frame_ms_p90=float(np.percentile(fm, 90)), frames_ok=n_ok,
        imu_ready=tr.imu_ready, viba_stage=tr.viba_stage,
        ate_sim3_m=ate, sim3_scale=scale, ate_se3_m=ate_se3,
        extent_m=extent, gate_m=0.04 * extent, trajectory_poses=n_traj,
        kf_inserts=len(inserts),
        kf_insert_ms_each=float(np.mean(inserts)) if inserts else None,
        vi_ba_solve_calls=calls.counts["vi_ba_solve"],
        lm_steps=sum(kw.get("n_iters", 8)
                     for kw in calls.kwargs["vi_ba_solve"]),
        **_k13_per_solve("fisheye", calls, launches["vi_edges"]),
        k8_render_launches=k8, plain_target_calls=_plain_calls(calls),
        peak_device_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches)
    log(f"fisheye: {n_ok}/{FE_N} OK, imu_ready {tr.imu_ready} (stage "
        f"{tr.viba_stage}), Sim3 ATE {ate:.4f} m (gate {0.04 * extent:.4f}"
        f"), {out['mono_inertial_fisheye_fps']:.2f} fps over frames "
        f"{FE_WARM}-{FE_N - 1}")
    check(n_ok > 0.75 * FE_N, f"fisheye: only {n_ok} of {FE_N} OK")
    check(tr.imu_ready and tr.viba_stage >= 1,
          ("fisheye IMU init", tr.imu_ready, tr.viba_stage))
    check(bool(np.isfinite(traj).all()), "fisheye: non-finite trajectory")
    check(ate < 0.04 * extent, ("fisheye Sim3 ATE", ate, extent))
    log("fisheye path:", json.dumps(out))
    state["fisheye"] = out


def _k13_row(pv, kw):
    """K13 against its plain version on the vi path's last window problem:
    H and b under Jacobi scaling, the cost, two calls bitwise equal; the
    device time of one call (one cooperative launch), call times, the
    bound, and the whole vi_ba_solve over the kernel and over the plain
    route (K4 in both)."""
    from morb_slam_tpu_torch import lie
    from morb_slam_tpu_torch.optim import ba, vi_ba
    bap = vi_ba._ba_problem(pv)
    R_cw, t_cw = lie.se3_inv(pv.R_wb, pv.p_wb)
    vis = ba.assemble(bap, R_cw, t_cw, pv.X, ba.obs_order(bap), body=True)
    st = (pv.R_wb, pv.p_wb, pv.v, pv.bias)

    def call():
        return vi_ba.inertial_terms(pv, *st, vis.Hpp, vis.bp)

    def plain():
        return vi_ba.inertial_terms_plain(pv, *st, vis.Hpp, vis.bp)
    (H, b, c), (H2, b2, c2), (H0, b0, c0) = call(), call(), plain()
    eH, eb = _scaled_gaps(H, b, H0, b0)
    ec = abs(float(c) - float(c0)) / max(abs(float(c0)), 1e-30)
    same = torch.equal(H, H2) and torch.equal(b, b2) and torch.equal(c, c2)
    Wn = pv.R_wb.shape[0]
    n_e = int(pv.e_valid.sum())
    log(f"K13 vi_edges (W = {Wn}, {n_e} valid edges): H within {eH:.2e} "
        f"and b within {eb:.2e} of plain under Jacobi scaling, the cost "
        f"within {ec:.2e} relative; two calls bitwise equal: {same}")
    check(eH <= 1e-5 and eb <= 1e-5 and ec <= 1e-5 and same,
          ("K13 vs plain", eH, eb, ec, same))
    n_it = kw.get("n_iters", 8)

    def solve():
        return vi_ba.vi_ba_solve(pv, **kw)
    before = vi_ba.INERTIAL_LAUNCHES["kernel"]
    got = solve()
    calls = vi_ba.INERTIAL_LAUNCHES["kernel"] - before
    check(calls == n_it + 1, ("K13 calls a vi_ba_solve", calls, n_it))
    step_ms = time_ms(solve, reps=3, inner=1, warmup=1) / n_it
    step_dev = device_ms(solve, None, reps=2) / n_it
    saved = vi_ba.inertial_terms
    vi_ba.inertial_terms = vi_ba.inertial_terms_plain
    try:
        want = solve()
        step_ms_plain = time_ms(solve, reps=3, inner=1, warmup=1) / n_it
        step_dev_plain = device_ms(solve, None, reps=2) / n_it
    finally:
        vi_ba.inertial_terms = saved
    c_rel = float((got[5]["costs"][-1] - want[5]["costs"][-1]).abs()
                  / want[5]["costs"][-1].abs())
    log(f"K13: vi_ba_solve ({n_it} iterations, {calls} K13 calls) over the "
        f"kernel against the plain route: final cost within {c_rel:.2e} "
        f"relative, accepts {got[5]['accepted'].tolist()} vs "
        f"{want[5]['accepted'].tolist()}")
    # inputs: each slot's state (84 B), edge constants (640 B), visual pose
    # blocks (168 B) and e_prev / e_valid (5 B); out the dense (15W)^2 H,
    # b and the cost; per valid edge ~45 kflop of dual-number Jacobian (30
    # tangents through the residual), ~21 kflop of J^T Omega J and
    # gradient and ~2.2 kflop of its cost
    D = 15 * Wn
    b13, by13 = bound(Wn * (84 + 640 + 168 + 5) + (D * D + D + 1) * 4,
                      n_e * 68.2e3)
    return dict(
        name="vi_edges", route="cuda",
        source="morb_slam_tpu_torch/csrc/vi_edges.cu",
        replaces="morb_slam_tpu/optim/vi_ba.py:247", max_abs_err=max(eH, eb),
        max_abs_err_is="H: max |dH_ij| / sqrt(H_ii H_jj); b: max |db_i| / "
                       "sqrt(H_ii) over the scaled max-abs",
        err_H_jacobi=eH, err_b_scaled=eb, err_cost_rel=ec, bitwise=same,
        ms=device_ms(call, "vi_terms_kernel"),
        ms_is="one inertial_terms call (H, b and the cost at one state): "
              "its one cooperative launch",
        ms_by="profiler" if "vi_terms_kernel" not in EVENT_TIMED
        else "cuda events",
        kernels_per_call=kernels_per_call(call),
        call_ms=time_ms(call), plain_ms=time_ms(plain, reps=5, inner=2),
        bound_ms=b13, bound_by=by13, library_ms=None,
        library_note="none: no single PyTorch call computes the inertial "
                     "edge Jacobians and their dense assembly",
        k13_calls_per_solve=calls, solve_cost_rel_plain=c_rel,
        lm_step_ms=step_ms, lm_step_ms_plain=step_ms_plain,
        lm_step_device_ms=step_dev, lm_step_device_ms_plain=step_dev_plain,
        ptxas=_ptxas("vi_edges"),
        shape=f"W = {Wn} window slots ({n_e} valid edges), H "
              f"({D}, {D}), {n_it} LM iterations per solve")


def _k15_row(g, kw):
    """K15 against its plain version on the loop path's essential graph:
    H and b under Jacobi scaling, the cost, two launches bitwise equal;
    device and call times (the zero fill counted), the bound, and the
    whole optimize over the kernel and over the plain version."""
    from morb_slam_tpu_torch.optim import pose_graph
    fd = bool(kw.get("four_dof", False))
    order = pose_graph.block_order(g)

    def call():
        return pose_graph.normal_equations(g, g.s, g.R, g.t, fd, order)

    def plain():
        return pose_graph.normal_equations_plain(g, g.s, g.R, g.t, fd)
    (H, b, c), (H2, b2, c2), (H0, b0, c0) = call(), call(), plain()
    eH, eb = _scaled_gaps(H, b, H0, b0)
    ec = abs(float(c) - float(c0)) / max(abs(float(c0)), 1e-30)
    same = torch.equal(H, H2) and torch.equal(b, b2) and torch.equal(c, c2)
    K, E = g.s.shape[0], g.edge_i.shape[0]
    n_act, nb = order.edges.shape[0], order.blk_row.shape[0]
    log(f"K15 pose_graph (K = {K}, {n_act} of {E} edges weighted, {nb} "
        f"blocks, four_dof {fd}): H within {eH:.2e} and b within {eb:.2e} "
        f"of plain under Jacobi scaling, the cost within {ec:.2e} "
        f"relative; two launches bitwise equal: {same}")
    check(eH <= 1e-5 and eb <= 1e-5 and ec <= 1e-5 and same,
          ("K15 vs plain", eH, eb, ec, same))
    it = kw.get("n_iters", 15)

    def opt():
        return pose_graph.optimize(g, **kw)

    def opt_profile():
        with profiled(cpu=True) as prof:
            opt()
        return prof
    opt_dev, _, opt_span = range_device_ms("pose_graph.optimize",
                                           opt_profile)
    opt_ms = time_ms(opt, reps=2, inner=1, warmup=1)
    saved = pose_graph.normal_equations
    pose_graph.normal_equations = lambda g_, s, R, t, f, order=None: \
        pose_graph.normal_equations_plain(g_, s, R, t, f)
    try:
        opt_ms_plain = time_ms(opt, reps=1, inner=1, warmup=0)
    finally:
        pose_graph.normal_equations = saved
    D = 7 * K
    # nodes (52 B) and weighted edges (64 B) in, the dense H (its zero
    # fill) and b out; per weighted edge 14 tangents of ~1.4 kflop through
    # the Sim(3) chain and ~4 kflop of block products
    b15, by15 = bound(K * 52 + n_act * 64 + (D * D + D + 1) * 4,
                      n_act * 24e3)
    parts = {k: device_ms(call, k) for k in ("pg_edge_kernel",
                                              "pg_block_kernel",
                                              "pg_cost_kernel", "Memset")}
    ms15 = sum(parts.values())
    return dict(
        name="pose_graph", route="cuda",
        source="morb_slam_tpu_torch/csrc/pose_graph.cu",
        replaces="morb_slam_tpu/optim/pose_graph.py:80",
        max_abs_err=max(eH, eb),
        max_abs_err_is="H: max |dH_ij| / sqrt(H_ii H_jj); b: max |db_i| / "
                       "sqrt(H_ii) over the scaled max-abs",
        err_H_jacobi=eH, err_b_scaled=eb, err_cost_rel=ec, bitwise=same,
        ms=ms15, ms_is="one normal_equations: the zero fill of H and b, "
                       "the edge, block and cost kernels",
        ms_parts=parts,
        ms_by="profiler" if not EVENT_TIMED & {
            "pg_edge_kernel", "pg_block_kernel", "pg_cost_kernel",
            "Memset"} else "cuda events",
        call_ms=time_ms(call), plain_ms=time_ms(plain, reps=3, inner=1),
        bound_ms=b15, bound_by=by15, library_ms=None,
        library_note="none: no single PyTorch call computes the Sim(3) "
                     "edge Jacobians and their block assembly",
        optimize_ms=opt_ms, optimize_ms_plain=opt_ms_plain,
        optimize_device_ms=opt_dev, optimize_span_ms=opt_span,
        ptxas=_ptxas("pose_graph"),
        shape=f"K = {K} nodes, E = {E} edges ({n_act} weighted), {nb} "
              f"touched blocks, {it} iterations, four_dof {fd}")


# ---------------------------------------------------------------------------
# the non-rectified KB8 two-camera rig (Tracker(stereo_rig=...)) and its
# kernels K16, K17 and K18
# ---------------------------------------------------------------------------

# TUM-VI's cam0 (ORB-SLAM3's TUM-VI.yaml, 512x512 KannalaBrandt8: fx, fy,
# cx, cy, k1-k4, as tests/test_cameras.py holds it) and as cam1 that cam0
# perturbed slightly, not a published calibration (focal -0.28%, centre
# -2.3 / -2.0 px, k1-k4 within 5%); cam1's centre 0.10 m to the right of
# cam0's, rotated 1 degree about y (X_cam1 = R_rl X_cam0 + t_rl)
RIG_W = RIG_H = 512
RIG_CAM0 = (190.978, 190.973, 254.932, 256.897,
            0.00348238, 0.000715034, -0.00205323, 0.000202936)
RIG_CAM1 = (190.442, 190.437, 252.597, 254.917,
            0.00340372, 0.000714185, -0.00201631, 0.000193335)
RIG_BASELINE, RIG_YAW_DEG = 0.10, 1.0
# the plane world shrunk to half size (its planes 1.6-4 m away: a room, as
# TUM-VI's are, where a 0.10 m baseline triangulates); rendered as a
# 1024 x 1024 pinhole view of focal 256 (63 degrees half-width) remapped
# by K8 into each fisheye
RIG_SCALE, RIG_SP, RIG_FP = 0.5, 1024, 256.0
RIG_N, RIG_VI_N, RIG_DT, RIG_VI_TIMED = 80, 120, 0.05, 60
RIG_IMU_NOISE = dict(noise_g=2.4e-3, noise_a=2.8e-2)   # the fisheye phase's
# K16-K18's device kernels, for the profiler's hand-written share
K16_K18_KERNELS = ("general_pairs_kernel", "triangulate_kernel",
                   "init_edge_kernel",
                   "init_assemble_kernel", "window_rows_kernel",
                   "window_cols_kernel", "window_final_kernel",
                   "refine_kernel")


def _rig_extrinsics():
    a = np.deg2rad(RIG_YAW_DEG)
    R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                  [-np.sin(a), 0.0, np.cos(a)]])
    return R, -R @ np.array([RIG_BASELINE, 0.0, 0.0])


def _kb8_source_map(cam):
    """Raw KB8 pixel -> source pinhole pixel (x, y) (RIG_H, RIG_W, 2):
    theta_d inverted by 10 Newton steps in float64, as fisheye_map."""
    fx, fy, cx, cy, k1, k2, k3, k4 = cam
    u, v = np.meshgrid(np.arange(RIG_W, dtype=np.float64),
                       np.arange(RIG_H, dtype=np.float64))
    dx, dy = (u - cx) / fx, (v - cy) / fy
    r_d = np.sqrt(dx ** 2 + dy ** 2)
    th = r_d.copy()
    for _ in range(10):
        t2 = th * th
        f = th * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - r_d
        fp = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        th = th - f / np.clip(fp, 0.5, None)
    scale = np.where(r_d > 1e-9, np.tan(np.clip(th, 0, 1.45))
                     / np.clip(r_d, 1e-9, None), 1.0)
    return np.stack([RIG_SP / 2 + RIG_FP * dx * scale,
                     RIG_SP / 2 + RIG_FP * dy * scale], -1).astype(np.float32)


def _fisheye_rig(state):
    if "fisheye_rig" not in state:
        K = np.array([[RIG_FP, 0, RIG_SP / 2], [0, RIG_FP, RIG_SP / 2],
                      [0, 0, 1.0]])
        R, t = _rig_extrinsics()
        state["fisheye_rig"] = dict(
            world=PlaneWorld(K, RIG_SP, RIG_SP, DEV), R=R, t=t,
            maps=[torch.tensor(_kb8_source_map(c), device=DEV)
                  for c in (RIG_CAM0, RIG_CAM1)])
    return state["fisheye_rig"]


def _rig_raw_pair(state, R_cw, t_cw):
    """uint8 raw (left, right) KB8 images with cam0 at T_c0_w = (R, t) of
    the shrunk world."""
    from morb_slam_tpu_torch.ops import rectify
    fr = _fisheye_rig(state)
    R = np.asarray(R_cw, np.float64)
    t = np.asarray(t_cw, np.float64)
    out = []
    for k, (Rk, tk) in enumerate(((R, t), (fr["R"] @ R,
                                           fr["R"] @ t + fr["t"]))):
        src = fr["world"].render(Rk, tk / RIG_SCALE)
        out.append(rectify.remap_bilinear(src, fr["maps"][k])
                   .clamp(0, 255).to(torch.uint8))
    return tuple(out)


def _rig_cameras():
    from morb_slam_tpu_torch import cameras
    R, t = _rig_extrinsics()
    return (cameras.kannala_brandt8(*RIG_CAM0),
            (cameras.kannala_brandt8(*RIG_CAM1),
             torch.tensor(R, dtype=torch.float32),
             torch.tensor(t, dtype=torch.float32)))


def _rig_tracker(inertial):
    from morb_slam_tpu_torch import imu
    from morb_slam_tpu_torch.pipeline import tracking
    cam0, rig = _rig_cameras()
    cfg = tracking.TrackerConfig(
        width=RIG_W, height=RIG_H, focal=RIG_CAM0[0], n_feat=1200,
        n_levels=8, max_kf=256, max_lm=16384, baseline=RIG_BASELINE)
    calib = imu.make_calib(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5,
                           3e-3, 200.0) if inertial else None
    return tracking.Tracker(cam0, cfg, imu_calib=calib, stereo_rig=rig)


def _rig_vi_pose(t):
    return analytic_pose(t, speed=RIG_SCALE)


def _imu_stage_timer(tracker):
    """Time every IMU-initialization attempt that is due (the card
    synchronized around it): a list of {ts, stage, fired, ms}."""
    stages = []
    orig = tracker._maybe_init_imu

    def init_stage(ts):
        st = tracker.viba_stage
        due = (tracker.ts_first_kf is not None
               and st < len(tracker.IMU_STAGES)
               and ts - tracker.ts_first_kf >= tracker.IMU_STAGES[st][0])
        if not due:
            return orig(ts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = orig(ts)
        torch.cuda.synchronize()
        stages.append(dict(ts=ts, stage=st, fired=tracker.viba_stage > st,
                           ms=(time.perf_counter() - t1) * 1e3))
        return r
    tracker._maybe_init_imu = init_stage
    return stages


def _rig_features(state):
    """The rig path's first pair extracted on the card (1200 features, 8
    levels) and K16's inputs from it."""
    from morb_slam_tpu_torch import cameras, frontend
    left, right = _rig_raw_pair(state, *camera_path(1)[0])
    cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
    fl = frontend.extract_orb(left.float(), cfg)
    fr = frontend.extract_orb(right.float(), cfg)
    cam0, (cam1, R, t) = _rig_cameras()
    cam0, cam1 = cam0.to(DEV), cam1.to(DEV)
    return (fl, fr, cameras.unproject_bearing(cam0, fl.uv),
            cameras.unproject_bearing(cam1, fr.uv), fl.uv, fr.uv, cam0,
            cam1, R.to(DEV), t.to(DEV),
            cfg.scale ** (2.0 * fl.octave.to(torch.float32)))


def _k16_row(state):
    """K16 against its plain version on the card at the rig path's shapes:
    the cross-checked matches and the valid flags equal except rows where
    `testing.general_margins` finds a matchable pair within 1e-5 of the
    epipolar gate or a chi2 within 1e-5 of its gate; depth within 1e-4
    relative, the matched right x exact."""
    from morb_slam_tpu_torch import testing
    from morb_slam_tpu_torch.ops import stereo
    args = _rig_features(state)
    got, gi = stereo.match_stereo_general(*args)
    want, wi = stereo.match_stereo_general_plain(*args)
    exempt = testing.general_margins(*args, gi, wi)
    same = (gi == wi) & (got.valid == want.valid)
    both = got.valid & want.valid
    rel = float(((got.depth - want.depth).abs() / want.depth.abs())[both]
                .max()) if bool(both.any()) else 0.0
    ur_same = torch.equal(got.u_right[both], want.u_right[both])
    again, ai = stereo.match_stereo_general(*args)
    repeat = torch.equal(ai, gi) and torch.equal(again.depth, got.depth)
    nl, nr = args[0].valid.shape[0], args[1].valid.shape[0]
    n_match, n_valid = int((wi >= 0).sum()), int(want.valid.sum())
    log(f"K16 stereo_general ({nl} x {nr} features): {n_match} cross-"
        f"checked matches, {n_valid} triangulated; "
        f"{int((~same).sum())} rows differ, {int(exempt.sum())} at a gate "
        f"margin; depth within {rel:.2e} relative; bitwise repeatable "
        f"{repeat}")
    check(bool((same | exempt).all()) and rel <= 1e-4 and ur_same and repeat,
          ("K16 vs plain", int((~same & ~exempt).sum()), rel, ur_same,
           repeat))
    check(n_valid > 100, ("K16: few triangulated features", n_valid))

    def call():
        return stereo.match_stereo_general(*args)

    def plain():
        return stereo.match_stereo_general_plain(*args)
    # the gate's candidates (octaves within 1, both valid, |b_r E b_l| <
    # 0.01): the pairs that need a distance
    ep = stereo.epipolar_residual(*args[2:4], *args[8:10])
    fl, fr = args[0], args[1]
    cand = (ep < stereo.EP_GATE) & (torch.abs(
        fl.octave[:, None] - fr.octave[None, :]) <= 1) & \
        fl.valid[:, None] & fr.valid[None, :]
    n_cand = int(cand.sum())
    # in: per left feature its descriptor, octave, flag, bearing, pixel and
    # sigma2 (61 B), per right feature 57 B; out: u_right, depth, valid and
    # the match (13 B). Work: the gate of every pair (~10 operations), 8
    # XOR + 8 popcount per candidate, ~300 flops of triangulation and
    # projection per cross-checked match
    b16, by16 = bound(nl * 61 + nr * 57 + nl * 13,
                      nl * nr * 10 + n_cand * 16 + n_match * 300)
    # the rows kernel starts while the pairs run and waits for them
    # (programmatic dependent launch): `ms` is the span from the pairs
    # kernel's start to the rows kernel's end
    parts = {k: device_ms(call, k) for k in ("general_pairs_kernel",
                                              "triangulate_kernel")}
    span = span_ms(call, "general_pairs_kernel", "triangulate_kernel")
    return dict(
        name="stereo_general", route="cuda",
        source="morb_slam_tpu_torch/csrc/stereo_general.cu",
        replaces="morb_slam_tpu/ops/stereo.py:123",
        max_abs_err=rel, max_abs_err_is="depth, relative, on rows valid in "
        "both", rows_differ=int((~same).sum()),
        rows_at_gate_margin=int(exempt.sum()), bitwise_repeatable=repeat,
        ms=span if span is not None else sum(parts.values()),
        ms_parts=parts,
        ms_is="one call: from the pairs kernel's start (both searches in "
              "one pass) to the rows kernel's end (the cross check and the "
              "triangulation)" if span is not None else
              "one call: the pairs and rows kernels' device times summed "
              "(the profiler gave no span)",
        ms_by="profiler span" if span is not None else
              "cuda events" if EVENT_TIMED & set(parts) else "profiler",
        kernels_per_call=kernels_per_call(call),
        call_ms=time_ms(call), plain_ms=time_ms(plain, reps=5, inner=2),
        bound_ms=b16, bound_by=by16, library_ms=None,
        library_note="none: no single PyTorch call computes a gated Hamming "
                     "argmin with its triangulation",
        candidates=n_cand, matches=n_match, triangulated=n_valid,
        ptxas=_ptxas("stereo_general"),
        shape=f"{nl} x {nr} features of a {RIG_W}x{RIG_H} KB8 pair")


def _rig_run(state, inertial):
    """One rig run through `Tracker(cam0, cfg, stereo_rig=...)`: the camera
    path through track_stereo (RIG_N pairs), or the analytic path at 20 Hz
    with its IMU samples through track_stereo_inertial (RIG_VI_N); then 5
    more frames profiled. Returns the path's dict."""
    from morb_slam_tpu_torch.optim import inertial as inertial_mod
    from morb_slam_tpu_torch.optim import vi_ba
    n = RIG_VI_N if inertial else RIG_N
    name = "rig_vi" if inertial else "rig"
    t0 = time.perf_counter()
    if inertial:
        gt = [_rig_vi_pose(i * RIG_DT) for i in range(n + 5)]
        rng = np.random.default_rng(4)
        batches = [imu_between((i - 1) * RIG_DT, i * RIG_DT, rng=rng,
                               pose_fn=_rig_vi_pose, **RIG_IMU_NOISE)
                   for i in range(n + 5)]
    else:
        gt = camera_path(n + 5, step=0.05 * RIG_SCALE)
    pairs = [_rig_raw_pair(state, R, t) for R, t in gt]
    torch.cuda.synchronize()
    log(f"{name}: {n + 5} raw KB8 pairs rendered on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    tr = _rig_tracker(inertial)
    inserts = _timed_inserts(tr)
    stages = _imu_stage_timer(tr) if inertial else []

    def feed(i, ts):
        if not inertial:
            return tr.track_stereo(pairs[i][0], pairs[i][1], ts)
        ts_i, acc, gyr = batches[i]
        return tr.track_stereo_inertial(pairs[i][0], pairs[i][1], ts, acc,
                                        gyr, ts_i)
    timed_from = RIG_VI_TIMED if inertial else 20
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    with _CountCalls([(inertial_mod, "inertial_only_optimize")],
                     timed=("inertial_only_optimize",),
                     keep_first=("inertial_only_optimize",)) as calls, \
            _EventCalls(vi_ba, "optimize_pose_inertial") as k12_calls:
        states, fm, secs, _ = _track_run(tr, feed, n, RIG_DT, inserts,
                                         timed_from=timed_from)
    kernels = ["fast_select", "orb_describe", "hamming_top2", "pose_opt",
               "pyramid_blur", "ba_assemble", "stereo_general"]
    if inertial:
        kernels += ["preintegrate", "pose_inertial", "vi_edges",
                    "inertial_init"]
    launches = _read_counters(kernels, name, state)
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    n_ok = sum(s == "OK" for s in states)
    ate, scale, ate_se3, extent, n_traj = _ate(tr, gt, RIG_DT)
    log(f"{name} trajectory: {n_traj} poses, SE3 ATE {ate_se3:.4f} m, Sim3 "
        f"ATE {ate:.4f} m, scale {scale:.4f}, over {extent:.3f} m")
    out = dict(
        fps=(n - timed_from) / secs, timed_frames=[timed_from, n - 1],
        frame_ms_p50=float(np.percentile(fm, 50)),
        frame_ms_p90=float(np.percentile(fm, 90)), frames=n, frames_ok=n_ok,
        first_state=states[0], ate_se3_m=ate_se3, ate_sim3_m=ate,
        sim3_scale=scale, extent_m=extent, kf_inserts=len(inserts),
        kf_insert_ms_each=float(np.mean(inserts)) if inserts else None,
        landmarks=int(tr.m.lm_valid.sum()),
        peak_device_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_frame={k: v / n for k, v in launches.items()})
    log(f"{name}: K2 {launches['orb_describe'] / n:.2f} launches per frame")
    if inertial:
        out["pose_inertial_call_ms"] = k12_calls.summary()
        log(f"{name}: K12 call_ms on the path {out['pose_inertial_call_ms']}")
        fired = [st for st in stages if st["fired"]]
        out.update(imu_ready=tr.imu_ready, viba_stage=tr.viba_stage,
                   imu_init_stages=fired, imu_init_attempts=len(stages),
                   inertial_only_optimize_ms=calls.ms[
                       "inertial_only_optimize"],
                   gate_se3_m=0.04 * extent)
        log(f"{name}: IMU-init stages fired "
            f"{[(st['stage'], round(st['ms'], 1)) for st in fired]} (stage, "
            f"ms); inertial_only_optimize ms per call "
            f"{[round(x, 2) for x in calls.ms['inertial_only_optimize']]}")
        check(n_ok > 0.85 * n, f"{name}: only {n_ok} of {n} OK")
        check(tr.imu_ready and tr.viba_stage >= 2,
              (f"{name}: IMU init", tr.imu_ready, tr.viba_stage))
        check(abs(scale - 1.0) < 0.06, (f"{name} scale", scale))
        check(ate_se3 < 0.04 * extent, (f"{name} SE3 ATE", ate_se3, extent))
        # the first IMU-init problem replayed under the profiler: device
        # time inside inertial_only_optimize's range and its span
        a, kw = calls.first_args["inertial_only_optimize"]

        def io_profile():
            with profiled(cpu=True) as prof:
                inertial_mod.inertial_only_optimize(*a, **kw)
            return prof
        io_dev, _, io_span = range_device_ms("inertial_only_optimize",
                                             io_profile)
        out.update(first_inertial_only_optimize_device_ms=io_dev,
                   first_inertial_only_optimize_span_ms=io_span)
    else:
        out["gate_se3_m"] = 0.03 * extent
        check(states[0] == "OK", f"{name} did not initialize on frame 0")
        check(n_ok >= 0.9 * n, f"{name}: only {n_ok} of {n} OK")
        check(abs(scale - 1.0) < 0.05, (f"{name} scale", scale))
        check(ate_se3 < 0.03 * extent, (f"{name} SE3 ATE", ate_se3, extent))
    table = state.get("profile_out")
    _path_profile(tr, lambda i: feed(i, i * RIG_DT), range(n, n + 5), name,
                  out, inserts,
                  table and table.replace(".txt", "") + f"_{name}.txt")
    log(f"{name} path:", json.dumps(out))
    return out


def phase_rig(state):
    """The fisheye two-camera rig through `Tracker(stereo_rig=...)` on the
    card: run (a), stereo, and run (b), stereo-inertial."""
    state["rig_path"] = dict(stereo=_rig_run(state, False),
                             inertial=_rig_run(state, True))


def _k17_row(state):
    """K17 against its plain version on the card on the vi path's first
    IMU-init problem: H, g and the cost at its start point within 1e-4 of
    each entry's term magnitude, two launches bitwise equal; then the whole
    inertial_only_optimize over the kernel and over the plain version."""
    from morb_slam_tpu_torch import testing
    from morb_slam_tpu_torch.optim import inertial
    a, kw = state.pop("k17_problem")
    ki, R_wb, p_wb, kf_valid = a[:4]
    K = R_wb.shape[0]
    n = 9 + 3 * K
    p = inertial.init_problem(ki, R_wb, p_wb, kf_valid,
                              kw.get("opt_scale", True),
                              kw.get("prior_gyro", 1e2),
                              kw.get("prior_acc", 1e6), kw.get("R_wg0"))
    x = torch.zeros(n, device=DEV)
    x[2] = math.log(float(kw.get("s0", 1.0)))
    if kw.get("v0") is not None:
        x[9:] = kw["v0"].reshape(-1)

    def sys_k():
        return inertial.inertial_system(p, x)

    def sys_p():
        return inertial.inertial_system_plain(p, x)
    (H, g, c), (H2, g2, c2) = sys_k(), sys_k()
    H0, g0, c0 = inertial.inertial_system_plain(p, x)
    Ha, ga, ca = testing.inertial_system_magnitudes(p, x)
    eH = float(((H - H0).abs() / Ha.clamp(min=1e-30)).max())
    eg = float(((g - g0).abs() / ga.clamp(min=1e-30)).max())
    ec = abs(float(c - c0)) / max(float(ca), 1e-30)
    same = torch.equal(H, H2) and torch.equal(g, g2) and torch.equal(c, c2)
    n_live = int(p.w.sum())

    def opt():
        return inertial.inertial_only_optimize(*a, **kw)
    got = opt()
    saved = inertial.inertial_system
    inertial.inertial_system = inertial.inertial_system_plain
    try:
        want = opt()
        opt_ms_plain = time_ms(opt, reps=2, inner=1, warmup=0)
    finally:
        inertial.inertial_system = saved
    errs = {}
    for nm, u, v in zip(("R_wg", "s", "bg", "ba", "v"), got, want):
        scale_ = float(v.abs().max()) if nm in ("bg", "ba", "v") else 1.0
        errs[nm] = float((u - v).abs().max()) / max(scale_, 1e-3) \
            if nm != "s" else abs(float(u - v)) / abs(float(v))
    log(f"K17 inertial_init (K = {K} slots, {n_live} live edges, n_par "
        f"{n}): H within {eH:.2e}, g within {eg:.2e} of their term "
        f"magnitudes, the cost within {ec:.2e}; two launches bitwise equal: "
        f"{same}; the whole optimize against plain: {errs}")
    check(eH <= 1e-4 and eg <= 1e-4 and ec <= 1e-4 and same,
          ("K17 vs plain", eH, eg, ec, same))
    check(errs["R_wg"] <= 1e-4 and errs["s"] <= 1e-4 and
          max(errs["bg"], errs["ba"], errs["v"]) <= 1e-3,
          ("inertial_only_optimize over K17 vs plain", errs))

    def opt_profile():
        with profiled(cpu=True) as prof:
            opt()
        return prof
    opt_dev, _, opt_span = range_device_ms("inertial_only_optimize",
                                           opt_profile)
    # in: every slot's weight and prev, the live edges' packed constants
    # (149 floats) and their two endpoint poses (2 x 12), and x; out: the
    # dense H, g and the cost. Work per live edge: 15 tangents of ~2.5
    # kflop through the residual, J^T Omega J and the gradient (~6 kflop);
    # the assembly reads each of the n^2 entries' terms once
    b17, by17 = bound(4 * (n * n + n + 1) + 4 * n + 8 * K
                      + n_live * (149 + 24) * 4, n_live * 44e3 + n * n)
    # the assembly launch starts while the edges run and waits for them
    # (programmatic dependent launch): its device time holds that wait, so
    # `ms` is the span from the edges' start to the assembly's end
    parts = {k: device_ms(sys_k, k) for k in ("init_edge_kernel",
                                              "init_assemble_kernel")}
    span = span_ms(sys_k, "init_edge_kernel", "init_assemble_kernel")
    return dict(
        name="inertial_init", route="cuda",
        source="morb_slam_tpu_torch/csrc/inertial_init.cu",
        replaces="morb_slam_tpu/optim/inertial.py:304",
        max_abs_err=max(eH, eg, ec),
        max_abs_err_is="H, g and cost: |kernel - plain| over each entry's "
                       "term magnitude (the same sums over absolute values)",
        err_H=eH, err_g=eg, err_cost=ec, bitwise=same, optimize_errs=errs,
        ms=span if span is not None else sum(parts.values()),
        ms_parts=parts,
        ms_is="one inertial_system: from the edge kernel's start to the "
              "assembly kernel's end" if span is not None else
              "one inertial_system: the edge and assembly kernels' device "
              "times summed (the profiler gave no span)",
        ms_by="profiler span" if span is not None else
              "cuda events" if EVENT_TIMED & set(parts) else "profiler",
        call_ms=time_ms(sys_k), plain_ms=time_ms(sys_p, reps=3, inner=1),
        bound_ms=b17, bound_by=by17, library_ms=None,
        library_note="none: no single PyTorch call computes the residual "
                     "Jacobians and their dense normal equations",
        optimize_ms=time_ms(opt, reps=3, inner=1, warmup=1),
        optimize_ms_plain=opt_ms_plain, optimize_device_ms=opt_dev,
        optimize_span_ms=opt_span, n_iters=kw.get("n_iters", 30),
        ptxas=_ptxas("inertial_init"),
        shape=f"K = {K} slots, {n_live} live edges, H ({n}, {n})")


def _k18_agree(wa, ra, where):
    """K18 against its plain versions on the card on one verification's
    inputs (window_match's wa, sim3_refine's ra): the indices equal, (s,
    R, t) within 1e-4 and the same n_good, both bitwise repeatable.
    Returns (max abs error of s, R, t, repeatable, pairs, K18's result)."""
    from morb_slam_tpu_torch.pipeline import loop_closing as lc
    idx, idx2 = lc.window_match(*wa), lc.window_match(*wa)
    idx0 = lc.window_match_plain(*wa)
    got, got2 = lc.sim3_refine(*ra), lc.sim3_refine(*ra)
    want = lc.sim3_refine_plain(*ra)
    err = max(float((u - v).abs().max()) for u, v in zip(got[:3], want[:3]))
    same = torch.equal(idx, idx2) and all(
        torch.equal(u, v) for u, v in zip(got, got2))
    n_pairs = int((idx0 >= 0).sum())
    log(f"K18 sim3_verify on {where}: window match {n_pairs} pairs, "
        f"indices equal {torch.equal(idx, idx0)}; refinement within "
        f"{err:.2e}, n_good {int(got[3])} (plain {int(want[3])}); bitwise "
        f"repeatable {same}")
    check(torch.equal(idx, idx0) and err <= 1e-4 and
          int(got[3]) == int(want[3]) and same,
          ("K18 vs plain", where, int((idx != idx0).sum()), err,
           int(got[3]), int(want[3]), same))
    return err, same, n_pairs, got


def _k18_row(state):
    """K18 against its plain versions on the card on the loop path's first
    verified candidate (replayed on the map as it stood): the window
    match's indices equal, (s, R, t) within 1e-4 and the same n_good, both
    bitwise repeatable; then the whole guided_sim3_verify over K18 and over
    the plain versions."""
    from morb_slam_tpu_torch.pipeline import loop_closing as lc
    a, kw = state.pop("k18_inputs")
    with _CountCalls([(lc, "window_match"), (lc, "sim3_refine")],
                     keep_first=("window_match", "sim3_refine")) as calls:
        lc.guided_sim3_verify(*a, **kw)
    wa, _ = calls.first_args["window_match"]
    ra, _ = calls.first_args["sim3_refine"]
    err, same, n_pairs, got = _k18_agree(wa, ra, "the loop path's first "
                                         "verified candidate")

    def call():
        return lc.guided_sim3_verify(*a, **kw)

    def plain():
        saved = lc.window_match, lc.sim3_refine
        lc.window_match, lc.sim3_refine = lc.window_match_plain, \
            lc.sim3_refine_plain
        try:
            return lc.guided_sim3_verify(*a, **kw)
        finally:
            lc.window_match, lc.sim3_refine = saved
    F = wa[0].shape[0]
    # the window gate's candidates, as window_match_plain forms it
    X2c, ok2, oct2, _, xn1, valid1, _, s0, R0, t0, focal, sc = wa
    X1p = lc.lie.sim3_apply(s0, R0, t0, X2c)
    z = X1p[:, 2]
    pred = X1p[:, :2] / torch.where(z.abs() < 1e-6,
                                    torch.full_like(z, 1e-6), z)[:, None]
    rad = 7.5 / focal * sc ** oct2.float()
    gate = (((pred[:, None] - xn1[None]) ** 2).sum(-1) < (rad ** 2)[:, None]) \
        & (z > 0.05)[:, None] & ok2[:, None] & valid1[None, :]
    n_cand = int(gate.sum())
    n_f, n_b = int(ra[5].sum()), int(ra[6].sum())
    # in: the candidate's descriptors, points, flags, octaves (49 B a
    # feature), the keyframe's descriptors, observations, flags (41 B), the
    # refinement's points, observations and weights (46 B); out: the
    # match (4 B) and (s, R, t, n_good). Work: the window gate of every
    # pair (~8 flops), 8 XOR + 8 popcount per candidate, and per GN step
    # 8 evaluations of each active residual (~80 flops) and a 7 x 7 solve
    b18, by18 = bound(F * (49 + 41 + 46 + 4) + 56,
                      F * F * 8 + n_cand * 16
                      + 12 * (n_f + n_b) * 8 * 80 + 10 * 7 ** 3)
    parts = {k: device_ms(call, k) for k in (
        "window_rows_kernel", "window_cols_kernel", "window_final_kernel",
        "refine_kernel")}

    def gv_profile():
        with profiled(cpu=True) as prof:
            call()
        return prof
    gv_dev, _, gv_span = range_device_ms("guided_sim3_verify", gv_profile)
    ptx = _ptxas("sim3_verify")
    check(ptx.count(" 0 bytes spill stores, 0 bytes spill loads")
          == ptx.count("spill stores"), ("K18 spills", ptx))
    return dict(
        name="sim3_verify", route="cuda",
        source="morb_slam_tpu_torch/csrc/sim3_verify.cu",
        replaces="morb_slam_tpu/pipeline/loop_closing.py:78",
        counters=["sim3_window", "sim3_refine"],
        max_abs_err=err, max_abs_err_is="s, R, t; the window match's "
        "indices exact", bitwise=same, pairs=n_pairs, candidates=n_cand,
        n_good=int(got[3]),
        ms=sum(parts.values()), ms_parts=parts,
        refine_ms=parts["refine_kernel"],
        window_ms=sum(v for k, v in parts.items() if k != "refine_kernel"),
        ms_is="one guided_sim3_verify's K18 kernels: the window match's "
              "three and the refinement's",
        ms_by="cuda events" if EVENT_TIMED & set(parts) else "profiler",
        call_ms=time_ms(call, reps=5, inner=2),
        plain_ms=time_ms(plain, reps=3, inner=1),
        guided_sim3_verify_device_ms=gv_dev,
        guided_sim3_verify_span_ms=gv_span,
        bound_ms=b18, bound_by=by18, library_ms=None,
        library_note="none: no single PyTorch call computes a window-gated "
                     "Hamming match or a Sim(3) Gauss-Newton loop",
        ptxas=ptx,
        shape=f"F = {F} features per keyframe, {n_cand} window candidates, "
              f"{n_f} + {n_b} refined residuals")


# ---------------------------------------------------------------------------
# persistence, trajectory output and the dataset entry point
# ---------------------------------------------------------------------------

PERSIST_DT = 0.05
PERSIST_REVISIT = (10, 11, 12, 13)     # the JAX lifecycle test's revisit
ATLAS_FWD = 24                         # test_atlas.py:134: 24 out, 23 back


def _persist_settings(**kw):
    from morb_slam_tpu_torch.io import config
    return config.Settings(
        cam1=config.CameraSettings(model="PinHole", fx=FX, fy=FX, cx=W / 2,
                                   cy=H / 2, width=W, height=H),
        n_features=1200, n_levels=8, scale_factor=1.2, **kw)


PERSIST_OVERRIDES = dict(max_kf=256, max_lm=16384, min_init_matches=80,
                         min_init_points=50)


def _atlas_mb(path):
    return sum(os.path.getsize(path + ext) for ext in (".npz", ".json")) / 2**20


def _timed(fn, *a):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn(*a)
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def phase_persist(state):
    """The JAX lifecycle test (tests/test_system.py:24) at the mono path's
    size through `System(..., Sensor.MONOCULAR, vocabulary=...)` on the
    card: track, write every trajectory format, score the TUM file with
    eval.ate against a ground truth written by the same writer, save the
    Atlas, load it into fresh Systems (load_atlas and settings.load_atlas)
    and relocalize in localization mode; then test_atlas.py:134's stash,
    save, reload and merge on revisit."""
    import dataclasses
    import tempfile
    from morb_slam_tpu_torch import system
    from morb_slam_tpu_torch.eval import ate as ate_mod
    from morb_slam_tpu_torch.io import trajectory
    world, poses = _world(state)
    voc = _vocabulary(state)
    frames = [world.render(*p).clamp(0, 255).to(torch.uint8) for p in poses]
    torch.cuda.synchronize()
    out = {}
    _reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        sys1 = system.System(_persist_settings(), system.Sensor.MONOCULAR,
                             vocabulary=voc,
                             tracker_overrides=PERSIST_OVERRIDES)
        inserts = _timed_inserts(sys1.tracker)
        states, fm, secs, _ = _track_run(
            sys1.tracker, lambda i, ts: sys1.track_monocular(frames[i], ts),
            N_FRAMES, PERSIST_DT, inserts)
        n_ok = sum(s == "OK" for s in states)
        check(states[-1] == "OK" and n_ok >= 0.7 * N_FRAMES,
              ("persist: tracking", n_ok, states[-1]))
        f = {k: os.path.join(tmp, k) for k in (
            "traj.txt", "traj.csv", "traj.kitti", "kf.txt", "sub.txt",
            "gt.txt", "atlas", "atlas2")}
        _, tum_ms = _timed(sys1.save_trajectory_tum, f["traj.txt"])
        sys1.save_trajectory_euroc(f["traj.csv"])
        sys1.save_trajectory_kitti(f["traj.kitti"])
        sys1.save_keyframe_trajectory_tum(f["kf.txt"])
        sys1.save_sub_trajectory(f["sub.txt"], 1.0, 2.0)
        trajectory.write_tum(f["gt.txt"], [
            (i * PERSIST_DT, R, t) for i, (R, t) in
            enumerate(poses[:N_FRAMES])])
        ts_r, pos_r, _ = trajectory.read_tum(f["traj.txt"])
        n_lines = {k: sum(1 for line in open(f[k]) if line.strip()
                          and not line.startswith("#"))
                   for k in ("traj.txt", "traj.csv", "traj.kitti", "kf.txt",
                             "sub.txt")}
        res = ate_mod.evaluate(f["gt.txt"], f["traj.txt"], with_scale=True)
        c = [-(np.asarray(R, np.float64).T @ t) for R, t in poses[:N_FRAMES]]
        extent = float(np.linalg.norm(c[-1] - c[0]))
        log(f"persist: {n_ok}/{N_FRAMES} OK, {len(ts_r)} TUM poses, lines "
            f"{n_lines}, eval.ate Sim3 RMSE {res['rmse']:.5f} m over "
            f"{res['pairs']} pairs (gate {0.023 * extent:.5f})")
        check(n_lines["traj.txt"] == n_lines["traj.csv"] ==
              n_lines["traj.kitti"] > 0.7 * N_FRAMES, ("lines", n_lines))
        check(0 < n_lines["sub.txt"] < n_lines["traj.txt"], n_lines)
        check(n_lines["kf.txt"] == int(sys1.tracker.m.kf_valid.sum()),
              ("keyframe lines", n_lines["kf.txt"]))
        check(res["rmse"] < 0.023 * extent, ("persist ATE", res, extent))
        pc = sys1.map_point_cloud()
        check(pc.ndim == 2 and pc.shape[1] == 3 and pc.shape[0] > 200 and
              np.isfinite(pc).all(), ("point cloud", pc.shape))
        _, save_ms = _timed(sys1.save_atlas, f["atlas"])
        mb = _atlas_mb(f["atlas"])

        def relocalize(sm):
            t_before = sm.tracker.n_kf_host
            sm.activate_localization_mode()
            check(sm.state == "RECENTLY_LOST", ("after load", sm.state))
            st = [sm.track_monocular(frames[i], 100.0 + i)[0]
                  for i in PERSIST_REVISIT]
            check("OK" in st, ("no relocalization after load", st))
            check(sm.tracker.n_kf_host == t_before,
                  ("localization mode added keyframes",
                   sm.tracker.n_kf_host, t_before))
            return st.index("OK"), st

        sys2 = system.System(_persist_settings(), system.Sensor.MONOCULAR,
                             vocabulary=voc,
                             tracker_overrides=PERSIST_OVERRIDES)
        _, load_ms = _timed(sys2.load_atlas, f["atlas"])
        t1, t2 = sys1.tracker, sys2.tracker
        check((t2.n_kf_host, t2.map_gen, len(t2.trajectory)) ==
              (t1.n_kf_host, t1.map_gen, len(t1.trajectory)),
              "the loaded Atlas's counters differ")
        check(all(a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
                  for a, b in zip(t1.m, t2.m)),
              "the loaded map differs from the saved one")
        first_ok, st2 = relocalize(sys2)
        sys3 = system.System(
            _persist_settings(load_atlas=f["atlas"]),
            system.Sensor.MONOCULAR, vocabulary=voc,
            tracker_overrides=PERSIST_OVERRIDES)
        first_ok3, st3 = relocalize(sys3)
        log(f"persist: Atlas {mb:.2f} MB saved in {save_ms:.1f} ms, loaded "
            f"in {load_ms:.1f} ms; revisit states {st2} (settings.load_atlas"
            f": {st3})")
        out.update(
            fps=(N_FRAMES - 20) / secs, frames_ok=n_ok,
            kf_inserts=len(inserts), keyframes=t1.n_kf_host,
            ate_sim3_m=res["rmse"], ate_pairs=res["pairs"], extent_m=extent,
            trajectory_lines=n_lines, save_tum_ms=tum_ms,
            point_cloud_points=int(pc.shape[0]), atlas_mb=mb,
            save_atlas_ms=save_ms, load_atlas_ms=load_ms,
            first_ok_revisit_after_load=first_ok,
            first_ok_revisit_after_settings_load=first_ok3,
            revisit_states=st2)

        # test_atlas.py:134 at this size: 24 frames out, a new map at the
        # turn, 6 frames, save, reload into a fresh System, the rest back
        seq = list(range(ATLAS_FWD)) + list(range(ATLAS_FWD - 2, -1, -1))
        cut = ATLAS_FWD
        sa = system.System(_persist_settings(), system.Sensor.MONOCULAR,
                           vocabulary=voc,
                           tracker_overrides=PERSIST_OVERRIDES)
        for i, k in enumerate(seq[:cut + 6]):
            if i == cut:
                sa.tracker.create_map_in_atlas()
            sa.track_monocular(frames[k], float(i))
        check(len(sa.tracker.stash) == 1, "persist: no stashed map")
        sa.tracker.flush()
        n_traj = len(sa.tracker.trajectory)
        _, save2_ms = _timed(sa.save_atlas, f["atlas2"])
        sb = system.System(_persist_settings(), system.Sensor.MONOCULAR,
                           vocabulary=voc,
                           tracker_overrides=PERSIST_OVERRIDES)
        _, load2_ms = _timed(sb.load_atlas, f["atlas2"])
        tb = sb.tracker
        check(len(tb.stash) == 1 and tb.stash[0].db is not None and
              tb.map_gen == sa.tracker.map_gen and
              len(tb.trajectory) == n_traj and tb.state == "RECENTLY_LOST",
              "persist: the stash did not survive the round trip")
        merged_at = None
        for i, k in enumerate(seq[cut + 6:], start=cut + 6):
            sb.track_monocular(frames[k], float(i))
            if merged_at is None and any(st.merged_into_gen >= 0
                                         for st in tb.stash):
                merged_at = i
        tb.flush()
        traj = tb.trajectory_world()
        log(f"persist: stash Atlas {_atlas_mb(f['atlas2']):.2f} MB, saved in "
            f"{save2_ms:.1f} ms, loaded in {load2_ms:.1f} ms; merged on "
            f"frame {merged_at}, {len(traj)} poses resolved")
        check(merged_at is not None, "restored stash never merged on revisit")
        check(len(traj) > 0.5 * len(seq), ("resolved poses", len(traj)))
        out.update(stash_atlas_mb=_atlas_mb(f["atlas2"]),
                   stash_save_ms=save2_ms, stash_load_ms=load2_ms,
                   merged_on_frame=merged_at, merged_poses=len(traj),
                   sequence_frames=len(seq))
    out["launches"] = _read_counters(
        ["fast_select", "orb_describe", "hamming_top2", "pose_opt",
         "ba_assemble", "pyramid_blur", "vocab_transform", "bow_l1"],
        "persist", state)
    log("persist path:", json.dumps(out))
    state["persist"] = out


def write_png_gray(path, a):
    """An 8-bit grey PNG of a uint8 (H, W) array, with Python's zlib and
    struct only (the card's machine has no image library)."""
    import struct
    import zlib
    a = np.ascontiguousarray(a, np.uint8)
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(a.shape[0]))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", a.shape[1],
                                             a.shape[0], 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def phase_euroc_synth(state):
    """The bench's euroc cell function (`run_dataset.evaluate_sequence`)
    on a sequence this script writes: the mono path's poses rendered with
    the stereo rig's raw, radtan-distorted EuRoC cam0 as 8-bit PNGs in
    EuRoC's layout (mav0/cam0/data/*.png, data.csv,
    state_groundtruth_estimate0/data.csv); read back by the port's native
    loader, tracked by System on the card, aligned to the ground truth."""
    import tempfile
    from morb_slam_tpu_torch import lie
    from morb_slam_tpu_torch.examples import run_dataset
    world, poses = _world(state)
    rays0, _ = _rig(state)["rays"]
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "mav0", "cam0", "data")
        gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
        os.makedirs(data)
        os.makedirs(gt_dir)
        t0 = time.perf_counter()
        rows, gt = [], []
        for i, (R, t) in enumerate(poses[:N_FRAMES]):
            ts_ns = i * 50_000_000
            img = world.render_points(np.asarray(R, np.float64),
                                      np.asarray(t, np.float64), rays0,
                                      np.eye(3), (H, W))[0]
            write_png_gray(os.path.join(data, f"{ts_ns}.png"),
                           img.clamp(0, 255).to(torch.uint8).cpu().numpy())
            rows.append(f"{ts_ns},{ts_ns}.png")
            Rwc = np.asarray(R, np.float64).T
            c = -Rwc @ np.asarray(t, np.float64)
            q = lie.rotmat_to_quat(torch.tensor(Rwc)).numpy()
            gt.append(f"{ts_ns},{c[0]:.9f},{c[1]:.9f},{c[2]:.9f},{q[3]:.9f},"
                      f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f}")
        with open(os.path.join(root, "mav0", "cam0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
        with open(os.path.join(gt_dir, "data.csv"), "w") as f:
            f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                    "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n"
                    + "\n".join(gt) + "\n")
        write_s = time.perf_counter() - t0
        png_mb = sum(os.path.getsize(os.path.join(data, n))
                     for n in os.listdir(data)) / 2 ** 20
        _reset_counters()
        t0 = time.perf_counter()
        res = run_dataset.evaluate_sequence(root, "mono", device=DEV)
        run_s = time.perf_counter() - t0
    launches = _read_counters(["fast_select", "orb_describe", "hamming_top2",
                               "pose_opt", "ba_assemble", "pyramid_blur"],
                              "euroc_synth", state)
    c0 = -(np.asarray(poses[0][0]).T @ poses[0][1])
    c1 = -(np.asarray(poses[N_FRAMES - 1][0]).T @ poses[N_FRAMES - 1][1])
    extent = float(np.linalg.norm(c1 - c0))
    out = dict(res, extent_m=extent, ate_gate_m=0.023 * extent,
               png_write_s=write_s, png_mb=png_mb, evaluate_s=run_s,
               launches=launches)
    log(f"euroc_synth: {res['ok_frames']}/{res['frames']} OK, "
        f"{res['keyframes']} keyframes, {res['fps']} fps (decode included), "
        f"Sim3 ATE {res.get('ate_rmse')} m (gate {0.023 * extent:.5f}); "
        f"{N_FRAMES} PNGs ({png_mb:.1f} MB) written in {write_s:.1f} s")
    check(res["ok_frames"] >= 0.7 * res["frames"],
          ("euroc_synth OK frames", res))
    check("ate_rmse" in res and res["ate_rmse"] < 0.023 * extent,
          ("euroc_synth ATE", res, extent))
    log("euroc_synth path:", json.dumps(out))
    state["euroc_synth"] = out


def _ptxas(name):
    from morb_slam_tpu_torch.ops import cuda_build
    return cuda_build.ptxas_report(name).strip().replace("\n", " | ")


def phase_new_kernels(state):
    """K13 on the vi path's last window problem, K15 on the loop path's
    last essential graph, K17 on the vi path's first IMU-init problem and
    K18 on the loop path's first verified candidate (their rows join the
    kernels line)."""
    rows = state.setdefault("kernel_rows", [])
    pv, kw = state.pop("k13_problem")
    rows.append(_k13_row(pv, kw))
    g, kw = state.pop("k15_graph")
    rows.append(_k15_row(g, kw))
    rows.append(_k17_row(state))
    rows.append(_k18_row(state))
    for r in state["kernel_rows"][-4:]:
        log(f"  {r['name']}: {r['ms']:.4f} ms on the card, "
            f"{r['call_ms']:.4f} ms per call by events (plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']})")


def _device_by_kernel(fn, reps=3):
    """Device milliseconds per fn() by kernel name (the profiler), the
    profiler's ranges left out."""
    fn()
    torch.cuda.synchronize()
    with profiled() as prof:
        for _ in range(reps):
            fn()
    return {ev.key: ev.self_device_time_total / reps / 1e3
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.key not in RANGES and ev.self_device_time_total > 0}


def _close(got, want, atol, what, rtol=0.0):
    """Fail unless |got - want| <= atol + rtol |want| everywhere (numpy's
    assert_allclose); returns the largest |got - want|."""
    d = (got - want).abs()
    check(bool((d <= atol + rtol * want.abs()).all()),
          (what, float(d.max()), atol, rtol))
    return float(d.max())


def phase_sharded(state):
    """The multi-device slice (`parallel/`, `top_candidates_sharded`) on one
    rank of an nccl group, the card's: the mesh from `global_obs_mesh()`;
    `pad_problem_for_mesh` and `partition_problem_by_lm` at the loop
    phase's capacities; `ba_solve_sharded` on a local window (20
    keyframes, 1,200 landmarks, 24,000 observations) against `ba_solve` at
    tests/test_sharded_ba.py's tolerances; `ba_solve_pcg_sharded` and
    `ba_solve_pcg_lm_sharded` at the capacities against `ba_solve_pcg`:
    one LM step within testing.PCG_TOL of the step's max-abs, four steps'
    costs within 1e-3 relative; `top_candidates_sharded` on a 256 x 10^4
    database against `top_candidates`; `global_ba_distributed` and
    `ba_scaling_efficiency` (a one-rank figure). The counted run shows K4
    (both modes), K14's passes and K10 launched and no plain version;
    then the device ms of a CG iteration of the observation-sharded solve
    and the all_reduces' share of it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from morb_slam_tpu_torch import testing
    from morb_slam_tpu_torch.optim import ba
    from morb_slam_tpu_torch.parallel import distributed, sharded_ba
    from morb_slam_tpu_torch.vocab import database as kfdb
    t0 = time.perf_counter()
    mesh = distributed.global_obs_mesh()
    check(dist.get_backend() == "nccl" and mesh.size() == 1 and
          mesh.device_type == "cuda", ("sharded: the mesh", mesh))
    kf_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("kf",))
    pad = sharded_ba.pad_problem_for_mesh
    pl, pg = _window_problem(), _global_problem()
    O = pg.obs_uv.shape[0]
    p7 = pad(pg, 7)
    n_pad = p7.obs_uv.shape[0] - O
    check(n_pad == (-O) % 7 and not bool(p7.obs_mask[O:].any()) and
          bool(torch.isnan(p7.obs_ur[O:]).all()) and
          not bool(p7.obs_info[O:].any()), "sharded: the padding")
    pn, new2old = sharded_ba.partition_problem_by_lm(pg, 1)
    n_act = int(pg.obs_mask.sum())
    check(int(pn.obs_mask.sum()) == n_act and
          pn.obs_uv.shape[0] == -(-n_act // 8) * 8 and
          bool((new2old == torch.arange(pg.X.shape[0], device=DEV)).all()),
          "sharded: the one-block partition")
    rng = np.random.default_rng(5)
    bow = rng.random((256, 10 ** 4)) * (rng.random((256, 10 ** 4)) < 0.05)
    bow = torch.from_numpy((bow / bow.sum(1, keepdims=True))
                           .astype(np.float32)).to(DEV)
    db = kfdb.KeyframeDatabase(bow=bow, valid=torch.from_numpy(
        rng.random(256) < 0.8).to(DEV))
    q = bow[31]
    # the single-device references, outside the counted run
    ref_d = ba.ba_solve(pl, n_iters=6)
    ref_p = ba.ba_solve_pcg(pg, n_iters=4, cg_iters=40)
    ref_q = kfdb.top_candidates(db, q, 5)
    torch.cuda.synchronize()

    _reset_counters()
    got_d = sharded_ba.ba_solve_sharded(pad(pl, 1), mesh, n_iters=6)
    got_p = sharded_ba.ba_solve_pcg_sharded(pad(pg, 1), mesh, n_iters=4,
                                            cg_iters=40)
    got_l = sharded_ba.ba_solve_pcg_lm_sharded(pn, mesh, n_iters=4,
                                               cg_iters=40)
    got_q = kfdb.top_candidates_sharded(db, q, 5, kf_mesh)
    gba = distributed.global_ba_distributed(pg, mesh, n_iters=2,
                                            cg_iters=24)
    eff = distributed.ba_scaling_efficiency(pg, n_iters=1, cg_iters=12,
                                            mesh=mesh)
    torch.cuda.synchronize()
    launches = _read_counters(["ba_assemble", "ba_assemble_per_obs",
                               "schur_passes", "bow_l1"], "sharded", state)
    check(_kernel_counters()["schur_pcg"]["kernel"] == 0,
          "sharded: K14's one-launch solve ran in the sharded solvers")

    out = {"launches": launches, "backend": dist.get_backend(),
           "mesh_size": mesh.size()}
    R1, t1, X1, i1 = ref_d
    R, t, X, info = got_d
    out["dense_bitwise"] = all(torch.equal(a, b) for a, b in
                               ((R, R1), (t, t1), (X, X1)))
    out["dense_err"] = dict(
        R=_close(R, R1, 1e-5, "ba_solve_sharded R"),
        t=_close(t, t1, 1e-5, "ba_solve_sharded t"),
        X=_close(X, X1, 1e-4, "ba_solve_sharded X"),
        costs=_close(info["costs"], i1["costs"], 0.0, "costs", rtol=1e-4))
    # the PCG forms: one LM step against the single-device step within
    # testing.PCG_TOL of the step's max-abs (as K14's solve is held to its
    # plain version: weakly seen landmarks make later steps differ by more
    # than the rounding of one), the 4-step costs within 1e-3 relative
    Rp, tp, Xp, ip = ref_p
    for name, (R, t, X, info) in (("ba_solve_pcg_sharded", got_p),
                                  ("ba_solve_pcg_lm_sharded", got_l)):
        out[f"{name}_costs_rel"] = float(
            ((info["costs"] - ip["costs"]).abs() / ip["costs"]).max())
        check(out[f"{name}_costs_rel"] <= 1e-3 and
              float(info["costs"][-1]) < 0.8 * float(info["cost0"]),
              (name, "costs", info["costs"].tolist(), ip["costs"].tolist()))
    Rs, ts, Xs, _ = ba.ba_solve_pcg(pg, n_iters=1, cg_iters=40)
    keep = new2old >= 0
    for name, (R, t, X, _) in (
            ("ba_solve_pcg_sharded", sharded_ba.ba_solve_pcg_sharded(
                pad(pg, 1), mesh, n_iters=1, cg_iters=40)),
            ("ba_solve_pcg_lm_sharded", sharded_ba.ba_solve_pcg_lm_sharded(
                pn, mesh, n_iters=1, cg_iters=40))):
        if name.endswith("lm_sharded"):
            X_back = torch.zeros_like(Xs)
            X_back[new2old[keep]] = X[keep]
            X = X_back
        rel = {k: float((a - b).abs().max()) / max(
            float((b - s0).abs().max()), 1e-30)
            for k, a, b, s0 in (("R", R, Rs, pg.R), ("t", t, ts, pg.t),
                                ("X", X, Xs, pg.X))}
        out[f"{name}_step_rel"] = rel
        check(max(rel.values()) <= testing.PCG_TOL, (name, "one step", rel))
    check(torch.equal(got_q[0], ref_q[0]) and torch.equal(got_q[2], ref_q[2]),
          ("top_candidates_sharded ids", got_q, ref_q))
    out["place_recognition_err"] = _close(got_q[1], ref_q[1], 1e-5,
                                          "top_candidates_sharded scores")
    costs = gba[3]["costs"]
    check(float(costs[-1]) < 0.8 * float(gba[3]["cost0"]),
          ("global_ba_distributed cost", gba[3]))
    out["efficiency_one_rank"] = dict(zip(("ips_full", "ips_1",
                                           "efficiency"), eff))
    log(f"sharded: one nccl rank; ba_solve_sharded vs ba_solve "
        f"{out['dense_err']} (bitwise {out['dense_bitwise']}); "
        f"against ba_solve_pcg, one LM step relative to the step: "
        f"ba_solve_pcg_sharded {out['ba_solve_pcg_sharded_step_rel']}, "
        f"ba_solve_pcg_lm_sharded "
        f"{out['ba_solve_pcg_lm_sharded_step_rel']}; 4 steps' costs "
        f"{out['ba_solve_pcg_sharded_costs_rel']:.1e}, "
        f"{out['ba_solve_pcg_lm_sharded_costs_rel']:.1e} relative; "
        f"top_candidates_sharded ids equal, scores within "
        f"{out['place_recognition_err']:.1e}; ba_scaling_efficiency (one "
        f"rank) {out['efficiency_one_rank']}")

    # device ms a CG iteration of the observation-sharded solve: one LM
    # step at 8 and at 40 CG iterations, the difference over 32
    p1 = pad(pg, 1)
    by = {c: _device_by_kernel(lambda c=c: sharded_ba.ba_solve_pcg_sharded(
        p1, mesh, n_iters=1, cg_iters=c)) for c in (8, 40)}

    def per_iter(match):
        return sum(v for k, v in by[40].items() if match(k)) / 32 - \
            sum(v for k, v in by[8].items() if match(k)) / 32
    cg = per_iter(lambda k: True)
    nccl = per_iter(lambda k: "nccl" in k.lower())
    passes = per_iter(lambda k: "schur_lm_kernel" in k or
                      "schur_kf_kernel" in k)
    out["cg_iteration_device_ms"] = cg
    out["cg_iteration_all_reduce_ms"] = nccl
    out["cg_iteration_all_reduce_share"] = nccl / cg if cg > 0 else None
    out["cg_iteration_k14_passes_ms"] = passes
    out["step_kernels_ms_40_cg"] = by[40]
    # a CG iteration's two all_reduces, by CUDA events (a one-rank nccl
    # group may run them without a kernel of their own)
    group = mesh.get_group()
    bufs = [torch.zeros(pg.X.shape[0] * 3, device=DEV),
            torch.zeros(pg.R.shape[0] * 6, device=DEV)]
    out["all_reduce_call_ms"] = {
        n: time_ms(lambda b=b: dist.all_reduce(b, group=group))
        for n, b in zip(("(L, 3)", "(K, 6)"), bufs)}
    out["cg_iteration_call_ms"] = (time_ms(
        lambda: sharded_ba.ba_solve_pcg_sharded(p1, mesh, n_iters=1,
                                                cg_iters=40), reps=3,
        inner=1) - time_ms(lambda: sharded_ba.ba_solve_pcg_sharded(
            p1, mesh, n_iters=1, cg_iters=8), reps=3, inner=1)) / 32
    out["solve_call_ms"] = time_ms(lambda: sharded_ba.ba_solve_pcg_sharded(
        p1, mesh, n_iters=1, cg_iters=40), reps=3, inner=1)
    out["shape"] = (f"window K 20, L 1,200, O 24,000; global K {LOOP_K}, L "
                    f"{LOOP_L}, O {O} ({n_act} active); database 256 x "
                    f"10^4")
    log(f"sharded: a CG iteration {cg:.4f} ms of device time, the "
        f"all_reduces' kernels {nccl:.4f} ms of it, K14's passes "
        f"{passes:.4f} ms; by events a CG iteration "
        f"{out['cg_iteration_call_ms']:.4f} ms, an all_reduce "
        f"{out['all_reduce_call_ms']} ms; a one-step solve (40 CG "
        f"iterations) {out['solve_call_ms']:.2f} ms; phase "
        f"{time.perf_counter() - t0:.1f} s")
    state["sharded"] = out
    dist.destroy_process_group()


def _window_problem(seed=40, n_kfs=20, n_pts=1200):
    """tests/test_optim.py's `build_problem` at a local window's size: 20
    keyframes over 2 m along x (the first two fixed), each seeing all
    1,200 landmarks (24,000 observations) with 0.5 px of noise, 30% of
    them in stereo (0.11 m), the poses and points perturbed from a second
    seed."""
    from morb_slam_tpu_torch import lie
    from morb_slam_tpu_torch.optim import ba
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa
                                  device=DEV)
    X = f(rng.uniform([-3, -2, 4], [3, 2, 10], (n_pts, 3)))
    xi = np.zeros((n_kfs, 6))
    xi[:, 0] = 2.0 * np.arange(n_kfs) / (n_kfs - 1)
    xi[:, 3:] = rng.normal(0, 0.02, (n_kfs, 3))
    R, t = lie.se3_exp(f(xi))
    Xc = lie.se3_apply(R[:, None], t[:, None], X[None])
    uv = Xc[..., :2] / Xc[..., 2:3] + f(rng.normal(0, 0.5 / FX, (n_kfs,
                                                               n_pts, 2)))
    r2 = np.random.default_rng(99)
    dxi = f(np.concatenate([np.zeros((2, 6)),
                            r2.normal(0, 0.01, (n_kfs - 2, 6))]))
    dR, dt = lie.se3_exp(dxi)
    R0, t0 = lie.se3_mul(dR, dt, R, t)
    O = n_kfs * n_pts
    ur = (Xc[..., 0] - 0.11) / Xc[..., 2] + f(rng.normal(0, 0.5 / FX, (
        n_kfs, n_pts)))
    ur = torch.where(f(rng.random((n_kfs, n_pts))) < 0.3, ur,
                     torch.full_like(ur, float("nan")))
    kf_opt = torch.ones(n_kfs, dtype=torch.bool, device=DEV)
    kf_opt[:2] = False
    return ba.make_problem(
        R0, t0, X + f(r2.normal(0, 0.05, (n_pts, 3))),
        torch.arange(n_kfs, dtype=torch.int32,
                     device=DEV).repeat_interleave(n_pts),
        torch.arange(n_pts, dtype=torch.int32, device=DEV).repeat(n_kfs),
        uv.reshape(O, 2), torch.full((O,), FX ** 2, device=DEV),
        torch.ones(O, dtype=torch.bool, device=DEV), kf_opt,
        torch.ones(n_pts, dtype=torch.bool, device=DEV),
        obs_ur=ur.reshape(O), baseline=0.11)


def ba_iters_row():
    """bench.py:398's ba_iters_per_s problem (K 20, L 6,144, O 24,000, 10
    LM iterations, seed 0) through the port's ba_solve on the card."""
    from morb_slam_tpu_torch.optim import ba
    rng = np.random.default_rng(0)
    K, L, O = 20, 6144, 24000
    kf_opt = torch.ones(K, dtype=torch.bool, device=DEV)
    kf_opt[:2] = False
    p = ba.make_problem(
        R=torch.eye(3, device=DEV).expand(K, 3, 3).contiguous(),
        t=torch.zeros((K, 3), device=DEV),
        X=torch.tensor(rng.normal(0, 1, (L, 3)), dtype=torch.float32,
                       device=DEV) + torch.tensor([0, 0, 5.0], device=DEV),
        obs_kf=torch.tensor(rng.integers(0, K, O), dtype=torch.int32,
                            device=DEV),
        obs_lm=torch.tensor(rng.integers(0, L, O), dtype=torch.int32,
                            device=DEV),
        obs_uv=torch.tensor(rng.normal(0, 0.2, (O, 2)), dtype=torch.float32,
                            device=DEV),
        obs_info=torch.full((O,), 1e5, device=DEV),
        obs_mask=torch.ones(O, dtype=torch.bool, device=DEV), kf_opt=kf_opt,
        lm_opt=torch.ones(L, dtype=torch.bool, device=DEV))

    def solve():
        return ba.ba_solve(p, n_iters=10)
    ms = time_ms(solve, reps=5, inner=1, warmup=1)
    row = dict(name="ba_iters_per_s", route="cuda (K4 in ba_solve)",
               source="morb_slam_tpu_torch/optim/ba.py",
               replaces="bench.py:398 ba_iters_per_s", ms_per_solve=ms,
               iters_per_s=10.0 / ms * 1e3,
               device_ms_per_solve=device_ms(solve, None, reps=3),
               shape=f"K = {K}, L = {L}, O = {O}, 10 LM iterations, seed 0")
    log(f"ba_iters_per_s: {row['iters_per_s']:.1f} iterations/s, {ms:.2f} "
        f"ms per 10-iteration solve")
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile-out", default=None,
                    help="write the main path's profiler op table here")
    ap.add_argument("--vi-seeds", default=None,
                    help="comma-separated IMU noise seeds: run only the vi "
                         "path once per seed and print its accuracy")
    ap.add_argument("--loop-variants", action="store_true",
                    help="run only the loop path, at the System's own "
                         "tracker settings pipelined and not, and at the "
                         "loop test's settings pipelined, and print which "
                         "of its gates each run meets")
    ap.add_argument("--pcg-ab", type=int, default=0, metavar="N",
                    help="run only the loop path at the System's own "
                         "tracker settings pipelined, 2 N times, its global "
                         "BA alternately over K14's solve and over the "
                         "plain solve (kernel, plain, plain, kernel, ...), "
                         "and print which of its gates each run meets")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after the device "
                         "phase (for trying one path; the kernel rows they "
                         "measured are printed, not the kernels line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    state = {"profile_out": args.profile_out}
    if args.vi_seeds:
        phase_device(state)
        vi_seed_sweep(state, [int(x) for x in args.vi_seeds.split(",")])
        return
    if args.loop_variants:
        phase_device(state)
        for variant in (("system", True), ("system", False), ("test", True)):
            phase_loop(state, variant)
            torch.cuda.empty_cache()
        return
    if args.pcg_ab:
        phase_device(state)
        for i in range(2 * args.pcg_ab):
            solve = ("kernel", "plain solve")[(i + i // 2) % 2]
            phase_loop(state, ("system", True, solve))
            torch.cuda.empty_cache()
        return
    phases = (("device", phase_device), ("kernels", phase_kernels),
              ("main", phase_main), ("stereo", phase_stereo),
              ("rgbd", phase_rgbd), ("reloc", phase_reloc), ("vi", phase_vi),
              ("loop", phase_loop), ("merge", phase_merge),
              ("vi_loop", phase_vi_loop), ("fisheye", phase_fisheye),
              ("persist", phase_persist), ("euroc_synth", phase_euroc_synth),
              ("rig", phase_rig), ("new_kernels", phase_new_kernels),
              ("sharded", phase_sharded))
    only = args.only and ["device"] + args.only.split(",")
    state["plain_rows"] = []
    for name, phase in phases:
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        log(f"== phase {name}")
        phase(state)
        log(f"== phase {name} done in {time.perf_counter() - t0:.1f} s")
    if only:
        log(json.dumps({"kernel_rows_of_this_run":
                        state.get("kernel_rows", [])}))
        return
    state["plain_rows"].append(ba_iters_row())
    rows = state["kernel_rows"]
    by_path = state["launches_by_path"]
    all_by_path = state["all_launches_by_path"]
    for r in rows:
        r.setdefault("ms_by", "cuda events" if f"{r['name']}_kernel"
                     in EVENT_TIMED else "profiler")
        names = r.get("counters", [r["name"]])
        r["launches_by_path"] = {p: sum(c[k] for k in names)
                                 for p, c in all_by_path.items()}
        if r["name"] in NO_PATH_KERNELS:
            check(not any(r["launches_by_path"].values()),
                  f"{r['name']} launched on a path: "
                  f"{r['launches_by_path']}")
            r["launches_from"] = None
            r["launches"] = sum(r["launches_by_path"].values())
            continue
        # the count of this slice's rig paths for the kernels they run,
        # else of the first earlier path that runs the kernel
        r["launches_from"] = next(
            p for p in ("rig", "rig_vi", "persist", "loop", "vi_loop", "vi",
                        "fisheye", "reloc", "sharded")
            if names[0] in by_path[p])
        r["launches"] = by_path[r["launches_from"]][names[0]]
    log(json.dumps({"plain_kernel_targets": state["plain_rows"]}))
    for name in ("main", "stereo", "rgbd", "reloc", "vi", "loop", "merge",
                 "vi_loop", "fisheye", "persist", "euroc_synth"):
        key = "main_path" if name == "main" else f"{name}_path"
        log(json.dumps({key: state[name]}))
    log(json.dumps({"rig_path": state["rig_path"]}))
    log(json.dumps({"sharded_path": state["sharded"]}))
    log(json.dumps({"kernels": rows}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
