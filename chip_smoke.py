"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-out out/profile.txt   # + op table

Phases:
  1. device   — require CUDA; print the card, torch/CUDA versions and the
                kernel build time (`nvcc` for sm_90a, one process per source).
  2. kernels  — hold K1 (fast_select), K2 (orb_describe) and K3
                (hamming_top2) against their plain PyTorch versions on the
                card, at the shapes of a rendered 752x480 frame; time each
                kernel on the card with torch.profiler (`ms`) and each
                call, kernel and plain, with CUDA events (`call_ms`,
                `plain_ms`).
  3. main     — render the 752x480 synthetic world on the card and run 80
                frames through `Tracker.track_mono` (1200 features, 8
                levels), check initialization, the share of OK frames, the
                Sim3-aligned ATE and that every kernel launched while every
                plain version stayed unused; then count CUDA kernel
                launches per frame with torch.profiler over 5 more frames.

Any failure raises (nonzero exit). The line before the last is the card's
`nvidia-smi` name and power limit; the last line is the JSON result.
"""
from __future__ import annotations

import argparse
import collections
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
# NVIDIA's H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12             # float32 outside the tensor cores


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
        v, u = torch.meshgrid(torch.arange(height, device=device),
                              torch.arange(width, device=device),
                              indexing="ij")
        self.pix = torch.stack([u, v, torch.ones_like(u)], -1).to(
            torch.float64).reshape(-1, 3)

    def _add(self, origin, extent, tex):
        self.planes.append(dict(origin=np.asarray(origin, np.float64),
                                extent=extent, tex=tex))

    def render(self, R_cw, t_cw):
        R = np.asarray(R_cw, np.float64)
        t = np.asarray(t_cw, np.float64)
        img = torch.zeros(self.h * self.w, dtype=torch.float32,
                          device=self.device)
        for p in self.planes:
            th, tw = p["tex"].shape
            a = R @ (np.array([1.0, 0, 0]) * p["extent"][0] / tw)
            b = R @ (np.array([0, 1.0, 0]) * p["extent"][1] / th)
            c = R @ p["origin"] + t
            Hinv = np.linalg.inv(self.K @ np.stack([a, b, c], axis=1))
            src = self.pix @ torch.from_numpy(Hinv.T).to(self.device)
            front = src[:, 2] > 0
            tx = src[:, 0] / src[:, 2]
            ty = src[:, 1] / src[:, 2]
            ok = front & (tx >= 0) & (tx <= tw - 1) & (ty >= 0) & (ty <= th - 1)
            grid = torch.stack([tx / (tw - 1) * 2 - 1, ty / (th - 1) * 2 - 1],
                               -1).to(torch.float32)
            val = F.grid_sample(p["tex"][None, None], grid.view(1, 1, -1, 2),
                                mode="bilinear", align_corners=True)[0, 0, 0]
            img = torch.where(ok, val, img)
        return img.view(self.h, self.w)


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


def device_ms(fn, kernel_name, reps=20):
    """Device milliseconds per fn() spent in kernels whose name contains
    kernel_name, from torch.profiler (CUPTI): the kernel alone, without the
    host's dispatch gaps that the event timing includes."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if kernel_name in ev.key)
    if us <= 0:
        raise AssertionError(f"profiler saw no {kernel_name} on the card")
    return us / reps / 1e3


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
        state["world"] = PlaneWorld(K, W, H, "cuda")
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


def phase_kernels(state):
    from morb_slam_tpu_torch import frontend
    from morb_slam_tpu_torch.ops import fast, hamming, image, orb_descriptor
    world, poses = _world(state)
    cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
    counts = cfg.per_level_counts()
    frames = [world.render(*poses[i]).clamp(0, 255).to(torch.uint8).float()
              for i in (0, 2, 4, 6, 8)]
    levels = [l.contiguous() for l in
              image.build_pyramid(frames[0], cfg.n_levels, cfg.scale)]
    rows = []

    # K1 on all 8 levels: keys, indices and scores exact
    err = 0.0
    for lvl in levels:
        k1 = fast.fast_select(lvl, cfg.th_fast_lo, cfg.th_fast_hi)
        k0 = fast.fast_select_plain(lvl, cfg.th_fast_lo, cfg.th_fast_hi)
        for a, b in zip(k1, k0):
            if not torch.equal(a, b):
                bad = (a != b).sum().item()
                raise AssertionError(f"K1 mismatch at level {lvl.shape}: "
                                     f"{bad} entries differ")
    log("K1 fast_select: keys, indices and scores exact on 8 levels")
    ms = time_ms(lambda: [fast.fast_select(l, 7.0, 20.0) for l in levels])
    plain = time_ms(lambda: [fast.fast_select_plain(l, 7.0, 20.0)
                             for l in levels], reps=10)
    npix = sum(l.numel() for l in levels)
    ncell = sum((-(-l.shape[0] // 16)) * (-(-l.shape[1] // 16))
                for l in levels)
    # per pixel: 16 diffs + 16 negations + 2 x (64 run mins + 15 maxes)
    # + 1 max + 8 NMS maxes + ~4 for the key
    b_ms, b_by = bound(npix * 4 + ncell * 2 * 12, npix * 203)
    kernel = device_ms(lambda: [fast.fast_select(l, 7.0, 20.0)
                                for l in levels], "fast_select_kernel")
    rows.append(dict(name="fast_select", route="cuda",
                     source="morb_slam_tpu_torch/csrc/fast_select.cu",
                     replaces="morb_slam_tpu/ops/fast.py:41",
                     max_abs_err=err, ms=kernel, call_ms=ms, plain_ms=plain,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     shape="8 levels of 752x480 (one frame)"))

    # K2 at each level's n_keep: angles within 1e-4 rad, >= 99.9% bits
    args = []
    max_ang, bit_diff, bit_tot, px_read = 0.0, 0, 0, 0
    for lvl, n_keep in zip(levels, counts):
        yx, _, _, _ = frontend.select_level_keypoints(lvl, n_keep, cfg)
        blur = image.gaussian_blur(lvl).contiguous()
        args.append((lvl, blur, yx.contiguous()))
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
    ms = time_ms(lambda: [orb_descriptor.orb_describe(*a) for a in args])

    def plain_k2():
        for lvl, blur, yx in args:
            ang = orb_descriptor.compute_orientations(lvl, yx)
            orb_descriptor.compute_descriptors(blur, yx, ang)
    plain = time_ms(plain_k2, reps=10)
    kernel = device_ms(lambda: [orb_descriptor.orb_describe(*a) for a in args],
                       "orb_describe_kernel")
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
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, bits_identical=share,
                     shape="1200 keypoints over 8 levels (one frame)"))

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
    ms = time_ms(lambda: hamming.hamming_top2(a, b, m))
    plain = time_ms(lambda: hamming.hamming_top2_plain(a, b, m), reps=10)
    ms_small = time_ms(lambda: hamming.hamming_top2(*cases["real 1200x1200"]))
    kernel = device_ms(lambda: hamming.hamming_top2(a, b, m),
                       "hamming_top2_kernel")
    kernel_small = device_ms(
        lambda: hamming.hamming_top2(*cases["real 1200x1200"]),
        "hamming_top2_kernel")
    n, mm = m.shape
    # the whole mask is read; only the candidate pairs need a distance
    b_ms, b_by = bound(n * mm + (n + mm) * 32 + n * 12, int(m.sum()) * 16)
    rows.append(dict(name="hamming_top2", route="cuda",
                     source="morb_slam_tpu_torch/csrc/hamming_top2.cu",
                     replaces="morb_slam_tpu/ops/hamming.py:53",
                     max_abs_err=0.0, ms=kernel, call_ms=ms, plain_ms=plain,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     ms_1200x1200=kernel_small, call_ms_1200x1200=ms_small,
                     shape="4096x1200 (one launch)"))
    state["kernel_rows"] = rows
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms on the card, "
            f"{r['call_ms']:.4f} ms per call by events (plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']})")


def _reset_counters():
    from morb_slam_tpu_torch.ops import fast, hamming, orb_descriptor
    for mod in (fast, orb_descriptor, hamming):
        mod.LAUNCHES["kernel"] = 0
        mod.LAUNCHES["plain"] = 0


def phase_main(state):
    from morb_slam_tpu_torch import alignment, cameras
    from morb_slam_tpu_torch.ops import fast, hamming, orb_descriptor
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
    inserts = []
    orig_insert = tracker._insert_keyframe

    def timed_insert(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig_insert(*a, **kw)
        torch.cuda.synchronize()
        inserts.append((time.perf_counter() - t0) * 1e3)
        return r
    tracker._insert_keyframe = timed_insert

    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    states, frame_ms = [], []
    t_start = None
    for i in range(N_FRAMES):
        if i == 20:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            n_ins_20 = len(inserts)
        t0 = time.perf_counter()
        st, _ = tracker.track_mono(frames[i], ts=float(i))
        states.append(st)
        if i >= 20:
            frame_ms.append((time.perf_counter() - t0) * 1e3)
    tracker.flush()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_start
    launches = {"fast_select": fast.LAUNCHES["kernel"],
                "orb_describe": orb_descriptor.LAUNCHES["kernel"],
                "hamming_top2": hamming.LAUNCHES["kernel"]}
    plain = {"fast_select": fast.LAUNCHES["plain"],
             "orb_describe": orb_descriptor.LAUNCHES["plain"],
             "hamming_top2": hamming.LAUNCHES["plain"]}
    state["launches"] = launches
    log("states:", "".join("O" if s == "OK" else s[0] for s in states))
    log("kernel launches on the main path:", launches, "plain calls:", plain)
    for k in launches:
        check(launches[k] > 0, f"{k} never launched on the main path")
        check(plain[k] == 0, f"plain {k} ran on the main path")

    check("OK" in states, "never initialized")
    n_ok = sum(s == "OK" for s in states)
    check(n_ok >= 0.7 * N_FRAMES, f"only {n_ok} of {N_FRAMES} frames OK")
    traj = tracker.trajectory_world()
    est, gt = [], []
    for ts, p in traj:
        R, t = poses[int(round(ts))]
        gt.append(-(R.T @ t))
        est.append(p)
    est = torch.tensor(np.asarray(est), dtype=torch.float32)
    gt = torch.tensor(np.asarray(gt), dtype=torch.float32)
    rmse, s, _, _ = alignment.ate_rmse(est, gt, with_scale=True)
    extent = float(torch.linalg.norm(gt[-1] - gt[0]))
    ate = float(rmse)
    log(f"trajectory: {len(traj)} poses, Sim3 ATE {ate:.4f} m over "
        f"{extent:.3f} m extent (gate {0.023 * extent:.4f})")
    check(math.isfinite(ate) and ate < 0.023 * extent, (ate, extent))

    fm = np.asarray(frame_ms)
    n_ins = len(inserts) - n_ins_20
    main = dict(
        fps=(N_FRAMES - 20) / elapsed,
        frame_ms_p50=float(np.percentile(fm, 50)),
        frame_ms_p90=float(np.percentile(fm, 90)),
        frames_ok=n_ok, kf_inserts=len(inserts),
        kf_insert_ms_each=float(np.mean(inserts)) if inserts else None,
        kf_inserts_in_timed_window=n_ins,
        ate_sim3_m=ate, extent_m=extent,
        peak_device_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches_per_frame={k: v / N_FRAMES for k, v in launches.items()})
    log("main path:", json.dumps(main))

    # CUDA kernel launches per tracked frame, from the profiler
    import warnings
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        for i in range(N_FRAMES, N_FRAMES + 5):
            tracker.track_mono(frames[i], ts=float(i))
        tracker.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode(0)
    n_kern, dev_us, ours_us = 0, 0.0, 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n_kern += ev.count
            dev_us += ev.self_device_time_total
            if any(k in ev.key for k in ("fast_select_kernel",
                                         "orb_describe_kernel",
                                         "hamming_top2_kernel")):
                ours_us += ev.self_device_time_total
    main["cuda_kernels_per_frame_profiler"] = n_kern / 5
    main["device_ms_per_frame_profiler"] = dev_us / 5 / 1e3
    main["k1_k3_device_ms_per_frame_profiler"] = ours_us / 5 / 1e3
    main["device_busy_share_profiler"] = dev_us / 1e6 / wall
    # device time per frame over the unprofiled frame time of frames 20-79
    main["device_busy_share_unprofiled"] = dev_us / 5 / 1e6 * main["fps"]
    syncs = [w for w in syncs if "synchroniz" in str(w.message)]
    main["host_syncs_per_frame"] = len(syncs) / 5
    sites = collections.Counter(
        "/".join(os.path.normpath(w.filename).split(os.sep)[-2:])
        + f":{w.lineno}" for w in syncs)
    main["host_sync_sites"] = dict(sites.most_common(10))
    log(f"profiler: {n_kern / 5:.0f} CUDA kernels, {dev_us / 5 / 1e3:.2f} ms "
        f"device time ({ours_us / 5 / 1e3:.3f} ms in K1-K3) and "
        f"{len(syncs) / 5:.1f} implicit host syncs per tracked frame; "
        f"device busy {dev_us / 1e6 / wall:.3f} of the profiled wall time")
    log("host sync sites over 5 frames:", main["host_sync_sites"])
    if state.get("profile_out"):
        os.makedirs(os.path.dirname(state["profile_out"]) or ".",
                    exist_ok=True)
        with open(state["profile_out"], "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
    state["main"] = main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile-out", default=None,
                    help="write the main path's profiler op table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    state = {"profile_out": args.profile_out}
    for name, phase in (("device", phase_device), ("kernels", phase_kernels),
                        ("main", phase_main)):
        t0 = time.perf_counter()
        log(f"== phase {name}")
        phase(state)
        log(f"== phase {name} done in {time.perf_counter() - t0:.1f} s")
    rows = state["kernel_rows"]
    for r in rows:
        r["launches"] = state["launches"][r["name"]]
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"main_path": state["main"]}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
