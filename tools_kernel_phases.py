"""Phase shares of hand-written kernels on the card, stamped with
`clock64()`, and earlier forms of kernels against this tree's: this
tree's K12 (`csrc/pose_inertial.cu`), K5 (`csrc/pose_opt.cu`), K1
(`csrc/fast_select.cu`), K3 (`csrc/hamming_top2.cu`) and K6
(`csrc/pyramid_blur.cu`), and K4 and K13 against their earlier forms.

    python3 tools_kernel_phases.py --new
    python3 tools_kernel_phases.py --k5 --k1 --new
    python3 tools_kernel_phases.py --k3 --k6 --new
    git archive 001dca8 morb_slam_tpu_torch/csrc | tar -x -C old14/
    python3 tools_kernel_phases.py --k4 --k13 --csrc old14/morb_slam_tpu_torch/csrc

Copies the sources (and the headers) into a temporary directory, inserts
the stamps, builds them with the port's `nvcc` flags and runs them at
`chip_smoke.py`'s shapes. `--new`: K12 at the tracking shape (1,200
observations, 60% stereo, 2 x 6 + final); thread 0 (the solver warp's
lane 0) and thread 32 (the first visual thread) each add the cycles since
their last stamp to their own phase counters. `--k5`: K5 at the tracking
(1,200 observations, 60% stereo, 2 x 8) and relocalization (mono, 3 x 10)
shapes; thread 0 (the solver warp) and thread 32 (a row warp) stamp, at
256 and 512 threads a block. `--k1`: K1 on the 8 levels of a 752x480
frame, its cell stage and level stage stamped by block. `--k3`: K3's
gated mode on chip_smoke.py's gated inputs (a 4096x1200 projection
window, a 1200x1200 window with NaN rows, a 1200x1200 stereo row band),
lane 0 of every warp stamping its phases, with unstamped builds at 1, 2,
4 and 8 warps a row. `--k6`: K6's one launch on the first rendered
752x480 frame, 8 levels, stamped by block (phases over all levels, each
grid barrier's wait) with unstamped builds at other grid sizes.
`--k4 --k13` with `--csrc`: this tree's K4 (`csrc/ba_assemble.cu`, both
modes) and K13 (`csrc/vi_edges.cu`) against the earlier ones (as of
commit 001dca8: K4 a warp a landmark with one lane walking it, K13 a
system of two launches and a cost of one), built beside them. The
stereo, vi and loop paths of chip_smoke.py run with every K4 and K13
call also run through the earlier kernel on the same inputs (calls and
bitwise-equal calls by mode: local BA in the camera and the body tangent,
per-observation; the inertial terms); then, on each mode's last problem
of the paths and on chip_smoke.py's global BA problem at the loop phase's
capacities, both trees' bits and times (device ms of the kernels, kernels
and event ms per call), the device time of each kind of K4 block alone
(keyframe, landmark and slot blocks, the others returning at once) in
both trees, this tree's K4 built at 32-256 landmarks a landmark block
and its K13 at 128 and 256 threads a block, and K13 stamped by phase
(thread 0 of every block: edge terms, lists and dead zeros, the grid
barrier, the live sums; clock64 cycles). Prints one JSON object (also written to chiprun_out/
kernel_phases_new.json, kernel_phases_k5_k1_new.json,
kernel_phases_k3_k6_new.json or kernel_phases_k4_k13.json, the last also
after each path). The stamp anchors match those sources only. Needs a
CUDA card and nvcc.

The earlier forms of K12, K2 (as of commit 4ceff5a), K5 and K1 (as of
commit ea2e66d) are stamped by this script as of commit a873e66, those
of K3 and K6 (as of commit a873e66: the masked K3 on a dense gate, K6
launched per level) by this script as of commit 133af77, K11 and K17
(as of commit 133af77), and this tree's K11 stamped, by this script as
of commit 5e4d05b, and K14 and K16 (as of commit 5e4d05b: K14's pass
launches with the CG loop in torch, K16 in three kernels) by this script
as of commit 001dca8.
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from morb_slam_tpu_torch import frontend, imu
from morb_slam_tpu_torch.ops import cuda_build, fast, image
from morb_slam_tpu_torch.optim import vi_ba

def _patch(text, pairs):
    for a, b in pairs:
        if text.count(a) != 1:
            raise SystemExit(f"stamp anchor not found once: {a[:60]!r}")
        text = text.replace(a, b)
    return text


K12_NEW_PHASES = {
    0: "solver: edge Jacobian (15 dual tangents)",
    1: "solver: Je^T Omega, H_cc rows, g_c",
    2: "solver: wait at barrier 1",
    3: "solver: visual partials and random walk",
    4: "solver: symmetrize",
    5: "solver: Jacobi scaling",
    6: "solver: Cholesky",
    7: "solver: forward substitution",
    8: "solver: backward substitution",
    9: "solver: state and pose update",
    10: "solver: barrier 2",
    11: "solver: set-up",
    12: "solver: outputs",
    16: "visual: rows",
    17: "visual: transposed sum",
    18: "visual: wait at barrier 1",
    19: "visual: wait at barrier 2 (the solver)",
    20: "visual: reclassification",
    21: "visual: set-up",
}


def _k12_new_source(text):
    st = ("#define STAMP(k) { long long t_ = clock64(); ph[k] += t_ - last; "
          "last = t_; }\n#define STAMP0(k) if (threadIdx.x == 0) STAMP(k)\n"
          "#define STAMPV(k) if (threadIdx.x == 32) STAMP(k)\n")
    return _patch(text, [
        ("                     long long* __restrict__ n_inliers) {",
         "                     long long* __restrict__ n_inliers,\n"
         "                     long long* __restrict__ phase_out) {\n"
         "    long long ph[32];\n"
         "    for (int q = 0; q < 32; ++q) ph[q] = 0;\n"
         "    long long last = clock64();\n" + st),
        ("        for (int i = vt; i < N; i += NVIS) inliers[i] = valid[i] ? 1 : 0;\n"
         "    __syncthreads();\n",
         "        for (int i = vt; i < N; i += NVIS) inliers[i] = valid[i] ? 1 : 0;\n"
         "    __syncthreads();\n    STAMP0(11) STAMPV(21)\n"),
        ("                    inliers[i] = (valid[i] && e.chi2 < e.th) ? 1 : 0;\n"
         "                }\n            continue;",
         "                    inliers[i] = (valid[i] && e.chi2 < e.th) ? 1 : 0;\n"
         "                }\n            STAMPV(20)\n            continue;"),
        ("            red[warp - 1][lane] = warp_transpose_sum(acc, lane);",
         "            STAMPV(16)\n"
         "            red[warp - 1][lane] = warp_transpose_sum(acc, lane);\n"
         "            STAMPV(17)"),
        ("            __syncwarp();\n            // column `lane` of Je^T Omega",
         "            STAMP0(0)\n            __syncwarp();\n"
         "            // column `lane` of Je^T Omega"),
        ("            gi = -s;\n        }\n        __syncthreads();\n",
         "            gi = -s;\n            STAMP0(1)\n        }\n"
         "        __syncthreads();\n        STAMP0(2) STAMPV(18)\n"),
        ("            // symmetrize through shared memory",
         "            STAMP0(3)\n            // symmetrize through shared memory"),
        ("            if (final_step) {", "            STAMP0(4)\n"
         "            if (final_step) {"),
        ("                // right-looking Cholesky",
         "                STAMP0(5)\n                // right-looking Cholesky"),
        ("                // forward: L y", "                STAMP0(6)\n"
         "                // forward: L y"),
        ("                // backward: L^T x", "                STAMP0(7)\n"
         "                // backward: L^T x"),
        ("                // the current state: R <- R exp",
         "                STAMP0(8)\n"
         "                // the current state: R <- R exp"),
        ("        __syncthreads();\n    }\n    // outputs:",
         "        STAMP0(9)\n        __syncthreads();\n"
         "        STAMP0(10) STAMPV(19)\n    }\n    // outputs:"),
        ("        for (int q = 0; q < 6; ++q) out[15 + q] = S[36 + q];\n    }\n}",
         "        for (int q = 0; q < 6; ++q) out[15 + q] = S[36 + q];\n    }\n"
         "    STAMP0(12)\n"
         "    if (tid == 0) for (int q = 0; q < 16; ++q) phase_out[q] = ph[q];\n"
         "    if (tid == 32) for (int q = 16; q < 32; ++q) "
         "phase_out[q] = ph[q];\n}"),
        ("void* inliers, void* n_inliers, void* stream) {",
         "void* inliers, void* n_inliers, void* stream,\n"
         "                             void* phase) {"),
        ("        (long long*)n_inliers);",
         "        (long long*)n_inliers, (long long*)phase);"),
    ])


def _define(text, name, value):
    """`text` with its `#define name ...` set to `value`."""
    out, n = re.subn(rf"^#define {name} \d+", f"#define {name} {value}",
                     text, flags=re.M)
    if n != 1:
        raise SystemExit(f"#define {name} not found once")
    return out


def _replace_once(text, old, new):
    """`text` with the one occurrence of `old` replaced by `new`."""
    if text.count(old) != 1:
        raise SystemExit(f"{old.strip()!r} not found once")
    return text.replace(old, new)


def _build(src_dir, name, text):
    path = os.path.join(src_dir, name + ".cu")
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(src_dir, name + ".so")
    r = subprocess.run([cuda_build.nvcc_path(), *cuda_build._flags(name),
                        "-o", so, path], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    return ctypes.CDLL(so), "".join(l for l in (r.stdout + r.stderr).split(
        "\n") if "spill" in l or "registers" in l)


def _k12_args():
    """chip_smoke.py's K12 problem (the same construction)."""
    rng = np.random.default_rng(11)
    args, kw = cs._pose_problem(1200, 0.6, seed=4)
    R0, t0, X, xn, info, valid = args
    n_rows = 10
    acc = np.tile([0.0, 0.0, 9.81], (n_rows, 1)) + rng.normal(
        0, cs._imu_noise()["noise_a"], (n_rows, 3))
    gyr = rng.normal(0, cs._imu_noise()["noise_g"], (n_rows, 3))
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device="cuda")
    z6 = torch.zeros(6, device="cuda")
    pre = imu.preintegrate_plain(
        f(acc), f(gyr), f(np.full(n_rows, 0.005)),
        torch.ones(n_rows, dtype=torch.bool, device="cuda"), z6,
        cs._imu_calib())
    info9 = vi_ba.floor_info(torch.linalg.inv_ex(
        pre.C[:9, :9] + 1e-9 * torch.eye(9, device="cuda")).inverse)
    rw = 1.0 / torch.clamp(torch.diagonal(pre.C[9:, 9:]), min=1e-12)
    v = f([0.4, -0.05, 0.1])
    return (R0, t0, v + f([0.05, 0.05, -0.05]), z6, X, xn, info, valid,
            kw["obs_ur"], torch.tensor(kw["baseline"], device="cuda"),
            torch.eye(3, device="cuda"), -v * pre.dt, v, z6, pre.dt, pre.dR,
            pre.dV, pre.dP, pre.J_Rg, pre.J_Vg, pre.J_Va, pre.J_Pg,
            pre.J_Pa, info9, pre.bias, rw)


def _write(res, name):
    print(json.dumps(res))
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, name), "w") as f:
        json.dump(res, f, indent=1)


def _new_k12(reps):
    """This tree's K12, stamped: cycles per call of each phase."""
    csrc = cuda_build.CSRC
    res = dict(card=cs.nvidia_smi())
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        for h in ("imu_edge.cuh", "dual.cuh"):
            shutil.copy(os.path.join(csrc, h), tmp)
        src = open(os.path.join(csrc, "pose_inertial.cu")).read()
        lib, ptx = _build(tmp, "pose_inertial", _k12_new_source(src))
        lib.pose_inertial.argtypes = [P, P, P, P, P, P, I, I, P, P, P, P, P]
        lib.pose_inertial.restype = I
        k = _k12_args()
        small = (k[0], k[1], k[2], k[3], k[10], k[11], k[12], k[13],
                 *k[14:26], k[9])
        const = torch.cat([x.reshape(-1) for x in small])
        Xw, obs, info, valid, ur = (t.contiguous() for t in k[4:9])
        n = Xw.shape[0]
        out = torch.empty(21 + 225, device="cuda")
        inl = torch.empty(n, dtype=torch.bool, device="cuda")
        n_inl = torch.empty((), dtype=torch.int64, device="cuda")
        ph = torch.zeros(32, dtype=torch.int64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def k12():
            cuda_build.check(lib.pose_inertial(
                const.data_ptr(), Xw.data_ptr(), obs.data_ptr(),
                info.data_ptr(), valid.data_ptr(), ur.data_ptr(), n, 6,
                out.data_ptr(), inl.data_ptr(), n_inl.data_ptr(), stream,
                ph.data_ptr()), "pose_inertial (stamped)")
        for _ in range(3):
            k12()
        cyc = np.zeros(32)
        for _ in range(reps):
            k12()
            cyc += ph.cpu().numpy()
        cyc /= reps
        want = vi_ba.optimize_pose_inertial_plain(*k, n_iters=6)
        got_R = out[:9].view(3, 3)
        res["k12_new"] = dict(
            cycles={v: float(cyc[i]) for i, v in K12_NEW_PHASES.items()},
            solver_total_cycles=float(cyc[:16].sum()),
            visual_total_cycles=float(cyc[16:].sum()),
            device_ms_stamped=cs.device_ms(k12, "pose_inertial_kernel"),
            R_err_vs_plain=float((got_R - want.R_cw).abs().max()),
            ptxas=ptx.strip())
    _write(res, "kernel_phases_new.json")


def _k5_problems():
    """chip_smoke.py's two K5 shapes (the same construction)."""
    for name, share, rounds, iters, seed in (("tracking", 0.6, 2, 8, 1),
                                             ("relocalization", 0.0, 3, 10,
                                              2)):
        args, kw = cs._pose_problem(1200, share, seed)
        kw.update(n_rounds=rounds, n_iters=iters)
        yield name, args, kw


def _k5(reps, threads=None):
    """This tree's K5 stamped at the tracking and relocalization shapes:
    cycles a call and a Gauss-Newton step of each phase (`threads`: built
    at another block size)."""
    from morb_slam_tpu_torch.optim import pose_opt
    phases = K5_NEW_PHASES
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        text = open(os.path.join(cuda_build.CSRC, "pose_opt.cu")).read()
        if threads:
            text = _define(text, "THREADS", threads)
        lib, ptx = _build(tmp, "pose_opt", _k5_new_source(text))
        lib.pose_opt.argtypes = [P, P, P, P, I, P, P, P, ctypes.c_float, I,
                                 I, I, P, P, P, P, P, P, P]
        lib.pose_opt.restype = I
        # the same source unstamped, for its own device time
        os.makedirs(os.path.join(tmp, "u"))
        plain_lib, uptx = _build(os.path.join(tmp, "u"), "pose_opt", text)
        plain_lib.pose_opt.argtypes = lib.pose_opt.argtypes[:-1]
        plain_lib.pose_opt.restype = I
        out["ptxas_unstamped"] = uptx.strip()

        def plain_call(R0, t0, Xw, obs, info, valid, ur, kw, n, R, t, inl,
                       chi2, n_inl):
            cuda_build.check(plain_lib.pose_opt(
                R0.data_ptr(), t0.data_ptr(), Xw.data_ptr(), obs.data_ptr(),
                2, info.data_ptr(), valid.data_ptr(),
                None if ur is None else ur.data_ptr(), float(kw["baseline"]),
                n, kw["n_rounds"], kw["n_iters"], R.data_ptr(), t.data_ptr(),
                inl.data_ptr(), chi2.data_ptr(), n_inl.data_ptr(), stream),
                "pose_opt")
        for name, args, kw in _k5_problems():
            R0, t0, Xw, obs, info, valid = (x.contiguous() for x in args)
            ur = kw["obs_ur"]
            n = Xw.shape[0]
            R = torch.empty((3, 3), device="cuda")
            t = torch.empty(3, device="cuda")
            inl = torch.empty(n, dtype=torch.bool, device="cuda")
            chi2 = torch.empty(n, device="cuda")
            n_inl = torch.empty((), dtype=torch.int64, device="cuda")
            ph = torch.zeros(32, dtype=torch.int64, device="cuda")

            def k5():
                cuda_build.check(lib.pose_opt(
                    R0.data_ptr(), t0.data_ptr(), Xw.data_ptr(),
                    obs.data_ptr(), 2, info.data_ptr(), valid.data_ptr(),
                    None if ur is None else ur.data_ptr(),
                    float(kw["baseline"]), n, kw["n_rounds"], kw["n_iters"],
                    R.data_ptr(), t.data_ptr(), inl.data_ptr(),
                    chi2.data_ptr(), n_inl.data_ptr(), stream,
                    ph.data_ptr()), "pose_opt (stamped)")
            for _ in range(3):
                k5()
            cyc = np.zeros(32)
            for _ in range(reps):
                ph.zero_()
                k5()
                cyc += ph.cpu().numpy()
            cyc /= reps
            want = pose_opt.optimize_pose_plain(*args, **kw)
            steps = kw["n_rounds"] * kw["n_iters"]
            tot = float(sum(cyc[k] for k in phases))
            out[name] = dict(
                device_ms_unstamped=cs.device_ms(
                    lambda: plain_call(R0, t0, Xw, obs, info, valid, ur, kw,
                                       n, R, t, inl, chi2, n_inl),
                    "pose_opt_kernel"),
                steps=steps, reclassifications=kw["n_rounds"] + 1,
                cycles={v: float(cyc[k]) for k, v in phases.items()},
                share={v: float(cyc[k]) / tot for k, v in phases.items()},
                total_cycles=tot, cycles_per_step=tot / steps,
                device_ms_stamped=cs.device_ms(k5, "pose_opt_kernel"),
                R_t_err_vs_plain=max(float((R - want.R).abs().max()),
                                     float((t - want.t).abs().max())),
                inliers=int(n_inl), inliers_plain=int(want.n_inliers))
        out["ptxas"] = ptx.strip()
    return out


def _frame_levels():
    """The 8 levels of the first rendered 752x480 frame of chip_smoke.py."""
    world, poses = cs._world({})
    cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
    frame = world.render(*poses[0]).clamp(0, 255).to(torch.uint8).float()
    return image.build_pyramid(frame, 8, 1.2), cfg


K5_NEW_PHASES = {
    0: "solver warp: row pass",
    1: "solver warp: transposed sum",
    2: "solver warp: barrier 1",
    3: "solver warp: cross-warp sum, totals to lanes",
    4: "solver warp: blockwise 6x6 solve",
    5: "solver warp: se3_exp and composition",
    6: "solver warp: barrier 2, pose read",
    7: "solver warp: reclassification",
    8: "solver warp: set-up (rows to registers)",
    9: "solver warp: outputs",
    16: "row warp: row pass",
    17: "row warp: transposed sum",
    18: "row warp: barrier 1",
    22: "row warp: barrier 2 (the solve), pose read",
    23: "row warp: reclassification",
    24: "row warp: set-up (rows to registers)",
    25: "row warp: outputs",
}


def _k5_new_source(text):
    """This tree's K5: thread 0 (the solver warp's lane 0) and thread 32
    (a row warp's lane 0) each add the cycles since their last stamp to
    their own phase counters."""
    st = ("#define STAMP(k) { long long t_ = clock64(); ph[k] += t_ - last; "
          "last = t_; }\n#define STAMP0(k) if (threadIdx.x == 0) STAMP(k)\n"
          "#define STAMPR(k) if (threadIdx.x == 32) STAMP(k)\n")
    return _patch(text, [
        ("                long long* __restrict__ n_inliers) {",
         "                long long* __restrict__ n_inliers,\n"
         "                long long* __restrict__ phase_out) {\n"
         "    long long ph[32];\n"
         "    for (int q = 0; q < 32; ++q) ph[q] = 0;\n"
         "    long long last = clock64();\n" + st),
        ("inliers[i] = valid[i] ? 1 : 0;\n\n",
         "inliers[i] = valid[i] ? 1 : 0;\n    STAMP0(8) STAMPR(24)\n\n"),
        ("                           __activemask());\n            }\n"
         "            red[warp][lane] = warp_transpose_sum(acc, lane);\n"
         "            __syncthreads();\n",
         "                           __activemask());\n            }\n"
         "            STAMP0(0) STAMPR(16)\n"
         "            red[warp][lane] = warp_transpose_sum(acc, lane);\n"
         "            STAMP0(1) STAMPR(17)\n"
         "            __syncthreads();\n            STAMP0(2) STAMPR(18)\n"),
        ("                for (int k = 0; k < NACC; ++k) t[k] = tot[k];\n",
         "                for (int k = 0; k < NACC; ++k) t[k] = tot[k];\n"
         "                STAMP0(3)\n"),
        ("                solve6(t, dx);\n                apply_update(P, dx, Pn);\n",
         "                solve6(t, dx);\n                STAMP0(4)\n"
         "                apply_update(P, dx, Pn);\n"),
        ("                    for (int k = 0; k < 12; ++k) sP[k] = Pn[k];\n"
         "            }\n",
         "                    for (int k = 0; k < 12; ++k) sP[k] = Pn[k];\n"
         "                STAMP0(5)\n            }\n"),
        ("            for (int k = 0; k < 12; ++k) P[k] = sP[k];\n        }\n",
         "            for (int k = 0; k < 12; ++k) P[k] = sP[k];\n"
         "            STAMP0(6) STAMPR(22)\n        }\n"),
        ("            if (lane == 0) cnt[warp] = n;\n        }\n    }\n",
         "            if (lane == 0) cnt[warp] = n;\n        }\n"
         "        STAMP0(7) STAMPR(23)\n    }\n"),
        ("        for (int k = 0; k < 3; ++k) t_out[k] = P[9 + k];\n    }\n}",
         "        for (int k = 0; k < 3; ++k) t_out[k] = P[9 + k];\n    }\n"
         "    STAMP0(9) STAMPR(25)\n"
         "    if (tid == 0) for (int q = 0; q < 16; ++q) phase_out[q] = ph[q];\n"
         "    if (tid == 32) for (int q = 16; q < 32; ++q) "
         "phase_out[q] = ph[q];\n}"),
        ("void* inliers, void* chi2, void* n_inliers,\n"
         "                        void* stream) {",
         "void* inliers, void* chi2, void* n_inliers,\n"
         "                        void* stream, void* phase) {"),
        ("        (long long*)n_inliers);",
         "        (long long*)n_inliers, (long long*)phase);"),
    ])


K1_CELL_PHASES = ["tile load", "compass test, compaction and scores",
                  "keys and warp top-2", "barrier", "merge and slot writes"]
K1_LEVEL_PHASES = ["radix select (keys to shared memory, 4 passes)",
                   "rank of equal keys, compaction",
                   "ranks and slot writes"]


def _k1_new_source(text):
    """This tree's K1: thread 0 of every cell block and of every level
    block records the cycles of each phase."""
    st = ("#define STAMP(k) if (threadIdx.x == 0) { long long t_ = clock64(); "
          "ph[k] = t_ - last; last = t_; }\n")
    return _patch(text, [
        ("#define CELL_MIN_BLOCKS", st + "#define CELL_MIN_BLOCKS"),
        ("                  float* __restrict__ score_out) {",
         "                  float* __restrict__ score_out,\n"
         "                  long long* __restrict__ cph) {\n"
         "    long long ph[5];\n    long long last = clock64();"),
        ("                              wrap(x0 - HALO + tx, W)];\n        }\n"
         "    }\n    __syncthreads();\n",
         "                              wrap(x0 - HALO + tx, W)];\n        }\n"
         "    }\n    __syncthreads();\n    STAMP(0)\n"),
        ("HALO - 1]);\n    }\n    __syncthreads();\n",
         "HALO - 1]);\n    }\n    __syncthreads();\n    STAMP(1)\n"),
        ("        pairs[warp][1] = second;\n    }\n    __syncthreads();\n",
         "        pairs[warp][1] = second;\n    }\n    STAMP(2)\n"
         "    __syncthreads();\n    STAMP(3)\n"),
        ("            score_out[2 * b + lane] = sv;\n        }\n    }\n}",
         "            score_out[2 * b + lane] = sv;\n        }\n    }\n"
         "    STAMP(4)\n    if (tid == 0 && cph)\n"
         "        for (int q = 0; q < 5; ++q) cph[(size_t)b * 5 + q] = ph[q];\n}"),
        ("                  unsigned long long* __restrict__ sel_g) {",
         "                  unsigned long long* __restrict__ sel_g,\n"
         "                  long long* __restrict__ lph) {\n"
         "    long long ph[3];\n    long long last = clock64();"),
        ("        need = ctrl[1];\n    }\n",
         "        need = ctrl[1];\n    }\n    STAMP(0)\n"),
        ("(0xFFFFFFFFu - (unsigned int)i);\n    }\n    __syncthreads();\n",
         "(0xFFFFFFFFu - (unsigned int)i);\n    }\n    __syncthreads();\n"
         "    STAMP(1)\n"),
        ("        size_out[o] = lv.size[l];\n    }\n}",
         "        size_out[o] = lv.size[l];\n    }\n    STAMP(2)\n"
         "    if (tid == 0) for (int q = 0; q < 3; ++q) lph[3 * l + q] = ph[q];\n}"),
        ("border, key, idx, score);",
         "border, key, idx, score, (long long*)0);"),
        ("unsigned long long* sel_scratch, void* stream) {",
         "unsigned long long* sel_scratch, void* stream, void* cph, "
         "void* lph) {"),
        ("cell_score);", "cell_score, (long long*)cph);"),
        ("            octave, size_out, sel_scratch);",
         "            octave, size_out, sel_scratch, (long long*)lph);"),
    ])


def _k1_new():
    """This tree's K1, stamped, over the 8 levels of a 752x480 frame in
    one call: the cell stage's phases by level (mean over its blocks) and
    the level stage's phases, with each stage's device time."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    IP, FP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    levels, cfg = _frame_levels()
    counts = cfg.per_level_counts()
    shapes = [tuple(l.shape) for l in levels]
    want = fast.fast_select_levels_plain(levels, counts, cfg)
    keep = list(want.kept)
    cells = [(-(-h // 16)) * (-(-w // 16)) for h, w in shapes]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        text = open(os.path.join(cuda_build.CSRC, "fast_select.cu")).read()
        lib, ptx = _build(tmp, "fast_select", _k1_new_source(text))
        lib.fast_select_levels.argtypes = [P, I, IP, IP, IP, IP, FP, FP, Fl,
                                           Fl, Fl, I] + [P] * 14
        lib.fast_select_levels.restype = I
        n, m = 2 * sum(cells), sum(keep)
        bufs = [torch.empty(n, device="cuda"),
                torch.empty(n, dtype=torch.int32, device="cuda"),
                torch.empty(n, device="cuda"),
                torch.empty((m, 2), dtype=torch.int32, device="cuda"),
                torch.empty(m, device="cuda"), torch.empty(m, device="cuda"),
                torch.empty(m, dtype=torch.bool, device="cuda"),
                torch.empty((m, 2), device="cuda"),
                torch.empty(m, dtype=torch.int32, device="cuda"),
                torch.empty(m, device="cuda"),
                torch.empty(m, dtype=torch.int64, device="cuda")]
        cph = torch.zeros(sum(cells) * 5, dtype=torch.int64, device="cuda")
        lph = torch.zeros(len(levels) * 3, dtype=torch.int64, device="cuda")
        offs = np.cumsum([0] + [h * w for h, w in shapes[:-1]]).tolist()
        scale = [cfg.scale ** l for l in range(len(levels))]
        Iv, Fv = ctypes.c_int * len(levels), ctypes.c_float * len(levels)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            cuda_build.check(lib.fast_select_levels(
                levels[0].data_ptr(), len(levels), Iv(*offs),
                Iv(*[s[0] for s in shapes]), Iv(*[s[1] for s in shapes]),
                Iv(*keep), Fv(*scale), Fv(*[31.0 * s for s in scale]),
                cfg.th_fast_lo, cfg.th_fast_hi, 1e4, 16,
                *(b.data_ptr() for b in bufs), stream, cph.data_ptr(),
                lph.data_ptr()), "fast_select_levels (stamped)")
        for _ in range(3):      # warm: the stamps of a later call
            call()
        cph.zero_()
        lph.zero_()
        call()
        torch.cuda.synchronize()
        res["bitwise_equal_plain"] = all(
            torch.equal(a, b) for a, b in zip(bufs[3:-1], want))
        c = cph.view(-1, 5).cpu().numpy().astype(float)
        lv = lph.view(-1, 3).cpu().numpy().astype(float)
        rows, c0 = [], 0
        for l, (shape, nc) in enumerate(zip(shapes, cells)):
            rows.append(dict(shape=list(shape), blocks=nc,
                             cell_cycles=dict(zip(K1_CELL_PHASES,
                                                  c[c0:c0 + nc].mean(0)
                                                  .tolist())),
                             level_cycles=dict(zip(K1_LEVEL_PHASES,
                                                   lv[l].tolist()))))
            c0 += nc
        res["levels"] = rows
        every = c.sum(0)
        res["cell_share_over_blocks"] = dict(
            zip(K1_CELL_PHASES, (every / every.sum()).tolist()))
        res["cell_stage_device_ms"] = cs.device_ms(call, "fast_cells_kernel")
        res["level_stage_device_ms"] = cs.device_ms(call, "fast_level_kernel")
        res["kernels_per_call"] = cs.kernels_per_call(call)
        res["ptxas"] = ptx.strip()
        # unstamped, at three residencies of the cell blocks
        res["unstamped"] = {}
        for mb in (8, 12, 16):
            d = os.path.join(tmp, f"u{mb}")
            os.makedirs(d)
            ulib, uptx = _build(d, "fast_select",
                                _define(text, "CELL_MIN_BLOCKS", mb))
            ulib.fast_select_levels.argtypes = \
                lib.fast_select_levels.argtypes[:-2]
            ulib.fast_select_levels.restype = I

            def ucall(ulib=ulib):
                cuda_build.check(ulib.fast_select_levels(
                    levels[0].data_ptr(), len(levels), Iv(*offs),
                    Iv(*[s[0] for s in shapes]), Iv(*[s[1] for s in shapes]),
                    Iv(*keep), Fv(*scale), Fv(*[31.0 * s for s in scale]),
                    cfg.th_fast_lo, cfg.th_fast_hi, 1e4, 16,
                    *(b.data_ptr() for b in bufs), stream), "fast_select")
            ucall()
            torch.cuda.synchronize()
            res["unstamped"][f"CELL_MIN_BLOCKS={mb}"] = dict(
                bitwise_equal_plain=all(torch.equal(a, b) for a, b in
                                        zip(bufs[3:-1], want)),
                cell_stage_device_ms=cs.device_ms(ucall, "fast_cells_kernel"),
                level_stage_device_ms=cs.device_ms(ucall,
                                                   "fast_level_kernel"),
                ptxas=uptx.strip())
    return res



# ---------------------------------------------------------------------------
# K3 and K6: the phase buffer is a __device__ pointer set from the host, so
# no kernel or C entry changes its signature
# ---------------------------------------------------------------------------

PH_GLOBAL = ("__device__ long long* g_ph = nullptr;\n"
             "extern \"C\" int set_phase_buf(void* p) {\n"
             "    return (int)cudaMemcpyToSymbol(g_ph, &p, sizeof(p));\n}\n"
             "#define STAMP(k) { long long t_ = clock64(); ph_[k] += t_ - "
             "last_; last_ = t_; }\n")
K3_GATED_PHASES = ["set-up (row inputs)", "pair tests and popcounts",
                   "the warp's butterfly",
                   "the row's parts merged (barrier included), write"]
K6_FUSED_PHASES = ["pyramid tile: bands (barrier included)",
                   "pyramid tile: input window (barrier included)",
                   "pyramid tile: passes 1 and 2, write",
                   "blur tile: tile and halo (barrier included)",
                   "blur tile: passes and write",
                   "grid barriers",
                   "barrier before each work item"]


def _k3_gated_source(text):
    """The gated K3: lane 0 of every warp adds the cycles of each phase to
    its counters."""
    return _patch(text, [
        ("__device__ __forceinline__ int wrap_add(int a, int b) {",
         PH_GLOBAL + "\n__device__ __forceinline__ int wrap_add(int a, int b) {"),
        ("    int best = BIG, bidx = 0, second = BIG;\n    if (on) {\n",
         "    long long ph_[4] = {0, 0, 0, 0};\n    long long last_ = clock64();\n"
         "    int best = BIG, bidx = 0, second = BIG;\n    if (on) {\n"),
        ("        const int ro = row_oct[row];\n",
         "        const int ro = row_oct[row];\n        STAMP(0)\n"),
        ("#pragma unroll\n        for (int off = 16; off > 0; off >>= 1) {",
         "        STAMP(1)\n#pragma unroll\n"
         "        for (int off = 16; off > 0; off >>= 1) {"),
        ("            merge_top2(best, bidx, second, ob, oi, os);\n        }\n"
         "    }\n",
         "            merge_top2(best, bidx, second, ob, oi, os);\n        }\n"
         "    }\n    STAMP(2)\n"),
        ("        out[2 * N + row] = second;\n    }\n}",
         "        out[2 * N + row] = second;\n    }\n    STAMP(3)\n"
         "    if (lane == 0 && g_ph)\n"
         "        for (int q = 0; q < 4; ++q)\n"
         "            g_ph[((size_t)blockIdx.x * GATED_WARPS + warp) * 4 + q]"
         " = ph_[q];\n}"),
    ])


def _k6_fused_source(text):
    """The one-launch K6: thread 0 of every block adds the cycles of each
    phase over all its work items, and records each grid barrier's
    wait."""
    text = _patch(text, [
        ("struct Kernel7 {", PH_GLOBAL + "\nstruct Kernel7 {"),
        ("                             int y0, FusedSmem& sm) {",
         "                             int y0, FusedSmem& sm, long long* ph_,\n"
         "                             long long& last_) {"),
        ("                          int y0, FusedSmem& sm) {",
         "                          int y0, FusedSmem& sm, long long* ph_,\n"
         "                          long long& last_) {"),
        ("        if (to[k]) *to[k] = got[k];\n    __syncthreads();\n",
         "        if (to[k]) *to[k] = got[k];\n    __syncthreads();\n"
         "    STAMP(0)\n"),
        ("        sm.stage[i / FCX][i % FCX] = v[k];\n    }\n    __syncthreads();\n",
         "        sm.stage[i / FCX][i % FCX] = v[k];\n    }\n    __syncthreads();\n"
         "    STAMP(1)\n"),
        ("        dst[(size_t)(y0 + r) * w + x0 + c] = acc;\n    }\n}",
         "        dst[(size_t)(y0 + r) * w + x0 + c] = acc;\n    }\n"
         "    STAMP(2)\n}"),
        ("        if (i < N) sm.in[i / FCOLS][i % FCOLS] = v[k];\n    }\n"
         "    __syncthreads();\n",
         "        if (i < N) sm.in[i / FCOLS][i % FCOLS] = v[k];\n    }\n"
         "    __syncthreads();\n    STAMP(3)\n"),
        ("        if (l == 0) levels[(size_t)y * w + x] = sm.in[r + R][c + R];\n"
         "    }\n}",
         "        if (l == 0) levels[(size_t)y * w + x] = sm.in[r + R][c + R];\n"
         "    }\n    STAMP(4)\n}"),
        ("    cooperative_groups::grid_group grid = "
         "cooperative_groups::this_grid();\n",
         "    cooperative_groups::grid_group grid = "
         "cooperative_groups::this_grid();\n"
         "    long long ph_[7] = {0, 0, 0, 0, 0, 0, 0}, bar_[MAX_LEVELS + 1];\n"
         "    for (int q = 0; q <= MAX_LEVELS; ++q) bar_[q] = 0;\n"
         "    long long last_ = clock64();\n"),
        ("        if (p > 1) grid.sync();\n",
         "        if (p > 1) {\n            const long long b0_ = clock64();\n"
         "            grid.sync();\n            bar_[p] = clock64() - b0_;\n"
         "            ph_[5] += bar_[p];\n            last_ = clock64();\n"
         "        }\n"),
        ("            __syncthreads();        // the previous item's shared "
         "memory\n",
         "            __syncthreads();        // the previous item's shared "
         "memory\n            STAMP(6)\n"),
        ("                          (tile / t.tiles_x[l]) * FTY, sm);\n"
         "            }\n        }\n    }\n}",
         "                          (tile / t.tiles_x[l]) * FTY, sm, ph_, "
         "last_);\n            }\n        }\n    }\n"
         "    if (threadIdx.x == 0 && g_ph) {\n"
         "        for (int q = 0; q < 7; ++q) g_ph[(size_t)blockIdx.x * 24 + q]"
         " = ph_[q];\n"
         "        for (int q = 0; q <= MAX_LEVELS; ++q)\n"
         "            g_ph[(size_t)blockIdx.x * 24 + 7 + q] = bar_[q];\n"
         "    }\n}"),
        ("                             (it / t.tiles_x[p]) * FTY, sm);",
         "                             (it / t.tiles_x[p]) * FTY, sm, ph_, "
         "last_);"),
    ])
    return text


def _swap_lib(name, lib):
    """Put `lib` in place of the port's build of `name`, so the port's own
    wrappers call it (argtypes already set); returns the previous one."""
    old = cuda_build._libs.get(name)
    cuda_build._libs[name] = lib
    return old


def _restore_lib(name, old):
    if old is None:
        cuda_build._libs.pop(name, None)
    else:
        cuda_build._libs[name] = old


def _k3_inputs():
    """chip_smoke.py's gated K3 inputs: features of 5 rendered frames."""
    world, poses = cs._world({})
    cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
    frames = [world.render(*poses[i]).clamp(0, 255).to(torch.uint8).float()
              for i in (0, 2, 4, 6, 8)]
    feats = [frontend.extract_orb(f, cfg) for f in frames]
    return cs.k3_gate_inputs(feats, cfg)


def _phase_summary(c, names):
    """Mean cycles of each phase over the rows of c (one row a warp or a
    block) and the mean of each row's total."""
    return dict(cycles=dict(zip(names, c.mean(0).tolist())),
                share=dict(zip(names, (c.sum(0) / max(c.sum(), 1))
                               .tolist())),
                total_cycles_mean=float(c.sum(1).mean()),
                total_cycles_max=float(c.sum(1).max()))


def _k3():
    """This tree's gated K3 on the gated inputs (4096x1200 window,
    1200x1200 window with NaN rows, 1200x1200 row band), stamped, and
    unstamped builds at 1, 2, 4 and 8 warps a row."""
    from morb_slam_tpu_torch.ops import hamming
    P, I = ctypes.c_void_p, ctypes.c_int
    cases = _k3_inputs()
    res = {}
    text = open(os.path.join(cuda_build.CSRC, "hamming_top2.cu")).read()
    with tempfile.TemporaryDirectory() as tmp:
        lib, ptx = _build(tmp, "hamming_top2", _k3_gated_source(text))
        lib.hamming_top2.argtypes = [P, P, P, I, I, P, P, P, P]
        lib.hamming_top2.restype = I
        lib.set_phase_buf.argtypes = [P]
        lib.hamming_top2_gated.argtypes = [P] * 9 + [I, I, I,
                                                     ctypes.c_float, P, P]
        lib.hamming_top2_gated.restype = I
        old = _swap_lib("hamming_top2", lib)
        try:
            for mode, args, max_d in cases:
                n = args[0].shape[0]
                mask = hamming.gate_mask(*args[2:], mode, max_d=max_d)
                want = hamming.hamming_top2_gated_plain(*args, mode,
                                                        max_d=max_d)
                # a warp's 4 counters: at most 8 warps a row
                ph = torch.zeros(n * 32 + 64, dtype=torch.int64,
                                 device="cuda")
                call = lambda args=args, mode=mode, max_d=max_d: \
                    hamming.hamming_top2_gated(*args, mode, max_d=max_d)
                cuda_build.check(lib.set_phase_buf(ph.data_ptr()), "phases")
                for _ in range(3):
                    got = call()
                ph.zero_()
                got = call()
                torch.cuda.synchronize()
                cuda_build.check(lib.set_phase_buf(None), "phases")
                c = ph.view(-1, 4).cpu().numpy().astype(float)
                c = c[c.sum(1) > 0]
                row = dict(shape=f"{n}x{args[1].shape[0]}",
                           rows_flagged=int(args[5].sum()),
                           pairs_passed=int(mask.sum()),
                           bitwise_equal_plain=all(
                               torch.equal(a, b) for a, b in zip(got, want)),
                           **_phase_summary(c, K3_GATED_PHASES),
                           device_ms_stamped=cs.device_ms(
                               call, "hamming_top2_gated_kernel"))
                res[mode] = row
        finally:
            _restore_lib("hamming_top2", old)
        res["ptxas"] = ptx.strip()
        res["unstamped"] = {}
        for wpr in (1, 2, 4, 8):
            d = os.path.join(tmp, f"w{wpr}")
            os.makedirs(d)
            # the warps a row fixed in place of their choice from N
            ulib, uptx = _build(d, "hamming_top2", _replace_once(
                text, "    while (wpr < 8 && (long long)N * wpr < 32LL * "
                "n_sm) wpr *= 2;\n", f"    wpr = {wpr};\n"))
            ulib.hamming_top2.argtypes = lib.hamming_top2.argtypes
            ulib.hamming_top2.restype = I
            ulib.hamming_top2_gated.argtypes = lib.hamming_top2_gated.argtypes
            ulib.hamming_top2_gated.restype = I
            old = _swap_lib("hamming_top2", ulib)
            try:
                res["unstamped"][f"warps_a_row={wpr}"] = {
                    mode: cs.device_ms(
                        lambda args=args, mode=mode, max_d=max_d:
                        hamming.hamming_top2_gated(*args, mode, max_d=max_d),
                        "hamming_top2_gated_kernel")
                    for mode, args, max_d in cases}
            finally:
                _restore_lib("hamming_top2", old)
    return res


def _k6():
    """This tree's one-launch K6 on the first rendered 752x480 frame, 8
    levels, stamped (phases over all levels, each grid barrier's wait), and
    unstamped builds at 1, 2 and 4 blocks a multiprocessor and as many as
    are co-resident, each bitwise against the per-level path."""
    P, I = ctypes.c_void_p, ctypes.c_int
    IP = ctypes.POINTER(ctypes.c_int)
    world, poses = cs._world({})
    frame = world.render(*poses[0]).clamp(0, 255).to(torch.uint8).float()
    L, sc = 8, 1.2
    text = open(os.path.join(cuda_build.CSRC, "pyramid_blur.cu")).read()
    res = {}

    def set_args(lib):
        lib.pyramid_level.argtypes = [P, I, I, P, I, I, P, P]
        lib.pyramid_level.restype = I
        lib.blur_levels.argtypes = [P, P, I, IP, IP, IP,
                                    ctypes.POINTER(ctypes.c_float), P]
        lib.blur_levels.restype = I
        lib.pyramid_blur.argtypes = [P] * 6
        lib.pyramid_blur.restype = I
    with tempfile.TemporaryDirectory() as tmp:
        lib, ptx = _build(tmp, "pyramid_blur", _k6_fused_source(text))
        set_args(lib)
        lib.set_phase_buf.argtypes = [P]
        old = _swap_lib("pyramid_blur", lib)
        try:
            ref = image.build_pyramid(frame, L, sc)
            ref_blur = image.blur_levels(ref)
            ph = torch.zeros(4096 * 24, dtype=torch.int64, device="cuda")
            call = lambda: image.pyramid_blur(frame, L, sc)
            cuda_build.check(lib.set_phase_buf(ph.data_ptr()), "phases")
            for _ in range(3):
                call()
            ph.zero_()
            lv, bl = call()
            torch.cuda.synchronize()
            cuda_build.check(lib.set_phase_buf(None), "phases")
            c = ph.view(-1, 24).cpu().numpy().astype(float)
            c = c[c.sum(1) > 0]
            res["blocks"] = int(c.shape[0])
            res["bitwise_equal_per_level_path"] = all(
                torch.equal(a, b) for a, b in zip(lv + bl,
                                                  ref + ref_blur))
            res.update(_phase_summary(c[:, :7], K6_FUSED_PHASES))
            # the wait at the barrier before phase p = 2..L; the least
            # wait is the barrier's own cost for the last block in
            bars = c[:, 7 + 2:7 + L + 1]
            res["barrier_wait_cycles_by_phase"] = dict(
                mean=bars.mean(0).tolist(), min=bars.min(0).tolist(),
                max=bars.max(0).tolist())
            res["device_ms_stamped"] = cs.device_ms(
                call, "pyramid_blur_kernel")
        finally:
            _restore_lib("pyramid_blur", old)
        res["ptxas"] = ptx.strip()
        res["unstamped"] = {}
        for v in (1, 2, 4, 0):
            d = os.path.join(tmp, f"grid_per_sm{v}")
            os.makedirs(d)
            # at most v blocks a multiprocessor (0: as co-resident)
            cap = (f"        if (per_sm > {v}) per_sm = {v};\n" if v else "")
            ulib, uptx = _build(d, "pyramid_blur", _replace_once(
                text, "        max_grid[dev] = per_sm * sms;\n",
                cap + "        max_grid[dev] = per_sm * sms;\n"))
            set_args(ulib)
            old = _swap_lib("pyramid_blur", ulib)
            try:
                call = lambda: image.pyramid_blur(frame, L, sc)
                lv, bl = call()
                res["unstamped"][f"grid_per_sm={v}"] = dict(
                    bitwise_equal_per_level_path=all(
                        torch.equal(a, b) for a, b in zip(lv + bl,
                                                          ref + ref_blur)),
                    device_ms=cs.device_ms(call, "pyramid_blur_kernel"),
                    call_ms=cs.time_ms(call), ptxas=uptx.strip())
            finally:
                _restore_lib("pyramid_blur", old)
    return res


K4_OLD_ARGS = 15, 5, 8


def _k4_old_lib(tmp, csrc, patch=None):
    """The earlier K4 (commit 001dca8: a warp a landmark, its lane 0 walking
    the observations, the coupling added into global memory) built from
    `csrc`, optionally with a text patch."""
    text = open(os.path.join(csrc, "ba_assemble.cu")).read()
    lib, ptx = _build(tmp, "ba_assemble", patch(text) if patch else text)
    P, I = ctypes.c_void_p, ctypes.c_int
    n_p, n_i, n_q = K4_OLD_ARGS
    lib.ba_assemble.argtypes = [P] * n_p + [I] * n_i + [P] * n_q
    lib.ba_assemble.restype = I
    return lib, ptx


def _k4_old(lib, p, R, t, X, order=None, body=False, per_obs=False):
    """The earlier K4 through the earlier wrapper's steps (Wpl zero-filled
    by torch, then the kernel): BlockSums or ObsBlocks."""
    from morb_slam_tpu_torch.optim import ba
    dev, f32 = R.device, torch.float32
    K, L, O = R.shape[0], X.shape[0], p.obs_uv.shape[0]
    order = ba.obs_order(p) if order is None else order
    c = [x.contiguous() for x in (R, t, X, p.obs_kf, p.obs_lm, p.obs_uv,
                                  p.obs_ur, p.obs_info, p.obs_mask,
                                  p.lm_opt) + tuple(order)]
    base = p.baseline.to(device=dev, dtype=f32).reshape(1)
    coupling = torch.zeros((O, 6, 3), dtype=f32, device=dev) if per_obs \
        else torch.empty((L, K, 6, 3), dtype=f32, device=dev)
    out = (ba.ObsBlocks if per_obs else ba.BlockSums)(
        torch.empty((K, 6, 6), dtype=f32, device=dev),
        torch.empty((K, 6), dtype=f32, device=dev), coupling,
        torch.empty((L, 3, 3), dtype=f32, device=dev),
        torch.empty((L, 3), dtype=f32, device=dev),
        torch.zeros((), dtype=f32, device=dev))
    scratch = torch.zeros(max(K, 1) + 1, dtype=f32, device=dev)
    cuda_build.check(lib.ba_assemble(
        *(x.data_ptr() for x in c), base.data_ptr(), int(body),
        int(per_obs), K, L, O, *(x.data_ptr() for x in out),
        scratch.data_ptr(), cuda_build.stream_ptr(R)), "earlier K4")
    return out


def _k13_old_lib(tmp, csrc):
    """The earlier K13 (commit 001dca8: a warp an edge, a thread an entry
    of H, a one-warp cost kernel) built from `csrc`."""
    for h in ("imu_edge.cuh", "dual.cuh"):
        shutil.copy(os.path.join(csrc, h), tmp)
    lib, ptx = _build(tmp, "vi_edges", open(os.path.join(
        csrc, "vi_edges.cu")).read())
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vi_edges_system.argtypes = [P] * 6 + [I] + [P] * 5
    lib.vi_edges_system.restype = I
    lib.vi_edges_cost.argtypes = [P] * 4 + [I, P, P]
    lib.vi_edges_cost.restype = I
    return lib, ptx


def _k13_old(lib, p, R_wb, p_wb, v, bias, Hpp, bp):
    """The earlier K13's system and cost at one state: (H, b, cost)."""
    W = p.R_wb.shape[0]
    state, cst, prev, valid = vi_ba._k13_inputs(p, R_wb, p_wb, v, bias)
    Hpp, bp = Hpp.contiguous(), bp.contiguous()
    dev, f32, D = p_wb.device, torch.float32, 15 * W
    He = torch.empty((W, 30, 30), dtype=f32, device=dev)
    ge = torch.empty((W, 30), dtype=f32, device=dev)
    H = torch.empty((D, D), dtype=f32, device=dev)
    b = torch.empty(D, dtype=f32, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    st = cuda_build.stream_ptr(p_wb)
    cuda_build.check(lib.vi_edges_system(
        state.data_ptr(), cst.data_ptr(), prev.data_ptr(), valid.data_ptr(),
        Hpp.data_ptr(), bp.data_ptr(), W, He.data_ptr(), ge.data_ptr(),
        H.data_ptr(), b.data_ptr(), st), "earlier K13 system")
    cuda_build.check(lib.vi_edges_cost(
        state.data_ptr(), cst.data_ptr(), prev.data_ptr(), valid.data_ptr(),
        W, cost.data_ptr(), st), "earlier K13 cost")
    return H, b, cost


def _equal_fields(a, b, names):
    """{field: True where bitwise equal, else the max difference relative
    to the earlier field's max-abs}."""
    out = {}
    for n, x, y in zip(names, a, b):
        if torch.equal(x, y):
            out[n] = True
        else:
            out[n] = float((x - y).abs().max()) / max(
                float(y.abs().max()), 1e-30)
    return out


class _Compare:
    """Every K4 and K13 call of a path also run through the earlier
    kernels on the same inputs (module attributes wrapped): calls and
    bitwise-equal calls by mode, the first unequal call's fields, and each
    mode's last problem kept for the timings."""

    def __init__(self, lib4, lib13):
        from morb_slam_tpu_torch.optim import ba
        self.ba, self.lib4, self.lib13 = ba, lib4, lib13
        self.stats, self.last = {}, {}

    def _count(self, mode, eq):
        st = self.stats.setdefault(mode, dict(calls=0, bitwise_equal=0))
        st["calls"] += 1
        ok = all(v is True for v in eq.values())
        st["bitwise_equal"] += int(ok)
        if not ok and "first_unequal" not in st:
            st["first_unequal"] = eq

    def __enter__(self):
        ba = self.ba
        self.saved = (ba.assemble, vi_ba.inertial_terms)
        a4, t13 = self.saved

        def assemble(p, R, t, X, order=None, body=False, per_obs=False):
            got = a4(p, R, t, X, order, body, per_obs)
            old = _k4_old(self.lib4, p, R, t, X, order, body, per_obs)
            mode = "per_obs" if per_obs else ("local, body tangent" if body
                                              else "local, camera tangent")
            self._count(mode, _equal_fields(got, old, got._fields))
            self.last[mode] = (p, R, t, X, order, body, per_obs)
            return got

        def terms(p, R_wb, p_wb, v, bias, Hpp, bp, system=True):
            got = t13(p, R_wb, p_wb, v, bias, Hpp, bp, system)
            old = _k13_old(self.lib13, p, R_wb, p_wb, v, bias, Hpp, bp)
            self._count("inertial_terms", _equal_fields(
                got, old, ("H", "b", "cost")))
            self.last["inertial_terms"] = (p, R_wb, p_wb, v, bias, Hpp, bp)
            return got
        ba.assemble, vi_ba.inertial_terms = assemble, terms
        return self

    def __exit__(self, *exc):
        self.ba.assemble, vi_ba.inertial_terms = self.saved


def _k4_times(lib_old, args, reps):
    """This tree's K4 against the earlier one on one problem: bits,
    kernel device ms, kernels and call ms per call."""
    from morb_slam_tpu_torch.optim import ba
    p, R, t, X, order, body, per_obs = args
    order = ba.obs_order(p) if order is None else order
    new = lambda: ba.assemble(p, R, t, X, order, body, per_obs)  # noqa
    old = lambda: _k4_old(lib_old, p, R, t, X, order, body,  # noqa: E731
                          per_obs)
    got = new()
    return dict(
        K=R.shape[0], L=X.shape[0], O=p.obs_uv.shape[0],
        active_obs=int(p.obs_mask.sum()), body=body, per_obs=per_obs,
        bitwise_equal_earlier=_equal_fields(got, old(), got._fields),
        repeat_bitwise_equal=all(torch.equal(a, b)
                                 for a, b in zip(got, new())),
        ms=cs.device_ms(new, "ba_assemble_kernel", reps),
        ms_earlier=cs.device_ms(old, "ba_assemble_kernel", reps),
        ms_earlier_all_kernels=cs.device_ms(old, None, reps),
        ms_earlier_all_kernels_is="the kernel, its zero fills and copies",
        ms_all_kernels=cs.device_ms(new, None, reps),
        kernels_per_call=cs.kernels_per_call(new),
        kernels_per_call_earlier=cs.kernels_per_call(old),
        call_ms=cs.time_ms(new), call_ms_earlier=cs.time_ms(old),
        bound_ms=cs._ba_bound(p, per_obs)[0][0])


def _k13_times(lib_old, args, reps):
    """This tree's K13 against the earlier one on one window problem."""
    new = lambda: vi_ba.inertial_terms(*args)              # noqa: E731
    old = lambda: _k13_old(lib_old, *args)                 # noqa: E731
    got = new()
    p = args[0]
    return dict(
        W=p.R_wb.shape[0], valid_edges=int(p.e_valid.sum()),
        bitwise_equal_earlier=_equal_fields(got, old(), ("H", "b", "cost")),
        repeat_bitwise_equal=all(torch.equal(a, b)
                                 for a, b in zip(got, new())),
        ms=cs.device_ms(new, "vi_terms_kernel", reps),
        ms_is="its one cooperative launch",
        ms_earlier=cs.span_ms(old, "vi_edge_kernel", "vi_cost_kernel", reps),
        ms_earlier_is="from its edge kernel's start to its cost kernel's "
                      "end (system and cost: three launches)",
        ms_parts_earlier={k: cs.device_ms(old, k, reps) for k in (
            "vi_edge_kernel", "vi_assemble_kernel", "vi_cost_kernel")},
        kernels_per_call=cs.kernels_per_call(new),
        kernels_per_call_earlier=cs.kernels_per_call(old),
        call_ms=cs.time_ms(new), call_ms_earlier=cs.time_ms(old))


def _k4_part(text, part):
    """ba_assemble.cu (either tree's) with every block but one kind's
    returning at once: `kf` the keyframe blocks, `lm` the landmark blocks,
    `slot` the slot blocks (this tree's per-observation mode) alone."""
    kf = "    if ((int)blockIdx.x < K) {\n"
    if part == "kf":
        after = "    const int b0 = blockIdx.x - K;\n"
        if after not in text:
            after = "    // ---- landmark l"
        return _replace_once(text, after, "    return;\n" + after)
    if part == "lm":
        text = _replace_once(text, kf, kf + "        if (K >= 0) return;\n")
        if "// ---- per-observation mode" in text:
            text = _replace_once(text, "    // ---- per-observation mode",
                                 "    return;\n    // ---- per-observation "
                                 "mode")
        return text
    text = _replace_once(text, kf, kf + "        if (K >= 0) return;\n")
    return _replace_once(text, "    if (b0 < lm_blocks) {\n",
                         "    if (b0 < lm_blocks) {\n        return;\n")


def _k4_parts(tmp, csrc, args, reps):
    """Device ms of each kind of block alone, in both trees' K4, on one
    problem (the others return at once; outputs not checked)."""
    from morb_slam_tpu_torch.optim import ba
    p, R, t, X, order, body, per_obs = args
    order = ba.obs_order(p) if order is None else order
    out = {}
    parts = ("kf", "lm") + (("slot",) if per_obs else ())
    for part in parts:
        d = os.path.join(tmp, f"new_{part}_{int(per_obs)}")
        os.makedirs(d, exist_ok=True)
        lib, _ = _k4_old_lib(d, cuda_build.CSRC,
                             lambda x, part=part: _k4_part(x, part))
        out[part] = cs.device_ms(lambda: _k4_old(
            lib, p, R, t, X, order, body, per_obs), "ba_assemble_kernel",
            reps)
        if part == "slot":
            continue
        d = os.path.join(tmp, f"old_{part}_{int(per_obs)}")
        os.makedirs(d, exist_ok=True)
        lib, _ = _k4_old_lib(d, csrc, lambda x, part=part: _k4_part(x, part))
        out[f"earlier {part}"] = cs.device_ms(lambda: _k4_old(
            lib, p, R, t, X, order, body, per_obs), "ba_assemble_kernel",
            reps)
    return out


def _k4_per_block(tmp, named_args, reps):
    """This tree's K4 built at 32, 64, 128 and 256 landmarks a landmark
    block: bits against the default build and device ms on each problem."""
    from morb_slam_tpu_torch.optim import ba
    text = open(os.path.join(cuda_build.CSRC, "ba_assemble.cu")).read()
    out = {}
    for n in (32, 64, 128, 256):
        d = os.path.join(tmp, f"lm_per_block_{n}")
        os.makedirs(d)
        lib, ptx = _build(d, "ba_assemble", _define(text, "LM_PER_BLOCK", n))
        P, I = ctypes.c_void_p, ctypes.c_int
        n_p, n_i, n_q = K4_OLD_ARGS
        lib.ba_assemble.argtypes = [P] * n_p + [I] * n_i + [P] * n_q
        lib.ba_assemble.restype = I
        res = {"ptxas": ptx.strip()}
        for name, (p, R, t, X, order, body, per_obs) in named_args.items():
            order = ba.obs_order(p) if order is None else order
            want = ba.assemble(p, R, t, X, order, body, per_obs)
            old = _swap_lib("ba_assemble", lib)
            try:
                call = lambda: ba.assemble(p, R, t, X, order, body,  # noqa
                                           per_obs)
                res[name] = dict(
                    bitwise_equal=all(torch.equal(a, b)
                                      for a, b in zip(call(), want)),
                    ms=cs.device_ms(call, "ba_assemble_kernel", reps))
            finally:
                _restore_lib("ba_assemble", old)
        out[n] = res
    return out


def _k13_threads(tmp, args, reps):
    """This tree's K13 built at 128 and 256 threads a block (the edge
    blocks' products and the assembly's grid stride): bits against the
    default build and device ms of a call."""
    from morb_slam_tpu_torch.optim import vi_ba as vb
    text = open(os.path.join(cuda_build.CSRC, "vi_edges.cu")).read()
    want = vb.inertial_terms(*args)
    out = {}
    for n in (128, 256):
        d = os.path.join(tmp, f"k13_threads_{n}")
        os.makedirs(d)
        for h in ("imu_edge.cuh", "dual.cuh"):
            shutil.copy(os.path.join(cuda_build.CSRC, h), d)
        lib, ptx = _build(d, "vi_edges", _define(text, "THREADS", n))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vi_terms.argtypes = [P] * 6 + [I] + [P] * 7
        lib.vi_terms.restype = I
        old = _swap_lib("vi_edges", lib)
        try:
            call = lambda: vb.inertial_terms(*args)          # noqa: E731
            got = call()
            out[n] = dict(
                bitwise_equal=all(torch.equal(a, b)
                                  for a, b in zip(got, want)),
                ms=cs.device_ms(call, "vi_terms_kernel", reps),
                ptxas=ptx.strip())
        finally:
            _restore_lib("vi_edges", old)
    return out


K13_PHASES = ["edge terms and lists (edge blocks), lists and dead chunks' "
              "zeros (the others)", "(none)", "grid barrier",
              "live chunks, b and the cost"]


def _k13_stamped_source(text):
    """vi_edges.cu with thread 0 of every block writing the cycles of its
    four phases (K13_PHASES) to a buffer set by set_stamp_buf."""
    text = _patch(text, [
        ("    cooperative_groups::grid_group grid = "
         "cooperative_groups::this_grid();\n",
         "    cooperative_groups::grid_group grid = "
         "cooperative_groups::this_grid();\n"
         "    const long long t0_ = clock64();\n"),
        ("    const Window w{W, NW, smem, (const unsigned*)(smem + W),\n"
         "                   (const unsigned*)(smem + W) + W * NW};\n"
         "    grid.sync();\n",
         "    const long long t1_ = clock64();\n"
         "    const Window w{W, NW, smem, (const unsigned*)(smem + W),\n"
         "                   (const unsigned*)(smem + W) + W * NW};\n"
         "    grid.sync();\n"),
        ("    grid.sync();\n    if (blockIdx.x",
         "    const long long t2_ = clock64();\n    grid.sync();\n"
         "    const long long t3_ = clock64();\n    if (blockIdx.x"),
        ("            for (int t = 0; f + t < nH; ++t) H[f + t] = v[t];\n    }\n}\n",
         "            for (int t = 0; f + t < nH; ++t) H[f + t] = v[t];\n    }\n"
         "    if (k13_stamps && tid == 0) {\n"
         "        long long* o_ = k13_stamps + 4 * blockIdx.x;\n"
         "        o_[0] = t1_ - t0_; o_[1] = t2_ - t1_; o_[2] = t3_ - t2_;\n"
         "        o_[3] = clock64() - t3_;\n    }\n}\n"),
        ("#define THREADS 256\n",
         "#define THREADS 256\n__device__ long long* k13_stamps;\n"
         "extern \"C\" int set_stamp_buf(void* p) {\n"
         "    return (int)cudaMemcpyToSymbol(k13_stamps, &p, sizeof(p));\n}\n"),
    ])
    return text


def _k13_stamps(tmp, args):
    """This tree's K13 with thread 0 of every block stamping its phases
    (clock64 cycles): edge blocks and assembly blocks summarized apart."""
    from morb_slam_tpu_torch.optim import vi_ba as vb
    d = os.path.join(tmp, "k13_stamped")
    os.makedirs(d)
    for h in ("imu_edge.cuh", "dual.cuh"):
        shutil.copy(os.path.join(cuda_build.CSRC, h), d)
    text = open(os.path.join(cuda_build.CSRC, "vi_edges.cu")).read()
    lib, ptx = _build(d, "vi_edges", _k13_stamped_source(text))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vi_terms.argtypes = [P] * 6 + [I] + [P] * 7
    lib.vi_terms.restype = I
    lib.set_stamp_buf.argtypes = [P]
    lib.set_stamp_buf.restype = I
    buf = torch.zeros(4 * 1024, dtype=torch.int64, device="cuda")
    want = vb.inertial_terms(*args)
    old = _swap_lib("vi_edges", lib)
    try:
        vb.inertial_terms(*args)
        cuda_build.check(lib.set_stamp_buf(buf.data_ptr()), "stamps")
        got = vb.inertial_terms(*args)
        torch.cuda.synchronize()
        cuda_build.check(lib.set_stamp_buf(None), "stamps")
    finally:
        _restore_lib("vi_edges", old)
    W = args[0].R_wb.shape[0]
    c = buf.view(-1, 4).cpu().numpy().astype(float)
    n = int((c.sum(1) > 0).sum())
    return dict(bitwise_equal_unstamped=all(
        torch.equal(a, b) for a, b in zip(got, want)), blocks=n,
        edge_blocks=_phase_summary(c[:W], K13_PHASES),
        assembly_blocks=_phase_summary(c[W:n], K13_PHASES),
        ptxas=ptx.strip())


def _k4_k13(csrc, reps):
    """This tree's K4 and K13 against the earlier ones (commit 001dca8),
    built beside them: the stereo, vi and loop paths with every K4 and K13
    call also run through the earlier kernels (bitwise-equal calls by
    mode), then both trees' times on each mode's last problem of the paths
    and on the loop phase's global BA problem at its capacities, the
    device time of each kind of K4 block alone, K4 at other landmark-block
    sizes and K13 at other block sizes."""
    from morb_slam_tpu_torch.optim import ba
    res = dict(card=cs.nvidia_smi(), sources=csrc,
               ptxas=dict(ba_assemble=cuda_build.ptxas_report(
                   "ba_assemble").strip(), vi_edges=cuda_build.ptxas_report(
                   "vi_edges").strip()))
    with tempfile.TemporaryDirectory() as tmp:
        d4, d13 = os.path.join(tmp, "old4"), os.path.join(tmp, "old13")
        os.makedirs(d4)
        os.makedirs(d13)
        lib4, ptx4 = _k4_old_lib(d4, csrc)
        lib13, ptx13 = _k13_old_lib(d13, csrc)
        res["ptxas_earlier"] = dict(ba_assemble=ptx4.strip(),
                                    vi_edges=ptx13.strip())
        state = {"profile_out": None, "plain_rows": []}
        cs.phase_device(state)
        last = {}
        for name, phase in (("stereo", cs.phase_stereo),
                            ("vi", cs.phase_vi), ("loop", cs.phase_loop)):
            with _Compare(lib4, lib13) as cmp:
                try:
                    phase(state)
                except AssertionError as e:
                    # a gate the path missed: kept in the result (the
                    # comparisons up to it stand), the tool exits non-zero
                    res.setdefault("gates_missed", {})[name] = repr(e)
            res[f"{name} path"] = cmp.stats
            last.update({f"{name}: {k}": v for k, v in cmp.last.items()})
            _write(res, "kernel_phases_k4_k13.json")
        torch.cuda.empty_cache()
        times = {k: (_k13_times(lib13, v, reps) if "inertial_terms" in k
                     else _k4_times(lib4, v, reps)) for k, v in last.items()}
        p = cs._global_problem()
        gargs = (p, p.R, p.t, p.X, ba.obs_order(p), False, True)
        times["capacities: per_obs"] = _k4_times(lib4, gargs, reps)
        res["times"] = times
        _write(res, "kernel_phases_k4_k13.json")
        parts = {}
        for k in ("stereo: local, camera tangent", "loop: per_obs"):
            if k in last:
                parts[k] = _k4_parts(tmp, csrc, last[k], reps)
        parts["capacities: per_obs"] = _k4_parts(tmp, csrc, gargs, reps)
        res["k4_parts_ms"] = parts
        res["k4_landmarks_per_block"] = _k4_per_block(tmp, {
            k: v for k, v in list(last.items()) + [
                ("capacities: per_obs", gargs)]
            if k in ("stereo: local, camera tangent", "vi: local, body tangent",
                     "loop: per_obs", "capacities: per_obs")}, reps)
        _write(res, "kernel_phases_k4_k13.json")
        if "vi: inertial_terms" in last:
            res["k13_threads"] = _k13_threads(tmp, last["vi: inertial_terms"],
                                              reps)
            res["k13_stamps"] = _k13_stamps(tmp, last["vi: inertial_terms"])
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", help="morb_slam_tpu_torch/csrc of commit "
                    "001dca8 (the earlier K4 and K13; with --k4 --k13)")
    ap.add_argument("--new", action="store_true",
                    help="stamp this tree's kernels (K12 unless --k5, --k1, "
                    "--k3 or --k6 is given)")
    ap.add_argument("--k5", action="store_true", help="stamp K5 instead")
    ap.add_argument("--k1", action="store_true", help="stamp K1 instead")
    ap.add_argument("--k3", action="store_true",
                    help="stamp K3's gated mode instead")
    ap.add_argument("--k6", action="store_true",
                    help="stamp K6's one launch instead")
    ap.add_argument("--k4", action="store_true",
                    help="with --k13 and --csrc: this tree's K4 and K13 "
                    "against the earlier ones on the paths' problems")
    ap.add_argument("--k13", action="store_true",
                    help="with --k4 and --csrc (see --k4)")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if a.new == bool(a.csrc):
        raise SystemExit("give --csrc or --new")
    if a.k4 or a.k13:
        if not (a.k4 and a.k13 and a.csrc) or a.k3 or a.k6 or a.k5 or a.k1:
            raise SystemExit("--k4 --k13 go with --csrc alone")
        res = _k4_k13(a.csrc, a.reps)
        _write(res, "kernel_phases_k4_k13.json")
        if "gates_missed" in res:
            raise SystemExit(f"gates missed: {res['gates_missed']}")
        return
    if a.csrc:
        raise SystemExit("--csrc goes with --k4 --k13 only")
    if a.k3 or a.k6:
        res = dict(card=cs.nvidia_smi(), sources="this tree")
        if a.k3:
            res["k3"] = _k3()
        if a.k6:
            res["k6"] = _k6()
        return _write(res, "kernel_phases_k3_k6_new.json")
    if a.k5 or a.k1:
        res = dict(card=cs.nvidia_smi(), sources="this tree")
        if a.k5:
            res["k5"] = _k5(a.reps)
            res["k5_512_threads"] = _k5(a.reps, 512)
        if a.k1:
            res["k1"] = _k1_new()
        return _write(res, "kernel_phases_k5_k1_new.json")
    return _new_k12(a.reps)


if __name__ == "__main__":
    main()
