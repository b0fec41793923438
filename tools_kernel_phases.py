"""Phase shares of hand-written kernels on the card, stamped with
`clock64()`, and earlier forms of kernels against this tree's: this
tree's K12 (`csrc/pose_inertial.cu`), K5 (`csrc/pose_opt.cu`), K1
(`csrc/fast_select.cu`), K3 (`csrc/hamming_top2.cu`) and K6
(`csrc/pyramid_blur.cu`), and K7 and K18 against their earlier forms.

    python3 tools_kernel_phases.py --new
    python3 tools_kernel_phases.py --k5 --k1 --new
    python3 tools_kernel_phases.py --k3 --k6 --new
    git archive 08f7233 morb_slam_tpu_torch/csrc | tar -x -C old15/
    python3 tools_kernel_phases.py --k7 --k18 --csrc old15/morb_slam_tpu_torch/csrc

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
`--k7 --k18` with `--csrc`: this tree's K7 (`csrc/stereo_sad.cu`, the
whole tail of match_stereo in one launch) and K18's refinement
(`csrc/sim3_verify.cu`, a cluster of 8 blocks) against the earlier ones
(as of commit 08f7233: K7 the sweep alone, then the gather and the
filter in torch; the refinement one block of 128 threads), built beside
them. The stereo, vi, loop and vi_loop paths of chip_smoke.py run with
every K7 launch and every K18 refinement on the card also run through
the earlier kernels on the same inputs (calls and bitwise-equal calls:
K7's u_right, depth and valid; K18's s, R, t and n_good); then, on the
stereo path's last K7 call, both trees' bits and times (the K7 kernel's
device ms, all kernels' device ms, kernels and event ms per call; the
same for the whole match_stereo), and, on every K18 call of the loop
path and the vi_loop branch, the refinement's device ms in both trees
and in this tree's source built at 16 blocks a cluster (the non-portable
size). Prints one JSON object (also written to chiprun_out/
kernel_phases_new.json, kernel_phases_k5_k1_new.json,
kernel_phases_k3_k6_new.json or kernel_phases_k7_k18.json, the last also
after each path). The stamp anchors match those sources only. Needs a
CUDA card and nvcc.

The earlier forms of K12, K2 (as of commit 4ceff5a), K5 and K1 (as of
commit ea2e66d) are stamped by this script as of commit a873e66, those
of K3 and K6 (as of commit a873e66: the masked K3 on a dense gate, K6
launched per level) by this script as of commit 133af77, K11 and K17
(as of commit 133af77), and this tree's K11 stamped, by this script as
of commit 5e4d05b, K14 and K16 (as of commit 5e4d05b: K14's pass
launches with the CG loop in torch, K16 in three kernels) by this script
as of commit 001dca8, and K4 and K13 (as of commit 001dca8: K4 a warp a
landmark with one lane walking it, K13 a system of two launches and a
cost of one) by this script as of commit 08f7233.
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


def _non_portable(text):
    """sim3_verify.cu with sim3_refine allowing a cluster above the portable
    8 blocks (cudaFuncAttributeNonPortableClusterSizeAllowed), set before
    its launch."""
    return _replace_once(
        text, "    cudaLaunchConfig_t cfg = {};\n",
        "    rc = (int)cudaFuncSetAttribute(\n"
        "        refine_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,"
        " 1);\n    if (rc) return rc;\n    cudaLaunchConfig_t cfg = {};\n")


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


def _equal_fields(a, b, names):
    """{field: True where bitwise equal (NaN where NaN), else the max
    difference relative to the earlier field's max-abs}."""
    out = {}
    for n, x, y in zip(names, a, b):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.dtype == torch.bool or not x.is_floating_point():
            out[n] = True if torch.equal(x, y) else int((x != y).sum())
            continue
        nx, ny = torch.isnan(x), torch.isnan(y)
        if torch.equal(nx, ny) and torch.equal(
                x[~nx].view(torch.int32), y[~ny].view(torch.int32)):
            out[n] = True
        else:
            out[n] = float((x - y).abs().max()) / max(
                float(y.abs().max()), 1e-30)
    return out


def _k7_old_lib(tmp, csrc):
    """The earlier K7 (commit 08f7233: the sweep alone, a warp a keypoint)
    built from `csrc`."""
    lib, ptx = _build(tmp, "stereo_sad", open(os.path.join(
        csrc, "stereo_sad.cu")).read())
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.stereo_sad.argtypes = [P, P, I, I, P, P, I, P, P, P, P]
    lib.stereo_sad.restype = I
    return lib, ptx


def _k7_old(lib, img_l, img_r, uv_l, uv_r, best_idx, matched, bf, max_d):
    """The earlier match_stereo after the row search: the gather of the
    matched right x, the earlier kernel, then filter_matches in torch."""
    from morb_slam_tpu_torch.ops import stereo
    n = uv_l.shape[0]
    u0 = uv_r[best_idx.long(), 0].contiguous()
    uv = uv_l.contiguous()
    out = [torch.empty(n, dtype=torch.float32, device=uv.device)
           for _ in range(2)] + [torch.empty(n, dtype=torch.int32,
                                             device=uv.device)]
    img_l, img_r = img_l.contiguous(), img_r.contiguous()
    cuda_build.check(lib.stereo_sad(
        img_l.data_ptr(), img_r.data_ptr(), img_l.shape[0], img_l.shape[1],
        uv.data_ptr(), u0.data_ptr(), n, *(t.data_ptr() for t in out),
        cuda_build.stream_ptr(uv)), "earlier K7")
    return stereo.filter_matches(uv[:, 0], out[0], out[1], matched, bf,
                                 max_d)


def _k18_lib(tmp, csrc, text=None):
    """The earlier K18 (commit 08f7233: the refinement one block of 128
    threads) built from `csrc`, or this tree's source `text` as given."""
    lib, ptx = _build(tmp, "sim3_verify", text or open(os.path.join(
        csrc, "sim3_verify.cu")).read())
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sim3_window_match.argtypes = [P] * 8 + [I, I, Fl, Fl] + [P] * 7
    lib.sim3_window_match.restype = I
    lib.sim3_refine.argtypes = [P] * 8 + [I, P, P, P, P]
    lib.sim3_refine.restype = I
    return lib, ptx


def _k18_with(lib, args, refine=None):
    """sim3_refine (or the unwrapped `refine`) through `lib` in place of
    this tree's build."""
    from morb_slam_tpu_torch.pipeline import loop_closing as lc
    old = _swap_lib("sim3_verify", lib)
    try:
        return (refine or lc.sim3_refine)(*args)
    finally:
        _restore_lib("sim3_verify", old)


K18_PHASES = ["duals (tangent 0)", "wait: the other tangents' duals",
              "evaluations", "wait: the chunk's evaluations",
              "chains (slot 0 entry 0, slot 14 entry 22)",
              "wait: the chains", "partials written", "cluster.sync",
              "staging the 128 x 35 partials (DSMEM)", "wait: staging",
              "sums (128 in slot order)", "wait: sums",
              "reclassification", "wait: reclassification",
              "Cholesky and substitutions (thread 0)", "wait: the solve"]


def _k18_stamped_source(text):
    """sim3_verify.cu with thread 0 of block 0 of the refinement adding the
    cycles of each phase (K18_PHASES) up over the launch, written to a
    buffer set by set_stamp_buf."""
    st = ("#define STAMP(k) if (stamp_on_) { long long t_ = clock64(); "
          "ph_[k] += t_ - last_; last_ = t_; }\n")
    return _patch(text, [
        ("namespace cg = cooperative_groups;\n",
         "namespace cg = cooperative_groups;\n"
         "__device__ long long* k18_stamps;\n"
         "extern \"C\" int set_stamp_buf(void* p) {\n"
         "    return (int)cudaMemcpyToSymbol(k18_stamps, &p, sizeof(p));\n}\n"
         + st),
        ("    const int tid = threadIdx.x, lane = tid & 31;\n",
         "    const int tid = threadIdx.x, lane = tid & 31;\n"
         "    const bool stamp_on_ = k18_stamps && tid == 0 && b == 0;\n"
         "    long long ph_[16];\n"
         "    for (int q = 0; q < 16; ++q) ph_[q] = 0;\n"
         "    long long last_ = clock64();\n"),
        ("            if (gn ? tid < 8 : tid == 7) sim3_duals(tid, S.x, sim, "
         "S.T[tid]);\n            __syncthreads();\n",
         "            if (gn ? tid < 8 : tid == 7) sim3_duals(tid, S.x, sim, "
         "S.T[tid]);\n            STAMP(0);\n            __syncthreads();\n"
         "            STAMP(1);\n"),
        ("                __syncthreads();\n                continue;\n",
         "                STAMP(12);\n                __syncthreads();\n"
         "                STAMP(13);\n                continue;\n"),
        ("                __syncthreads();\n                // each (slot, "
         "entry) adds",
         "                STAMP(2);\n                __syncthreads();\n"
         "                STAMP(3);\n                // each (slot, entry) "
         "adds"),
        ("                __syncthreads();\n            }\n"
         "            if (ch0.j < SLOTS)",
         "                STAMP(4);\n                __syncthreads();\n"
         "                STAMP(5);\n            }\n"
         "            if (ch0.j < SLOTS)"),
        ("            cluster.sync();\n            // every block sums",
         "            STAMP(6);\n            cluster.sync();\n"
         "            STAMP(7);\n            // every block sums"),
        ("            __syncthreads();\n            if (tid < NENT) {",
         "            STAMP(8);\n            __syncthreads();\n"
         "            STAMP(9);\n            if (tid < NENT) {"),
        ("            __syncthreads();\n            if (tid == 0) "
         "cholesky_step(S);\n            __syncthreads();\n",
         "            STAMP(10);\n            __syncthreads();\n"
         "            STAMP(11);\n            if (tid == 0) "
         "cholesky_step(S);\n            STAMP(14);\n"
         "            __syncthreads();\n            STAMP(15);\n"),
        ("    // every block's count\n    cluster.sync();\n",
         "    // every block's count\n    cluster.sync();\n"
         "    if (stamp_on_)\n"
         "        for (int q = 0; q < 16; ++q) k18_stamps[q] = ph_[q];\n"),
    ])


def _k18_stamps(tmp, args):
    """This tree's refinement with thread 0 of block 0 stamping its phases
    (clock64 cycles summed over the launch), on one call's inputs."""
    from morb_slam_tpu_torch.pipeline import loop_closing as lc
    d = tempfile.mkdtemp(dir=tmp)
    text = open(os.path.join(cuda_build.CSRC, "sim3_verify.cu")).read()
    lib, ptx = _k18_lib(d, None, _k18_stamped_source(text))
    want = lc.sim3_refine(*args)
    got, c = _stamp_run(lib, "sim3_verify", lambda: lc.sim3_refine(*args),
                        16)
    return dict(bits=_equal_fields(got, want, ("s", "R", "t", "n_good")),
                cycles=dict(zip(K18_PHASES, c)), total_cycles=float(sum(c)),
                ptxas=ptx.strip())


K18_EARLIER_PHASES = ["duals", "wait: the duals",
                      "feature loop (evaluations and sums; reclassification)",
                      "wait: the loop", "partials and the 35 sums (with syncs)",
                      "Cholesky and substitutions (thread 0)",
                      "wait: the solve", "reclassification count"]


def _k18_earlier_stamped_source(text):
    """The earlier sim3_verify.cu (commit 08f7233, one block) with thread 0
    adding the cycles of each phase (K18_EARLIER_PHASES) up over the
    launch, written to a buffer set by set_stamp_buf."""
    st = ("#define STAMP(k) if (stamp_on_) { long long t_ = clock64(); "
          "ph_[k] += t_ - last_; last_ = t_; }\n")
    return _patch(text, [
        ("#include <stdint.h>\n",
         "#include <stdint.h>\n__device__ long long* k18_stamps;\n"
         "extern \"C\" int set_stamp_buf(void* p) {\n"
         "    return (int)cudaMemcpyToSymbol(k18_stamps, &p, sizeof(p));\n}\n"
         + st),
        ("    const int tid = threadIdx.x;\n    uint8_t* act_f = act;\n",
         "    const int tid = threadIdx.x;\n    uint8_t* act_f = act;\n"
         "    const bool stamp_on_ = k18_stamps && tid == 0;\n"
         "    long long ph_[8];\n    for (int q = 0; q < 8; ++q) ph_[q] = 0;\n"
         "    long long last_ = clock64();\n"),
        ("            if (tid < 8) sim3_duals(tid, x, sim, T[tid]);\n"
         "            __syncthreads();\n",
         "            if (tid < 8) sim3_duals(tid, x, sim, T[tid]);\n"
         "            STAMP(0);\n            __syncthreads();\n"
         "            STAMP(1);\n"),
        ("            __syncthreads();   // every T read before the next "
         "step's write\n",
         "            STAMP(2);\n            __syncthreads();   // every T "
         "read before the next step's write\n            STAMP(3);\n"),
        ("                __syncthreads();\n                continue;\n",
         "                __syncthreads();\n                STAMP(7);\n"
         "                continue;\n"),
        ("            if (tid == 0) {\n                // (H + 1e-4 I) dx = g "
         "by Cholesky",
         "            STAMP(4);\n            if (tid == 0) {\n"
         "                // (H + 1e-4 I) dx = g by Cholesky"),
        ("                for (int i = 0; i < 7; ++i) x[i] = x[i] - y[i];\n"
         "            }\n            __syncthreads();\n",
         "                for (int i = 0; i < 7; ++i) x[i] = x[i] - y[i];\n"
         "            }\n            STAMP(5);\n            __syncthreads();\n"
         "            STAMP(6);\n"),
        ("    if (tid == 0) {\n        sim3_duals(7, x, sim, T[0]);",
         "    if (stamp_on_)\n"
         "        for (int q = 0; q < 8; ++q) k18_stamps[q] = ph_[q];\n"
         "    if (tid == 0) {\n        sim3_duals(7, x, sim, T[0]);"),
    ])


K7_TAIL_PHASES = ["first pass (L2 reads, keys, counts, top byte's bins)",
                  "count sum", "three radix passes and scans",
                  "writes (L2 reads, depth, stores)"]


def _k7_stamped_source(text):
    """stereo_sad.cu with thread 0 of the last block adding the cycles of
    each phase of its tail (K7_TAIL_PHASES), written to a buffer set by
    set_stamp_buf."""
    st = ("#define STAMP(k) if (stamp_on_) { long long t_ = clock64(); "
          "ph_[k] += t_ - last_; last_ = t_; }\n")
    return _patch(text, [
        ("#define INF_BITS 0x7f800000u\n",
         "#define INF_BITS 0x7f800000u\n__device__ long long* k7_stamps;\n"
         "extern \"C\" int set_stamp_buf(void* p) {\n"
         "    return (int)cudaMemcpyToSymbol(k7_stamps, &p, sizeof(p));\n}\n"
         + st),
        ("    const int tid = threadIdx.x;\n    // the median",
         "    const int tid = threadIdx.x;\n"
         "    const bool stamp_on_ = k7_stamps && tid == 0;\n"
         "    long long ph_[4] = {0, 0, 0, 0};\n"
         "    long long last_ = clock64();\n    // the median"),
        ("    const unsigned n_m = block_sum(c, s_warp);\n",
         "    STAMP(0);\n    const unsigned n_m = block_sum(c, s_warp);\n"
         "    STAMP(1);\n"),
        ("    const float thr = __fmul_rn(disp_coef, "
         "__uint_as_float(prefix));\n",
         "    STAMP(2);\n    const float thr = __fmul_rn(disp_coef, "
         "__uint_as_float(prefix));\n"),
        ("    if (tid == 0) *ticket = 0u;\n",
         "    STAMP(3);\n    if (stamp_on_)\n"
         "        for (int q = 0; q < 4; ++q) k7_stamps[q] = ph_[q];\n"
         "    if (tid == 0) *ticket = 0u;\n"),
    ])


def _stamp_run(lib, name, call, n):
    """Cycles by phase of one call() through `lib` in place of this tree's
    build of `name` (its stamp buffer set for that call only)."""
    lib.set_stamp_buf.argtypes = [ctypes.c_void_p]
    lib.set_stamp_buf.restype = ctypes.c_int
    buf = torch.zeros(n, dtype=torch.int64, device="cuda")
    old = _swap_lib(name, lib)
    try:
        call()
        cuda_build.check(lib.set_stamp_buf(buf.data_ptr()), "stamps")
        got = call()
        torch.cuda.synchronize()
        cuda_build.check(lib.set_stamp_buf(None), "stamps")
    finally:
        _restore_lib(name, old)
    return got, buf.cpu().numpy().astype(float).tolist()


def _k7_stamps(tmp, args):
    """This tree's K7 with thread 0 of the last block stamping its tail
    (clock64 cycles), on one call's inputs."""
    from morb_slam_tpu_torch.ops import stereo
    d = tempfile.mkdtemp(dir=tmp)
    text = open(os.path.join(cuda_build.CSRC, "stereo_sad.cu")).read()
    lib, _ = _build(d, "stereo_sad", _k7_stamped_source(text))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.stereo_sad.argtypes = [P, P, I, I, P, P, P, P, I, P, Fl, Fl, Fl,
                               I] + [P] * 8
    lib.stereo_sad.restype = I
    want = stereo.refine_and_filter(*args)
    got, c = _stamp_run(lib, "stereo_sad",
                        lambda: stereo.refine_and_filter(*args), 4)
    return dict(bits=_equal_fields(got, want, got._fields),
                cycles=dict(zip(K7_TAIL_PHASES, c)))


def _k18_earlier_stamps(tmp, csrc, args):
    """The earlier refinement (one block) with thread 0 stamping its
    phases (clock64 cycles summed over the launch), on one call's
    inputs."""
    from morb_slam_tpu_torch.pipeline import loop_closing as lc
    d = tempfile.mkdtemp(dir=tmp)
    text = open(os.path.join(csrc, "sim3_verify.cu")).read()
    lib, _ = _k18_lib(d, None, _k18_earlier_stamped_source(text))
    _, c = _stamp_run(lib, "sim3_verify", lambda: lc.sim3_refine(*args), 8)
    return dict(cycles=dict(zip(K18_EARLIER_PHASES, c)),
                total_cycles=float(sum(c)))


class _Compare7_18:
    """Every K7 launch of match_stereo (`stereo.refine_and_filter`) and
    every K18 refinement (`loop_closing.sim3_refine`) on CUDA tensors also
    run through the earlier kernels on the same inputs: calls and
    bitwise-equal calls, the first unequal call's fields, and the last
    call's inputs (K18: every call's) kept for the timings."""

    def __init__(self, lib7, lib18):
        from morb_slam_tpu_torch.ops import stereo
        from morb_slam_tpu_torch.pipeline import loop_closing as lc
        self.stereo, self.lc, self.lib7, self.lib18 = stereo, lc, lib7, lib18
        self.stats, self.last, self.k18_args = {}, {}, []

    def _count(self, mode, eq):
        st = self.stats.setdefault(mode, dict(calls=0, bitwise_equal=0))
        st["calls"] += 1
        ok = all(v is True for v in eq.values())
        st["bitwise_equal"] += int(ok)
        if not ok and "first_unequal" not in st:
            st["first_unequal"] = eq

    def __enter__(self):
        stereo, lc = self.stereo, self.lc
        self.saved = (stereo.refine_and_filter, stereo.match_stereo,
                      lc.sim3_refine)
        k7, ms, k18 = self.saved

        def refine_and_filter(*a):
            got = k7(*a)
            if a[0].is_cuda:
                old = _k7_old(self.lib7, *a)
                self._count("K7 match_stereo tail",
                            _equal_fields(got, old, got._fields))
                self.last["K7"] = a
            return got

        def match_stereo(*a, **kw):
            self.last["match_stereo"] = (a, kw)
            return ms(*a, **kw)

        def sim3_refine(*a):
            got = k18(*a)
            if a[0].is_cuda:
                old = _k18_with(self.lib18, a, k18)
                self._count("K18 sim3_refine", _equal_fields(
                    got, old, ("s", "R", "t", "n_good")))
                self.k18_args.append(_clone_args(a))
            return got
        stereo.refine_and_filter = refine_and_filter
        stereo.match_stereo = match_stereo
        lc.sim3_refine = sim3_refine
        return self

    def __exit__(self, *exc):
        (self.stereo.refine_and_filter, self.stereo.match_stereo,
         self.lc.sim3_refine) = self.saved


def _clone_args(a):
    return tuple(x.clone() if torch.is_tensor(x) else x for x in a)


def _k7_times(lib7, args, match, reps):
    """This tree's K7 launch against the earlier tail (the gather, the
    earlier kernel, filter_matches) on one call's inputs, and both trees'
    whole match_stereo (the row search, then the tail): bits, device ms of
    the K7 kernel and of every kernel, kernels and event ms per call."""
    from morb_slam_tpu_torch.ops import stereo
    new = lambda: stereo.refine_and_filter(*args)    # noqa: E731
    old = lambda: _k7_old(lib7, *args)               # noqa: E731
    got, want = new(), old()
    a, kw = match
    m = dict(zip(("feats_l", "feats_r", "img_l", "img_r", "scale_factors",
                  "bf", "min_z"), a), **kw)
    feats_l, feats_r, img_l, img_r = (m[k] for k in ("feats_l", "feats_r",
                                                     "img_l", "img_r"))
    sf, bf = m["scale_factors"], m["bf"]
    max_d = bf / m["min_z"]

    def match_old():
        best_idx, matched = stereo.row_search(feats_l, feats_r, sf, max_d)
        return _k7_old(lib7, img_l, img_r, feats_l.uv, feats_r.uv, best_idx,
                       matched, bf, max_d)
    match_new = lambda: stereo.match_stereo(*a, **kw)   # noqa: E731
    res = dict(bits=_equal_fields(got, want, got._fields),
               match_stereo_bits=_equal_fields(match_new(), match_old(),
                                               got._fields),
               n=args[2].shape[0], kept=int(got.valid.sum()))
    # earlier, this tree, this tree, earlier
    for tag, fn in (("earlier", old), ("new", new), ("new", new),
                    ("earlier", old)):
        r = res.setdefault(tag, dict(k7_kernel_ms=[], device_ms=[],
                                     call_ms=[]))
        r["k7_kernel_ms"].append(cs.device_ms(fn, "stereo_sad_kernel",
                                              reps=reps))
        r["device_ms"].append(cs.device_ms(fn, None, reps=reps))
        r["call_ms"].append(cs.time_ms(fn))
    for tag, fn in (("earlier", old), ("new", new)):
        res[tag]["kernels_per_call"] = cs.kernels_per_call(fn)
    for tag, fn in (("earlier", match_old), ("new", match_new),
                    ("new", match_new), ("earlier", match_old)):
        r = res[tag].setdefault("match_stereo", dict(device_ms=[],
                                                     call_ms=[]))
        r["device_ms"].append(cs.device_ms(fn, None, reps=reps))
        r["call_ms"].append(cs.time_ms(fn))
    for tag, fn in (("earlier", match_old), ("new", match_new)):
        res[tag]["match_stereo"]["kernels_per_call"] = \
            cs.kernels_per_call(fn)
    return res


def _k18_times(lib18, libs, args, reps):
    """The refinement on one call's inputs: the earlier kernel, this
    tree's and this tree's variants (`libs`: {name: lib}), bits against
    the earlier result and device ms of refine_kernel, in the order
    earlier, this tree, variants, this tree, earlier."""
    from morb_slam_tpu_torch.pipeline import loop_closing as lc
    want = _k18_with(lib18, args)
    res = dict(pairs=int(args[5].sum()), backward=int(args[6].sum()),
               n=args[0].shape[0])
    calls = [("earlier", lambda: _k18_with(lib18, args)),
             ("new", lambda: lc.sim3_refine(*args))] + [
        (k, lambda v=v: _k18_with(v, args)) for k, v in libs.items()]
    for tag, fn in calls + calls[1::-1]:
        r = res.setdefault(tag, dict(refine_ms=[]))
        r["refine_ms"].append(cs.device_ms(fn, "refine_kernel", reps=reps))
        r["bits"] = _equal_fields(fn(), want, ("s", "R", "t", "n_good"))
    return res


def _k7_k18(csrc, reps):
    """This tree's K7 and K18 against the earlier ones (commit 08f7233),
    built beside them: the stereo, vi, loop and vi_loop paths with every
    K7 launch and every K18 refinement also run through the earlier
    kernels (bitwise-equal calls), then both trees' times on the stereo
    path's last K7 call and match_stereo and on every K18 call, with this
    tree's refinement also at 16 blocks a cluster."""
    cuda_build.build(("stereo_sad", "sim3_verify"))
    res = dict(card=cs.nvidia_smi(), sources=csrc,
               ptxas=dict(stereo_sad=cuda_build.ptxas_report(
                   "stereo_sad").strip(), sim3_verify=cuda_build.ptxas_report(
                   "sim3_verify").strip()))
    with tempfile.TemporaryDirectory() as tmp:
        d7, d18, d16 = (os.path.join(tmp, d) for d in ("old7", "old18",
                                                       "new16"))
        for d in (d7, d18, d16):
            os.makedirs(d)
        lib7, ptx7 = _k7_old_lib(d7, csrc)
        lib18, ptx18 = _k18_lib(d18, csrc)
        text = open(os.path.join(cuda_build.CSRC, "sim3_verify.cu")).read()
        lib16, ptx16 = _k18_lib(d16, None, _non_portable(_define(_define(
            text, "CL", 16), "MR", 20)))
        res["ptxas_earlier"] = dict(stereo_sad=ptx7.strip(),
                                    sim3_verify=ptx18.strip())
        res["ptxas_16_blocks"] = ptx16.strip()
        state = {"profile_out": None, "plain_rows": []}
        cs.phase_device(state)
        last, k18_args = {}, []
        for name, phase in (("stereo", cs.phase_stereo),
                            ("vi", cs.phase_vi), ("loop", cs.phase_loop),
                            ("vi_loop", cs.phase_vi_loop)):
            with _Compare7_18(lib7, lib18) as cmp:
                try:
                    phase(state)
                except AssertionError as e:
                    # a gate the path missed: kept in the result (the
                    # comparisons up to it stand), the tool exits non-zero
                    res.setdefault("gates_missed", {})[name] = repr(e)
            res[f"{name} path"] = cmp.stats
            if name == "stereo":
                last = dict(cmp.last)
            k18_args += [(name, a) for a in cmp.k18_args]
            _write(res, "kernel_phases_k7_k18.json")
            torch.cuda.empty_cache()
        if "K7" in last and "match_stereo" in last:
            res["k7_times"] = _k7_times(lib7, last["K7"],
                                        last["match_stereo"], reps)
        _write(res, "kernel_phases_k7_k18.json")
        res["k18_times"] = [dict(path=name, **_k18_times(
            lib18, {"new_16_blocks": lib16}, a, reps))
            for name, a in k18_args]
        _write(res, "kernel_phases_k7_k18.json")
        res["k18_stamps"] = [dict(path=name, **_k18_stamps(tmp, a))
                             for name, a in k18_args[:1] + k18_args[-1:]]
        res["k18_stamps_earlier"] = [
            dict(path=name, **_k18_earlier_stamps(tmp, csrc, a))
            for name, a in k18_args[:1] + k18_args[-1:]]
        if "K7" in last:
            res["k7_stamps"] = _k7_stamps(tmp, last["K7"])
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", help="morb_slam_tpu_torch/csrc of commit "
                    "08f7233 (the earlier K7 and K18; with --k7 --k18)")
    ap.add_argument("--new", action="store_true",
                    help="stamp this tree's kernels (K12 unless --k5, --k1, "
                    "--k3 or --k6 is given)")
    ap.add_argument("--k5", action="store_true", help="stamp K5 instead")
    ap.add_argument("--k1", action="store_true", help="stamp K1 instead")
    ap.add_argument("--k3", action="store_true",
                    help="stamp K3's gated mode instead")
    ap.add_argument("--k6", action="store_true",
                    help="stamp K6's one launch instead")
    ap.add_argument("--k7", action="store_true",
                    help="with --k18 and --csrc: this tree's K7 and K18 "
                    "against the earlier ones on the paths' calls")
    ap.add_argument("--k18", action="store_true",
                    help="with --k7 and --csrc (see --k7)")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if a.new == bool(a.csrc):
        raise SystemExit("give --csrc or --new")
    if a.k7 or a.k18:
        if not (a.k7 and a.k18 and a.csrc) or a.k3 or a.k6 or a.k5 or a.k1:
            raise SystemExit("--k7 --k18 go with --csrc alone")
        res = _k7_k18(a.csrc, a.reps)
        _write(res, "kernel_phases_k7_k18.json")
        bad = {p: st for p, v in res.items() if p.endswith(" path")
               for st in v.values() if st["bitwise_equal"] != st["calls"]}
        if "gates_missed" in res or bad:
            raise SystemExit(f"gates missed: {res.get('gates_missed')}; "
                             f"unequal calls: {bad}")
        return
    if a.csrc:
        raise SystemExit("--csrc goes with --k7 --k18 only")
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
