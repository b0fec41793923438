"""Phase shares of hand-written kernels on the card, stamped with
`clock64()`: K12 (`csrc/pose_inertial.cu`) and K2 (`csrc/orb_describe.cu`)
in their earlier forms (K12 over the 30-dim state, K2 launched per level,
as of commit 4ceff5a) and K12's 15-dim form; K5 (`csrc/pose_opt.cu`) and
K1 (`csrc/fast_select.cu`) in their earlier forms (as of commit ea2e66d:
K5's serial tail on thread 0, K1 launched per level) and in this tree's.

    git archive 4ceff5a morb_slam_tpu_torch/csrc | tar -x -C old/
    python3 tools_kernel_phases.py --csrc old/morb_slam_tpu_torch/csrc
    python3 tools_kernel_phases.py --new
    git archive ea2e66d morb_slam_tpu_torch/csrc | tar -x -C old10/
    python3 tools_kernel_phases.py --k5 --k1 --csrc old10/morb_slam_tpu_torch/csrc
    python3 tools_kernel_phases.py --k5 --k1 --new

Copies the sources (and the headers) into a temporary directory, inserts
the stamps, builds them with the port's `nvcc` flags and runs them at
`chip_smoke.py`'s shapes. K12 at the tracking shape (1,200 observations,
60% stereo, 2 x 6 + final): the earlier K12's thread 0 adds the cycles
since its last stamp to one of 16 phase counters at each barrier or phase
end; `--new`: thread 0 (the solver warp's lane 0) and thread 32 (the
first visual thread) each keep their own counters. K2 on the 8 levels of
the first rendered frame: lane 0 of every warp records the cycles of the
orientation and of the descriptor. `--k5`: K5 at the tracking (1,200
observations, 60% stereo, 2 x 8) and relocalization (mono, 3 x 10)
shapes; the earlier kernel's thread 0 stamps, this tree's thread 0 (the
solver warp) and thread 32 (a row warp), at 512 and 256 threads a block.
`--k1`: K1 on the 8 levels of a 752x480 frame; the earlier per-level
launches with thread 0 of every block stamping its phases, each launch's
device time and the whole earlier selection (8 launches + torch's sort,
gathers and slots: kernels and device ms an image); this tree's cell
stage and level stage, stamped by block. Prints one JSON object (also
written to chiprun_out/kernel_phases.json, kernel_phases_new.json or
kernel_phases_k5_k1[_new].json). The stamp anchors match those sources
only. Needs a CUDA card and nvcc.
"""
import argparse
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from morb_slam_tpu_torch import frontend, imu
from morb_slam_tpu_torch.ops import cuda_build, fast, image, orb_descriptor
from morb_slam_tpu_torch.optim import vi_ba

K12_PHASES = ["setup", "visual", "edge_jac", "edge_wait", "JtW", "H_g",
              "t0_sum_rw", "mask", "symm", "scale", "chol", "subst_update",
              "final_bar", "reclass", "final_step_tail", "outputs"]


def _patch(text, pairs):
    for a, b in pairs:
        if text.count(a) != 1:
            raise SystemExit(f"stamp anchor not found once: {a[:60]!r}")
        text = text.replace(a, b)
    return text


def _k12_source(text):
    bar = "        __syncthreads();\n"
    return _patch(text, [
        ("                     long long* __restrict__ n_inliers) {",
         "                     long long* __restrict__ n_inliers,\n"
         "                     long long* __restrict__ phase_out) {\n"
         "    long long ph[16];\n"
         "    for (int q = 0; q < 16; ++q) ph[q] = 0;\n"
         "    long long last = clock64();\n"
         "#define STAMP(k) if (threadIdx.x == 0) { long long t_ = clock64();"
         " ph[k] += t_ - last; last = t_; }"),
        ("        if (reclass) {\n            for (int i = tid;",
         "        STAMP(0)\n        if (reclass) {\n"
         "            for (int i = tid;"),
        ("            __syncthreads();\n            continue;",
         "            __syncthreads();\n            STAMP(13)\n"
         "            continue;"),
        ("            if (lane == 0) red[warp][k] = v;\n        }",
         "            if (lane == 0) red[warp][k] = v;\n        }\n"
         "        STAMP(1)"),
        ("                for (int a = 0; a < 9; ++a) re[a] = r[a].v;\n"
         "        }\n" + bar,
         "                for (int a = 0; a < 9; ++a) re[a] = r[a].v;\n"
         "        }\n        STAMP(2)\n" + bar + "        STAMP(3)\n"),
        ("            JtW[b][i] = s;\n        }\n" + bar,
         "            JtW[b][i] = s;\n        }\n" + bar + "        STAMP(4)\n"),
        ("            g[tid] = -s;\n        }\n" + bar,
         "            g[tid] = -s;\n        }\n" + bar + "        STAMP(5)\n"),
        ("                g[24 + q] += -rw * rr;\n            }\n        }\n"
         + bar,
         "                g[24 + q] += -rw * rr;\n            }\n        }\n"
         + bar + "        STAMP(6)\n"),
        ("        if (tid < 15) g[tid] = 0.0f;\n" + bar,
         "        if (tid < 15) g[tid] = 0.0f;\n" + bar + "        STAMP(7)\n"),
        ("H[q / 30][q % 30] = Lm[q / 30][q % 30];\n" + bar,
         "H[q / 30][q % 30] = Lm[q / 30][q % 30];\n" + bar
         + "        STAMP(8)\n"),
        ("(i == j ? 1e-6f : 0.0f);\n        }\n" + bar,
         "(i == j ? 1e-6f : 0.0f);\n        }\n" + bar + "        STAMP(9)\n"),
        ("                __syncwarp();\n            }\n"
         "            if (lane == 0) {\n                float y[30];",
         "                __syncwarp();\n            }\n            STAMP(10)\n"
         "            if (lane == 0) {\n                float y[30];"),
        ("                update_state(S + 21, dx + 15);\n            }\n"
         "        }\n" + bar + "    }",
         "                update_state(S + 21, dx + 15);\n            }\n"
         "            STAMP(11)\n        }\n" + bar + "        STAMP(12)\n"
         "    }\n    STAMP(14)"),
        ("out[21 + q] = H[q / 30][q % 30];\n}",
         "out[21 + q] = H[q / 30][q % 30];\n    STAMP(15)\n"
         "    if (tid == 0) for (int q = 0; q < 16; ++q) "
         "phase_out[q] = ph[q];\n}"),
        ("void* inliers, void* n_inliers, void* stream) {",
         "void* inliers, void* n_inliers, void* stream,\n"
         "                             void* phase) {"),
        ("        (long long*)n_inliers);",
         "        (long long*)n_inliers, (long long*)phase);"),
    ])


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


def _k2_source(text):
    return _patch(text, [
        ("float* __restrict__ angle_out, int* __restrict__ desc_out) {",
         "float* __restrict__ angle_out, int* __restrict__ desc_out,\n"
         "                    long long* __restrict__ ph) {\n"
         "    const long long t0 = clock64();"),
        ("    sincosf(ang, &sa, &ca);\n",
         "    sincosf(ang, &sa, &ca);\n    const long long t1 = clock64();\n"),
        ("    if (lane == 0) angle_out[k] = ang;\n}",
         "    if (lane == 0) angle_out[k] = ang;\n"
         "    if (lane == 0) { const long long t2 = clock64();\n"
         "        ph[2 * k] = t1 - t0; ph[2 * k + 1] = t2 - t1; }\n}"),
        ("const int* yx, int n, float* angle, int* desc,\n"
         "                            void* stream) {",
         "const int* yx, int n, float* angle, int* desc,\n"
         "                            void* stream, void* ph) {"),
        ("img, blur, H, W, yx, n, angle, desc);",
         "img, blur, H, W, yx, n, angle, desc, (long long*)ph);"),
    ])


def _define(text, name, value):
    """`text` with its `#define name ...` set to `value`."""
    out, n = re.subn(rf"^#define {name} \d+", f"#define {name} {value}",
                     text, flags=re.M)
    if n != 1:
        raise SystemExit(f"#define {name} not found once")
    return out


def _build(src_dir, name, text):
    path = os.path.join(src_dir, name + ".cu")
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(src_dir, name + ".so")
    r = subprocess.run([cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o", so,
                        path], capture_output=True, text=True)
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


K5_PHASES = {
    0: "row pass (thread 0's rows)",
    1: "warp butterflies (27 x 5 shuffles)",
    2: "barrier 1 wait",
    3: "thread 0: cross-warp sum, H and g",
    4: "thread 0: solve6",
    5: "thread 0: apply_update",
    6: "barrier 2",
    7: "reclassify pass",
    8: "reclassify barrier",
    9: "outputs",
    10: "set-up",
}


def _k5_source(text):
    """The earlier K5 (one 512-thread block, thread 0's serial tail):
    thread 0 adds the cycles since its last stamp to a phase counter."""
    st = ("#define STAMP(k) if (threadIdx.x == 0) { long long t_ = clock64(); "
          "ph[k] += t_ - last; last = t_; }\n")
    return _patch(text, [
        ("long long* __restrict__ n_inliers) {",
         "long long* __restrict__ n_inliers,\n"
         "                long long* __restrict__ phase_out) {\n"
         "    long long ph[16];\n"
         "    for (int q = 0; q < 16; ++q) ph[q] = 0;\n"
         "    long long last = clock64();\n" + st),
        ("inliers[i] = valid[i] ? 1 : 0;\n    __syncthreads();\n",
         "inliers[i] = valid[i] ? 1 : 0;\n    __syncthreads();\n"
         "    STAMP(10)\n"),
        ("                            -(e.x - baseline) * iz2, e.x, e.y, e.z);\n"
         "            }\n",
         "                            -(e.x - baseline) * iz2, e.x, e.y, e.z);\n"
         "            }\n            STAMP(0)\n"),
        ("                if (lane == 0) red[warp][k] = v;\n            }\n"
         "            __syncthreads();\n",
         "                if (lane == 0) red[warp][k] = v;\n            }\n"
         "            STAMP(1)\n            __syncthreads();\n"
         "            STAMP(2)\n"),
        ("                solve6(Hs, g, dx);\n                Pose P2 = sP;\n"
         "                apply_update(P2, dx);\n                sP = P2;\n"
         "            }\n            __syncthreads();\n",
         "                STAMP(3)\n                solve6(Hs, g, dx);\n"
         "                STAMP(4)\n                Pose P2 = sP;\n"
         "                apply_update(P2, dx);\n                sP = P2;\n"
         "                STAMP(5)\n"
         "            }\n            __syncthreads();\n            STAMP(6)\n"),
        ("        if (round == n_rounds) {\n#pragma unroll",
         "        STAMP(7)\n        if (round == n_rounds) {\n#pragma unroll"),
        ("            if (lane == 0) cnt[warp] = n;\n        }\n"
         "        __syncthreads();\n    }\n",
         "            if (lane == 0) cnt[warp] = n;\n        }\n"
         "        __syncthreads();\n        STAMP(8)\n    }\n"),
        ("    if (tid < 3) t_out[tid] = sP.t[tid];\n}",
         "    if (tid < 3) t_out[tid] = sP.t[tid];\n    STAMP(9)\n"
         "    if (tid == 0) for (int q = 0; q < 16; ++q) "
         "phase_out[q] = ph[q];\n}"),
        ("void* inliers, void* chi2, void* n_inliers,\n"
         "                        void* stream) {",
         "void* inliers, void* chi2, void* n_inliers,\n"
         "                        void* stream, void* phase) {"),
        ("        (long long*)n_inliers);",
         "        (long long*)n_inliers, (long long*)phase);"),
    ])


K1_PHASES = ["tile load", "scores", "NMS and key", "top-2 reduction 1",
             "top-2 reduction 2", "slot writes"]


def _k1_source(text):
    """The earlier K1 (one launch a level, a block a cell): thread 0 of
    every block records the cycles of each phase."""
    st = ("#define STAMP(k) if (threadIdx.x == 0) { long long t_ = clock64(); "
          "ph[k] = t_ - last; last = t_; }\n")
    return _patch(text, [
        ("float* __restrict__ score_out) {",
         "float* __restrict__ score_out,\n"
         "                   long long* __restrict__ ph_out) {\n"
         "    long long ph[6];\n    long long last = clock64();\n" + st),
        ("        tile[ty][tx] = img[(size_t)gy * W + gx];\n    }\n"
         "    __syncthreads();\n",
         "        tile[ty][tx] = img[(size_t)gy * W + gx];\n    }\n"
         "    __syncthreads();\n    STAMP(0)\n"),
        ("        sc[sy][sx] = fmaxf(bright, dark);\n    }\n"
         "    __syncthreads();\n",
         "        sc[sy][sx] = fmaxf(bright, dark);\n    }\n"
         "    __syncthreads();\n    STAMP(1)\n"),
        ("(s > th_hi ? boost : 0.0f) : -INFINITY;\n",
         "(s > th_hi ? boost : 0.0f) : -INFINITY;\n    STAMP(2)\n"),
        ("    const unsigned int c1 = 0xFFFFu - (unsigned int)(b1 & 0xFFFFull);\n",
         "    const unsigned int c1 = 0xFFFFu - (unsigned int)(b1 & 0xFFFFull);\n"
         "    STAMP(3)\n"),
        ("    const unsigned int c2 = 0xFFFFu - (unsigned int)(b2 & 0xFFFFull);\n",
         "    const unsigned int c2 = 0xFFFFu - (unsigned int)(b2 & 0xFFFFull);\n"
         "    STAMP(4)\n"),
        ("(y < H && x < W) ? s : 0.0f;\n    }\n}",
         "(y < H && x < W) ? s : 0.0f;\n    }\n    STAMP(5)\n"
         "    if (threadIdx.x == 0) for (int q = 0; q < 6; ++q)\n"
         "        ph_out[(size_t)cell * 6 + q] = ph[q];\n}"),
        ("int* idx, float* score, void* stream) {",
         "int* idx, float* score, void* stream, void* ph) {"),
        ("img, H, W, th_lo, th_hi, boost, border, key, idx, score);",
         "img, H, W, th_lo, th_hi, boost, border, key, idx, score,\n"
         "        (long long*)ph);"),
    ])


def _k5_problems():
    """chip_smoke.py's two K5 shapes (the same construction)."""
    for name, share, rounds, iters, seed in (("tracking", 0.6, 2, 8, 1),
                                             ("relocalization", 0.0, 3, 10,
                                              2)):
        args, kw = cs._pose_problem(1200, share, seed)
        kw.update(n_rounds=rounds, n_iters=iters)
        yield name, args, kw


def _k5(csrc, new, reps, threads=None):
    """K5 stamped at the tracking and relocalization shapes: cycles a call
    and a Gauss-Newton step of each phase (`threads`: this tree's kernel
    built at another block size)."""
    from morb_slam_tpu_torch.optim import pose_opt
    phases = K5_NEW_PHASES if new else K5_PHASES
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        text = open(os.path.join(csrc, "pose_opt.cu")).read()
        if threads:
            text = _define(text, "THREADS", threads)
        lib, ptx = _build(tmp, "pose_opt", (_k5_new_source if new
                                            else _k5_source)(text))
        lib.pose_opt.argtypes = [P, P, P, P, I, P, P, P, ctypes.c_float, I,
                                 I, I, P, P, P, P, P, P, P]
        lib.pose_opt.restype = I
        plain_lib = None
        if new:     # the same source unstamped, for its own device time
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
                device_ms_unstamped=None if plain_lib is None else cs.device_ms(
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


def _old_selection(levels, cfg, k1_level):
    """The earlier per-level selection: one K1 launch a level, then torch's
    stable sort, gathers and the Features slots of frontend.py (ea2e66d)."""
    out = []
    for l, (lvl, n_keep) in enumerate(zip(levels, cfg.per_level_counts())):
        w = lvl.shape[1]
        key, idx, score = k1_level(lvl)
        vals, order = torch.sort(key.reshape(-1), descending=True,
                                 stable=True)
        top_vals, top_i = vals[:n_keep], order[:n_keep]
        pix = idx.reshape(-1)[top_i]
        valid = top_vals > -math.inf
        yx = torch.stack([pix // w, pix % w], dim=-1).to(torch.int32)
        yx = torch.where(valid[:, None], yx, torch.zeros_like(yx))
        s = cfg.scale ** l
        out.append((yx, top_vals, score.reshape(-1)[top_i], valid,
                    torch.stack([yx[:, 1].to(torch.float32) * s,
                                 yx[:, 0].to(torch.float32) * s], dim=-1),
                    torch.full((n_keep,), l, dtype=torch.int32,
                               device=lvl.device),
                    torch.full((n_keep,), 31.0 * s, dtype=torch.float32,
                               device=lvl.device)))
    return [torch.cat(f) for f in zip(*out)]


def _k1_old(csrc):
    """The earlier K1, stamped, on the 8 levels of a 752x480 frame: each
    launch's device time and per-block phase cycles, and the whole earlier
    selection (8 launches + torch's per-level sort and slots)."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream().cuda_stream
    levels, cfg = _frame_levels()
    levels = [l.contiguous() for l in levels]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        text = open(os.path.join(csrc, "fast_select.cu")).read()
        lib, ptx = _build(tmp, "fast_select", _k1_source(text))
        lib.fast_select.argtypes = [P, I, I, Fl, Fl, Fl, I, P, P, P, P, P]
        lib.fast_select.restype = I
        rows, bufs = [], {}

        def k1_level(lvl):
            h, w = lvl.shape
            nc = (-(-h // 16)) * (-(-w // 16))
            if (h, w) not in bufs:
                bufs[(h, w)] = (
                    torch.empty((nc, 2), device="cuda"),
                    torch.empty((nc, 2), dtype=torch.int32, device="cuda"),
                    torch.empty((nc, 2), device="cuda"),
                    torch.zeros(nc * 6, dtype=torch.int64, device="cuda"))
            key, idx, sc, ph = bufs[(h, w)]
            cuda_build.check(lib.fast_select(
                lvl.data_ptr(), h, w, cfg.th_fast_lo, cfg.th_fast_hi, 1e4,
                16, key.data_ptr(), idx.data_ptr(), sc.data_ptr(), stream,
                ph.data_ptr()), "fast_select (stamped)")
            return key, idx, sc
        for lvl in levels:
            k1_level(lvl)
            torch.cuda.synchronize()
            h, w = lvl.shape
            c = bufs[(h, w)][3].view(-1, 6).cpu().numpy().astype(float)
            rows.append(dict(
                shape=[h, w], blocks=int(c.shape[0]),
                cycles=dict(zip(K1_PHASES, c.mean(0).tolist())),
                block_cycles_mean=float(c.sum(1).mean()),
                device_ms=cs.device_ms(lambda lvl=lvl: k1_level(lvl),
                                       "fast_select_kernel")))
        res["levels"] = rows
        every = np.array([[r["cycles"][p] * r["blocks"] for p in K1_PHASES]
                          for r in rows]).sum(0)
        res["share_over_blocks"] = dict(zip(K1_PHASES,
                                            (every / every.sum()).tolist()))
        res["launches_8_device_ms"] = cs.device_ms(
            lambda: [k1_level(l) for l in levels], "fast_select_kernel")
        sel = lambda: _old_selection(levels, cfg, k1_level)
        res["selection_device_ms"] = cs.device_ms(sel, None)
        res["selection_kernels_per_image"] = cs.kernels_per_call(sel)
        res["selection_call_ms"] = cs.time_ms(sel)
        res["ptxas"] = ptx.strip()
    return res



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



def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", help="morb_slam_tpu_torch/csrc of commit "
                    "4ceff5a (the earlier K12 and K2)")
    ap.add_argument("--new", action="store_true",
                    help="stamp this tree's K12 (the 15-dim kernel)")
    ap.add_argument("--k5", action="store_true",
                    help="stamp K5 instead (with --csrc: the sources of "
                    "commit ea2e66d; with --new: this tree's)")
    ap.add_argument("--k1", action="store_true",
                    help="stamp K1 instead (as --k5)")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if a.new == bool(a.csrc):
        raise SystemExit("give --csrc or --new")
    if a.k5 or a.k1:
        csrc = cuda_build.CSRC if a.new else a.csrc
        res = dict(card=cs.nvidia_smi(), sources="this tree" if a.new
                   else csrc)
        if a.k5:
            res["k5"] = _k5(csrc, a.new, a.reps)
            if a.new:   # the other block size the source allows
                res["k5_512_threads"] = _k5(csrc, True, a.reps, 512)
        if a.k1:
            res["k1"] = _k1_new() if a.new else _k1_old(csrc)
        return _write(res, "kernel_phases_k5_k1%s.json"
                      % ("_new" if a.new else ""))
    if a.new:
        return _new_k12(a.reps)
    res = dict(card=cs.nvidia_smi())
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        for h in ("imu_edge.cuh", "dual.cuh"):
            shutil.copy(os.path.join(a.csrc, h), tmp)
        read = lambda n: open(os.path.join(a.csrc, n + ".cu")).read()
        lib, ptx = _build(tmp, "pose_inertial",
                          _k12_source(read("pose_inertial")))
        lib.pose_inertial.argtypes = [P, P, P, P, P, P, I, I, P, P, P, P, P]
        lib.pose_inertial.restype = I
        lib2, _ = _build(tmp, "orb_describe", _k2_source(read("orb_describe")))
        lib2.orb_describe.argtypes = [P, P, I, I, P, I, P, P, P, P]
        lib2.orb_describe.restype = I
        lib2.orb_set_pattern.argtypes = [P]

        # K12: the wrapper's packing of the constants, one launch a call
        k = _k12_args()
        small = (k[0], k[1], k[2], k[3], k[10], k[11], k[12], k[13],
                 *k[14:26], k[9])
        const = torch.cat([x.reshape(-1) for x in small])
        Xw, obs, info, valid, ur = (t.contiguous() for t in k[4:9])
        n = Xw.shape[0]
        out = torch.empty(921, device="cuda")
        inl = torch.empty(n, dtype=torch.bool, device="cuda")
        n_inl = torch.empty((), dtype=torch.int64, device="cuda")
        ph = torch.zeros(16, dtype=torch.int64, device="cuda")

        def k12():
            rc = lib.pose_inertial(
                const.data_ptr(), Xw.data_ptr(), obs.data_ptr(),
                info.data_ptr(), valid.data_ptr(), ur.data_ptr(), n, 6,
                out.data_ptr(), inl.data_ptr(), n_inl.data_ptr(), stream,
                ph.data_ptr())
            cuda_build.check(rc, "pose_inertial (stamped)")
        for _ in range(3):
            k12()
        cyc = np.zeros(16)
        for _ in range(a.reps):
            k12()
            cyc += ph.cpu().numpy()
        cyc /= a.reps
        res["k12"] = dict(
            cycles=dict(zip(K12_PHASES, cyc.tolist())),
            share=dict(zip(K12_PHASES, (cyc / cyc.sum()).tolist())),
            total_cycles=float(cyc.sum()),
            device_ms_stamped=cs.device_ms(k12, "pose_inertial_kernel"),
            ptxas=ptx.strip())

        # K2: each level of the first rendered frame, one launch a level
        pat = np.ascontiguousarray(orb_descriptor.PATTERN, np.int32)
        cuda_build.check(lib2.orb_set_pattern(pat.ctypes.data), "pattern")
        world, poses = cs._world({})
        cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
        frame = world.render(*poses[0]).clamp(0, 255).to(torch.uint8).float()
        levels = image.build_pyramid(frame, 8, 1.2)
        blurred = image.blur_levels(levels)
        rows, calls = [], []
        counts = cfg.per_level_counts()
        kp = fast.fast_select_levels(levels, counts, cfg)
        for lvl, bl, yx in zip(levels, blurred, kp.level_yx()):
            nk = yx.shape[0]
            ang = torch.empty(nk, device="cuda")
            desc = torch.empty((nk, 8), dtype=torch.int32, device="cuda")
            p2 = torch.zeros(2 * nk, dtype=torch.int64, device="cuda")
            h, w = lvl.shape

            def call(lvl=lvl, bl=bl, yx=yx, nk=nk, ang=ang, desc=desc,
                     p2=p2, h=h, w=w):
                cuda_build.check(lib2.orb_describe(
                    lvl.data_ptr(), bl.data_ptr(), h, w, yx.data_ptr(), nk,
                    ang.data_ptr(), desc.data_ptr(), stream, p2.data_ptr()),
                    "orb_describe (stamped)")
            call()
            torch.cuda.synchronize()
            c = p2.view(nk, 2).cpu().numpy()
            rows.append(dict(shape=[h, w], keypoints=nk,
                             blocks=-(-nk // 8),
                             orientation_cycles=float(c[:, 0].mean()),
                             descriptor_cycles=float(c[:, 1].mean()),
                             device_ms=cs.device_ms(call,
                                                    "orb_describe_kernel")))
            calls.append(call)
        res["k2_levels"] = rows
        res["k2_8_launches_ms"] = cs.device_ms(
            lambda: [c() for c in calls], "orb_describe_kernel")
    _write(res, "kernel_phases.json")


if __name__ == "__main__":
    main()
