"""Phase shares of K12 (`csrc/pose_inertial.cu`) and K2
(`csrc/orb_describe.cu`) on the card: where the time went in their
earlier forms (K12 over the 30-dim state, K2 launched per level, as of
commit 4ceff5a) and in K12's 15-dim form.

    git archive 4ceff5a morb_slam_tpu_torch/csrc | tar -x -C old/
    python3 tools_kernel_phases.py --csrc old/morb_slam_tpu_torch/csrc
    python3 tools_kernel_phases.py --new

Copies the sources (and the headers) into a temporary directory, inserts
`clock64()` stamps, builds them with the port's `nvcc` flags and runs
K12 at the tracking shape of `chip_smoke.py` (1,200 observations, 60%
stereo, 2 x 6 + final). The earlier K12: thread 0 adds the cycles since
its last stamp to one of 16 phase counters at each barrier or phase end;
the earlier K2 (on the 8 levels of the first rendered frame): lane 0 of
every warp records the cycles of the orientation and of the descriptor.
`--new` stamps this tree's K12 instead: thread 0 (the solver warp's
lane 0) and thread 32 (the first visual thread) each keep their own
counters. Prints one JSON object (also written to
chiprun_out/kernel_phases.json, or kernel_phases_new.json). The stamp
anchors match those sources only. Needs a CUDA card and nvcc.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from morb_slam_tpu_torch import frontend, imu
from morb_slam_tpu_torch.ops import cuda_build, image, orb_descriptor
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", help="morb_slam_tpu_torch/csrc of commit "
                    "4ceff5a (the earlier K12 and K2)")
    ap.add_argument("--new", action="store_true",
                    help="stamp this tree's K12 (the 15-dim kernel)")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if a.new == bool(a.csrc):
        raise SystemExit("give --csrc or --new")
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
        for lvl, bl, nk in zip(levels, blurred, cfg.per_level_counts()):
            yx = frontend.select_level_keypoints(lvl, nk, cfg)[0].contiguous()
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
