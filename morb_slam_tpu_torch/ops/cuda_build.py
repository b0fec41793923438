"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `.cu` file compiles with `nvcc` into its own shared library with a plain
C interface, loaded with `ctypes`. Builds run at first use, all sources in
parallel, into `morb_slam_tpu_torch/_build/` (listed in `.gitignore`), keyed
by a hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so
an unchanged source is not rebuilt.
Nothing here runs at import time: this module imports on a machine without
`nvcc` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
SOURCES = ("fast_select", "orb_describe", "hamming_top2", "stereo_sad",
           "remap_bilinear", "pose_opt", "vocab_transform", "bow_l1",
           "ba_assemble", "preintegrate", "pose_inertial", "schur_pcg",
           "vi_edges", "pose_graph")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for fn in [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                      if f.endswith(".cuh")):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    h = h.hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{h[:16]}.so")


def build(names=SOURCES) -> float:
    """Compile every source in `names` that has no up-to-date library, one
    `nvcc` per source, all started together. Returns the wall seconds spent.
    The compiler's resource report (`-Xptxas -v`) goes to `<lib>.log`."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = []
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(out + ".log", "w")
        cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        logs = "\n".join(open(_target(n) + ".log").read() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` lines of the last build of `name` (registers, shared
    memory, spills)."""
    path = _target(name) + ".log"
    if not os.path.exists(path):
        return ""
    return "".join(line for line in open(path)
                   if "registers" in line or "spill" in line)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(_target(name))
        _libs[name] = lib
    return lib


def check(rc: int, name: str):
    """Raise if a C entry reported a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
