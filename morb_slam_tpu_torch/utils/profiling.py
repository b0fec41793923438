"""Per-stage timers and the device trace (counterpart of
`morb_slam_tpu/utils/profiling.py`).

`StageTimers.stage(name)` opens a `torch.profiler.record_function` range of
that name, so a profile of the tracker shows the stages (`TrackTotal`,
`LMTotal`, `LoopTotal`, `GBATotal`) whether or not the timers are on; when
they are on it also records the stage's wall milliseconds. With `sync=True`
the stage's end waits for the card (`torch.cuda.synchronize` of the
device given to the stage), so the time is the device's work and not only
the host's dispatch. Disabled timers cost one profiler range per stage.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict
from typing import Optional

import torch
from torch.profiler import record_function

TRACKING_STAGES = ("ORBExtract", "StereoMatch", "IMUInteg", "PosePred",
                   "LMTrack", "NewKF", "TrackTotal")
MAPPING_STAGES = ("KFInsert", "MPCulling", "MPCreation", "LBA", "KFCulling",
                  "LMTotal")
LOOP_STAGES = ("PRTotal", "MergeTotal", "LoopTotal", "GBATotal")


class StageTimers:
    """Named wall-clock stage timers: name -> [ms, ...]."""

    def __init__(self, enabled: bool = False, sync: bool = False):
        self.enabled = enabled
        self.sync = sync
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, device=None):
        """Time a stage; with `sync`, wait for `device` (a CUDA device) at
        its end."""
        with record_function(name):
            if not self.enabled:
                yield
                return
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.sync and device is not None and \
                        torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
                self.samples[name].append((time.perf_counter() - t0) * 1e3)

    def add_ms(self, name: str, ms: float):
        if self.enabled:
            self.samples[name].append(ms)

    def stats(self):
        """{stage: (n, mean_ms, std_ms, min_ms, max_ms)}."""
        out = {}
        for name, v in self.samples.items():
            n = len(v)
            mean = sum(v) / n
            var = sum((x - mean) ** 2 for x in v) / n if n > 1 else 0.0
            out[name] = (n, mean, math.sqrt(var), min(v), max(v))
        return out

    def report(self) -> str:
        lines = [f"{'stage':<14}{'n':>6}{'mean ms':>10}{'std':>8}"
                 f"{'min':>8}{'max':>9}"]
        for name, (n, mean, std, lo, hi) in sorted(self.stats().items()):
            lines.append(f"{name:<14}{n:>6}{mean:>10.3f}{std:>8.3f}"
                         f"{lo:>8.3f}{hi:>9.3f}")
        return "\n".join(lines)

    def save(self, path: str):
        """Write `<stage> <mean ms>` per line (ExecTimeMean.txt)."""
        with open(path, "w") as f:
            for name, (n, mean, _, _, _) in sorted(self.stats().items()):
                f.write(f"{name} {mean:.6f}\n")

    def reset(self):
        self.samples.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """A torch.profiler trace (CPU and, with a card, CUDA activity) of the
    enclosed work, written to `<logdir>/trace.json` for Perfetto or
    chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_global: Optional[StageTimers] = None


def global_timers() -> StageTimers:
    """The process-wide timers, created at first use: disabled unless
    MORB_REGISTER_TIMES is set (to "sync" for synchronized stages)."""
    global _global
    if _global is None:
        val = os.environ.get("MORB_REGISTER_TIMES", "0")
        _global = StageTimers(enabled=val not in ("0", ""),
                              sync=val == "sync")
    return _global
