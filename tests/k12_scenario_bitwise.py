"""Hold K12's plain version bit for bit against its jacfwd form on every
call of tests/test_torch_faults.py's stereo-inertial recycling scenario
(200 frames; the scenario's own gates run as in the test), and time both
forms on those calls, on one CPU thread:

    python tests/k12_scenario_bitwise.py [--write]

--write stores the scenario's plain K12 calls 1, 80 and 158 as
tests/data/k12_recycling_calls.npz (the inputs of
tests/test_torch_pose_inertial_anchor.py's recorded cases).
"""
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import k12_reference  # noqa: E402
import test_torch_faults  # noqa: E402
from morb_slam_tpu_torch.optim import vi_ba  # noqa: E402


def main():
    torch.set_num_threads(1)
    port = vi_ba.optimize_pose_inertial_plain
    calls, equal, secs = [], 0, [0.0, 0.0]

    def both(*args, **kw):
        t0 = time.perf_counter()
        got = port(*args, **kw)
        t1 = time.perf_counter()
        want = k12_reference.optimize_pose_inertial_jacfwd(*args, **kw)
        t2 = time.perf_counter()
        secs[0] += t1 - t0
        secs[1] += t2 - t1
        nonlocal equal
        equal += all(a.dtype == b.dtype and torch.equal(a, b)
                     for a, b in zip(got, want))
        calls.append([x.clone() if torch.is_tensor(x) else x for x in args])
        return got
    vi_ba.optimize_pose_inertial_plain = both
    t0 = time.perf_counter()
    test_torch_faults.test_keyframe_slot_recycling_inertial()
    print(f"scenario (both forms run) {time.perf_counter() - t0:.1f} s; the "
          f"scenario's gates passed")
    print(f"plain K12 calls: {len(calls)}, bitwise equal to the jacfwd "
          f"form: {equal}; summed seconds: dual.jvp form "
          f"{secs[0]:.2f}, jacfwd form {secs[1]:.2f}")
    if "--write" in sys.argv:
        names = k12_reference.optimize_pose_inertial_jacfwd.__code__ \
            .co_varnames[:26]
        out = {f"c{j}_{n}": x.numpy() for j, i in enumerate((0, 79, 157))
               for n, x in zip(names, calls[i])}
        np.savez_compressed(os.path.join(HERE, "data",
                                         "k12_recycling_calls.npz"), **out)
    sys.exit(0 if equal == len(calls) else 1)


if __name__ == "__main__":
    main()
