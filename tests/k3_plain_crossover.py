"""Where K3's two plain forms cross on the CPU (`ops/hamming.py`
`_sparse_top2`, from the masked-in pairs alone, and `_masked_top2`, the
dense composition), and which calls of the pipeline fall on each side of
`_pair_top2`'s threshold (a 16th of the matrix). One CPU thread:

    python tests/k3_plain_crossover.py [--scenario]

Without arguments: both forms timed (the best of 5) on seeded random
descriptors and masks at 500 x 500 (the tests' feature count) and
1200 x 1200 (the card's), at pair densities from 1/256 to an all-true
mask, each pair of results checked equal. With --scenario, also every
`_pair_top2` call of a few port test modules (their searches,
initialization, relocalization, loop and merge checks): both forms run
and timed on the call's own inputs, the results checked equal, and a
summary by calling function and side printed.
"""
import collections
import os
import sys
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from morb_slam_tpu_torch.ops import hamming  # noqa: E402

SCENARIO = ["test_torch_faults.py::test_keyframe_slot_recycling",
            "test_torch_relocalization.py", "test_torch_loop_e2e.py",
            "test_torch_stereo.py", "test_torch_tracking_e2e.py"]


def _best(f, reps=5):
    out, t = None, float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f()
        t = min(t, time.perf_counter() - t0)
    return out, t


def _both(a, b, i, j, mask, reps=5):
    s, ts = _best(lambda: hamming._sparse_top2(a, b, i, j), reps)
    d, td = _best(lambda: hamming._masked_top2(a, b, mask), reps)
    assert all(torch.equal(x, y) for x, y in zip(s, d))
    return ts, td


def synthetic():
    rng = np.random.default_rng(0)
    print("n x m, density, sparse ms, dense ms")
    for n in (500, 1200):
        a = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, 8))
                             .astype(np.int32))
        b = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, 8))
                             .astype(np.int32))
        for den in (1 / 256, 1 / 64, 1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2,
                    1.0):
            mask = torch.from_numpy(rng.random((n, n)) < den)
            i, j = torch.nonzero(mask, as_tuple=True)
            ts, td = _both(a, b, i, j, mask)
            print(f"{n} x {n}, {den:.4f}, {1e3 * ts:.3f}, {1e3 * td:.3f}")


def scenario():
    import pytest
    calls = []
    pair_top2 = hamming._pair_top2

    def probe(a, b, i, j, mask=None):
        n, m = a.shape[0], b.shape[0]
        if m > 0:
            full = mask
            if full is None:
                full = torch.zeros((n, m), dtype=torch.bool)
                full[i, j] = True
            ts, td = _both(a, b, i, j, full, reps=1)
            names = [f.name for f in traceback.extract_stack(limit=6)[:-1]]
            caller = next((x for x in reversed(names) if x not in (
                "hamming_top2_plain", "hamming_top2", "match_nn",
                "hamming_top2_gated_plain", "hamming_top2_gated")), "?")
            calls.append((caller, i.numel() / (n * m), ts, td))
        return pair_top2(a, b, i, j, mask)
    hamming._pair_top2 = probe
    rc = pytest.main(["-q", "-p", "no:cacheprovider"]
                     + [os.path.join(HERE, t) for t in SCENARIO])
    hamming._pair_top2 = pair_top2
    assert rc == 0, rc
    by = collections.defaultdict(list)
    for caller, den, ts, td in calls:
        by[(caller, "sparse" if 16 * den <= 1 else "dense")].append(
            (den, ts, td))
    print(f"{len(calls)} calls, both forms equal on each")
    print("caller, side, calls, density min-max, sparse ms, dense ms (mean)")
    for (caller, side), v in sorted(by.items()):
        d = [x[0] for x in v]
        print(f"{caller}, {side}, {len(v)}, {min(d):.4f}-{max(d):.4f}, "
              f"{1e3 * np.mean([x[1] for x in v]):.3f}, "
              f"{1e3 * np.mean([x[2] for x in v]):.3f}")


def main():
    torch.set_num_threads(1)
    synthetic()
    if "--scenario" in sys.argv[1:]:
        scenario()


if __name__ == "__main__":
    main()
