"""K11's packed layout on the CPU: `imu.packed_buffer` finds the one
(PACK,) tensor a previous result's fields are views of (what the K11
wrapper passes to the kernel as `init` instead of packing it anew), equal
to `pack` of it, and refuses fields that are copies, swapped, reshaped or
views of another buffer."""
import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import imu


def _packed():
    rng = np.random.default_rng(0)
    return torch.tensor(rng.normal(0, 1, imu.PACK), dtype=torch.float32)


def test_packed_buffer_of_unpack_is_the_buffer():
    buf = _packed()
    p = imu.unpack(buf)
    assert imu.packed_buffer(p) is buf
    assert torch.equal(imu.pack(p), buf)
    # a continued preintegration's plain result is a fresh NamedTuple of
    # tensors, not views: it is packed
    assert imu.packed_buffer(imu.Preintegrated(*(t.clone() for t in p))) \
        is None


@pytest.mark.parametrize("case", ["copy", "swapped", "reshaped", "inside"])
def test_packed_buffer_refuses_other_layouts(case):
    buf = _packed()
    p = imu.unpack(buf)
    if case == "copy":
        q = p._replace(dV=p.dV.clone())
    elif case == "swapped":
        q = p._replace(dV=p.dP, dP=p.dV)
    elif case == "reshaped":
        q = p._replace(dR=p.dR.reshape(9))
    else:               # views of a larger buffer than one Preintegrated
        big = torch.cat([torch.zeros(4), buf])
        q = imu.unpack(big[4:])
    assert imu.packed_buffer(q) is None
    # the wrapper packs these anew
    assert imu.pack(q).shape == (imu.PACK,)
