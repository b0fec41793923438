"""Atlas files across the packages: an Atlas saved by the PyTorch port
loads into the JAX package's `System.load_atlas`, which then relocalizes on
the lifecycle test's revisit frames (tests/test_system.py:24); the Atlas
that JAX session saves loads back into the port, field-equal to the port's
own map, and the port relocalizes in it.

The port builds the lifecycle map once for the module (40 frames on the
CPU); the JAX package's map is that map as its own `load_atlas` restored
it, written by its own `save_atlas`. An Atlas that JAX itself tracked is
loaded by tests/test_torch_persistence_jax_tracked.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import system as j_system
from morb_slam_tpu.io import config as j_config
from morb_slam_tpu.vocab import tree as j_tree
from morb_slam_tpu_torch import system
from morb_slam_tpu_torch.vocab import tree

from synthetic_world import PlaneWorld, camera_path
from test_torch_persistence import (OVERRIDES, W, H, FX, K, _img,
                                    _relocalize, _vocabulary, make_settings)

torch.set_num_threads(1)


def _jax_settings():
    s = j_config.Settings()
    s.cam1 = j_config.CameraSettings(model="PinHole", fx=FX, fy=FX,
                                     cx=W / 2, cy=H / 2, width=W, height=H)
    s.n_features = 500
    s.n_levels = 4
    return s


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The port's lifecycle session and its Atlas (A), then a JAX System
    that loaded A and saved it again (B) before tracking anything."""
    out = tmp_path_factory.mktemp("atlas_x")
    world = PlaneWorld(K, W, H, seed=0)
    poses = camera_path(40, step=0.05)
    voc = _vocabulary(world, poses[::8])
    sys1 = system.System(make_settings(), system.Sensor.MONOCULAR,
                         vocabulary=voc, tracker_overrides=OVERRIDES,
                         device="cpu")
    for i, (R, t) in enumerate(poses):
        sys1.track_monocular(_img(world, R, t), ts=float(i) * 0.05)
    a, b = str(out / "port_atlas"), str(out / "jax_atlas")
    sys1.save_atlas(a)

    centers, weights = tree.to_arrays(voc)
    jvoc = j_tree.Vocabulary(centers=tuple(jnp.asarray(c) for c in centers),
                             weights=jnp.asarray(weights), k=voc.k)
    jsys = j_system.System(_jax_settings(), j_system.Sensor.MONOCULAR,
                           vocabulary=jvoc, tracker_overrides=OVERRIDES)
    jsys.load_atlas(a)
    jsys.save_atlas(b)
    return dict(world=world, poses=poses, voc=voc, sys1=sys1, jsys=jsys,
                a=a, b=b)


def test_port_atlas_relocalizes_in_jax(sessions):
    jsys, t1 = sessions["jsys"], sessions["sys1"].tracker
    assert jsys.state == "RECENTLY_LOST"
    assert jsys.tracker.n_kf_host == t1.n_kf_host
    assert len(jsys.tracker.trajectory) == len(t1.trajectory)
    for k in t1.m._fields:
        want = t1.m._asdict()[k].numpy()
        got = np.asarray(getattr(jsys.tracker.m, k))
        if got.dtype == np.uint32:
            got = got.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=k)
    jsys.activate_localization_mode()
    n_kf_before = jsys.tracker.n_kf_host
    states = []
    for i in (10, 11, 12, 13):
        R, t = sessions["poses"][i]
        st, _ = jsys.track_monocular(
            jnp.asarray(sessions["world"].render(R, t), jnp.float32),
            ts=100.0 + i)
        states.append(st)
    assert "OK" in states, "JAX failed to relocalize into the port's atlas"
    assert jsys.tracker.n_kf_host == n_kf_before


def test_jax_atlas_relocalizes_in_port(sessions):
    t1 = sessions["sys1"].tracker
    sys2 = system.System(make_settings(), system.Sensor.MONOCULAR,
                         vocabulary=sessions["voc"],
                         tracker_overrides=OVERRIDES, device="cpu")
    sys2.load_atlas(sessions["b"])
    t2 = sys2.tracker
    assert sys2.state == "RECENTLY_LOST"
    assert (t2.n_kf_host, t2.map_gen, len(t2.trajectory)) == \
        (t1.n_kf_host, t1.map_gen, len(t1.trajectory))
    for k in t1.m._fields:
        np.testing.assert_array_equal(getattr(t2.m, k).numpy(),
                                      getattr(t1.m, k).numpy(), err_msg=k)
    for e1, e2 in zip(t1.trajectory, t2.trajectory):
        assert e1[:3] == e2[:3]
        assert torch.equal(e1[3], e2[3]) and torch.equal(e1[4], e2[4])
    sys2.activate_localization_mode()
    n_kf_before = t2.n_kf_host
    states = _relocalize(sys2, sessions["world"], sessions["poses"])
    assert "OK" in states, "the port failed to relocalize into JAX's atlas"
    assert sys2.tracker.n_kf_host == n_kf_before
