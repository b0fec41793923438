"""An Atlas that the JAX package tracked and saved loads into the PyTorch
port: the JAX System runs the lifecycle test's 40 frames
(tests/test_system.py:24) with the port's vocabulary and saves its Atlas;
the port restores it field-equal (map, trajectory anchors, counters, bias,
the rebuilt BoW database) and relocalizes on the revisit frames. The same
session, its map stashed by `create_map_in_atlas`, saves a second Atlas,
whose stash (map and database) the port restores as JAX wrote it.

The JAX session is built once for the module.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import system as j_system
from morb_slam_tpu.vocab import tree as j_tree
from morb_slam_tpu_torch import system
from morb_slam_tpu_torch.vocab import tree

from synthetic_world import PlaneWorld, camera_path
from test_torch_persistence import (OVERRIDES, K, _relocalize, _vocabulary,
                                    make_settings)
from test_torch_persistence_jax import _jax_settings

torch.set_num_threads(1)


def _as_port(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _map_equal(port_m, jax_m):
    for k in port_m._fields:
        np.testing.assert_array_equal(getattr(port_m, k).numpy(),
                                      _as_port(getattr(jax_m, k)), err_msg=k)


@pytest.fixture(scope="module")
def jax_session(tmp_path_factory):
    """The JAX lifecycle session (40 frames), its Atlas (active) and, after
    `create_map_in_atlas`, its Atlas with the map stashed (stashed)."""
    out = tmp_path_factory.mktemp("atlas_jax")
    world = PlaneWorld(K, 384, 288, seed=0)
    poses = camera_path(40, step=0.05)
    voc = _vocabulary(world, poses[::8])
    centers, weights = tree.to_arrays(voc)
    jvoc = j_tree.Vocabulary(centers=tuple(jnp.asarray(c) for c in centers),
                             weights=jnp.asarray(weights), k=voc.k)
    jsys = j_system.System(_jax_settings(), j_system.Sensor.MONOCULAR,
                           vocabulary=jvoc, tracker_overrides=OVERRIDES)
    for i, (R, t) in enumerate(poses):
        jsys.track_monocular(jnp.asarray(world.render(R, t), jnp.float32),
                             ts=float(i) * 0.05)
    jt = jsys.tracker
    active, stashed = str(out / "active"), str(out / "stashed")
    jsys.save_atlas(active)     # flushes the pipelined frames first
    snap = dict(state=jsys.state, m=jt.m, db=jt.db, n_kf_host=jt.n_kf_host,
                map_gen=jt.map_gen, trajectory=list(jt.trajectory),
                bias=np.asarray(jt.bias))
    jt.create_map_in_atlas()
    jsys.save_atlas(stashed)
    return dict(world=world, poses=poses, voc=voc, snap=snap,
                stash=jt.stash[0], active=active, stashed=stashed)


def _port_system(voc):
    return system.System(make_settings(), system.Sensor.MONOCULAR,
                         vocabulary=voc, tracker_overrides=OVERRIDES,
                         device="cpu")


def test_jax_tracked_atlas_relocalizes_in_port(jax_session):
    snap = jax_session["snap"]
    assert snap["state"] == "OK"
    sm = _port_system(jax_session["voc"])
    sm.load_atlas(jax_session["active"])
    t = sm.tracker
    assert sm.state == "RECENTLY_LOST"
    assert (t.n_kf_host, t.map_gen, len(t.trajectory)) == \
        (snap["n_kf_host"], snap["map_gen"], len(snap["trajectory"]))
    _map_equal(t.m, snap["m"])
    for e, j in zip(t.trajectory, snap["trajectory"]):
        assert e[:3] == j[:3]
        np.testing.assert_array_equal(e[3].numpy(), np.asarray(j[3]))
        np.testing.assert_array_equal(e[4].numpy(), np.asarray(j[4]))
    np.testing.assert_array_equal(t.bias.numpy(), snap["bias"])
    # the database is derived state: the port rebuilds it by its own K9
    # transform and BoW weighting
    np.testing.assert_array_equal(t.db.valid.numpy(),
                                  np.asarray(snap["db"].valid))
    np.testing.assert_allclose(t.db.bow.numpy(), np.asarray(snap["db"].bow),
                               atol=1e-6)
    sm.activate_localization_mode()
    n_kf_before = t.n_kf_host
    states = _relocalize(sm, jax_session["world"], jax_session["poses"])
    assert "OK" in states, "the port failed to relocalize into JAX's atlas"
    assert sm.tracker.n_kf_host == n_kf_before


def test_jax_stashed_atlas_loads_in_port(jax_session):
    snap, js = jax_session["snap"], jax_session["stash"]
    sm = _port_system(jax_session["voc"])
    sm.load_atlas(jax_session["stashed"])
    t = sm.tracker
    assert (t.map_gen, t.n_kf_host) == (snap["map_gen"] + 1, 0)
    assert len(t.stash) == 1
    st = t.stash[0]
    assert (st.gen, st.n_kf, st.merged_into_gen, st.kf_offset) == \
        (js.gen, js.n_kf, js.merged_into_gen, js.kf_offset)
    _map_equal(st.m, snap["m"])
    np.testing.assert_array_equal(st.db.bow.numpy(), np.asarray(js.db.bow))
    np.testing.assert_array_equal(st.db.valid.numpy(),
                                  np.asarray(js.db.valid))
    assert st.kf_imu is None
