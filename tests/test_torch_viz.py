"""The port's headless visualization layer (``hyslam_tpu_torch/viz/``)
against the JAX package's on the CPU: the 2D primitives' arrays and the PNG
bytes equal, ``draw_frame`` and ``draw_map`` pixel-equal (the map state
passed from the JAX package through ``interop``), the Viewer's dumps and
snapshots byte-equal and its threaded loop working, and
``System._maybe_dump_frame`` writing the JAX System's PNGs on the same
frames. Tensors given to the port's drawers (on any device) draw as their
numpy arrays."""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu import viz as jviz
from hyslam_tpu.slam.system import System as JSystem
from hyslam_tpu.viz import draw2d as jdraw2d
from hyslam_tpu_torch import viz
from hyslam_tpu_torch.slam.system import System
from hyslam_tpu_torch.viz import draw2d

from port_helpers import ms_to_torch, system_configs, system_sequence
import test_viz


def _prims(m):
    """Every 2D primitive of draw2d module m on one canvas."""
    rng = np.random.default_rng(3)
    img = m.blank(60, 90, (10, 20, 30))
    m.draw_points(img, rng.uniform(-5, 95, (40, 2)), (255, 0, 0), radius=1,
                  mask=rng.uniform(size=40) < 0.7)
    m.draw_points(img, rng.uniform(0, 60, (10, 2)), (0, 0, 255), radius=0)
    m.draw_segments(img, rng.uniform(-20, 110, (12, 2)), rng.uniform(-20, 110, (12, 2)),
                    (0, 255, 0), mask=np.arange(12) % 3 != 0)
    m.draw_text(img, "KFS: 12  MPS: 3456 | NORMAL (x/y=-1%)", 2, 40, (235, 235, 235))
    return img


def test_draw2d_arrays_and_png_bytes_equal_jax(tmp_path):
    got, want = _prims(draw2d), _prims(jdraw2d)
    np.testing.assert_array_equal(got, want)
    assert (got != got[0, 0]).any()
    draw2d.write_png(str(tmp_path / "t.png"), got)
    jdraw2d.write_png(str(tmp_path / "j.png"), want)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


@pytest.mark.parametrize("kind", ["matched", "init", "plain", "rgb_tensors"])
def test_draw_frame_pixel_equal_jax(kind):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    uv = rng.uniform(5, 150, (32, 2)).astype(np.float32)
    valid = rng.uniform(size=32) < 0.9
    lm = np.where(np.arange(32) < 10, np.arange(32), -1)
    kw = dict(state="NORMAL", n_kfs=4, n_landmarks=200)
    if kind == "matched":
        args = (img, uv, valid, lm)
    elif kind == "init":
        args = (img, uv, valid)
        kw.update(init_uv_ref=uv[::-1].copy(), init_matches=np.arange(32) - 3)
    elif kind == "plain":
        args = (img / 255.0, uv, valid)
    else:
        img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
        args = (img, uv, valid, lm)
    want = jviz.draw_frame(*args, **kw)
    got = viz.draw_frame(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)
    np.testing.assert_array_equal(viz.draw_frame(*args, **kw), want)
    np.testing.assert_array_equal(got, want)
    assert want.shape == (120 + 22, 160, 3)


@pytest.mark.parametrize("kind", ["auto", "follow", "empty"])
def test_draw_map_pixel_equal_jax(kind):
    """One JAX map state, passed to the port through interop, drawn by both
    packages: the same pixels."""
    from hyslam_tpu.core.mapstate import MapCaps, empty_map_state

    ms_j = (test_viz.TestMapDrawer()._small_map() if kind != "empty"
            else empty_map_state(MapCaps(K=4, L=16, F=8, O=2)))
    ms_t = ms_to_torch(ms_j)
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, 3] = (0.1, -0.2, 0.3)
    traj = np.array([[0, 0, 0], [0, 0, 0.5], [0.1, 0, 1.0]], np.float32)
    if kind == "follow":
        want = jviz.MapDrawer(size=(160, 120)).draw(ms_j, Tcw, traj)
        got = viz.MapDrawer(size=(160, 120)).draw(ms_t, torch.from_numpy(Tcw),
                                                  torch.from_numpy(traj))
    else:
        want = jviz.draw_map(ms_j, size=(320, 240), current_Tcw=Tcw, trajectory_centers=traj)
        got = viz.draw_map(ms_t, size=(320, 240), current_Tcw=Tcw, trajectory_centers=traj)
    np.testing.assert_array_equal(got, want)
    assert (want != want[0, 0]).any()


def test_viewer_dumps_and_snapshots_equal_jax(tmp_path):
    ms_j = test_viz.TestMapDrawer()._small_map()
    ms_t = ms_to_torch(ms_j)
    img = np.random.default_rng(1).uniform(0, 255, (40, 60)).astype(np.float32)
    uv = np.array([[5.0, 5.0], [20.0, 20.0], [40.0, 30.0]], np.float32)
    for pkg, ms in ((jviz, ms_j), (viz, ms_t)):
        v = pkg.Viewer(out_dir=str(tmp_path / pkg.__name__), dump_every=2)
        for _ in range(4):
            v.update(ms, current_Tcw=np.eye(4, dtype=np.float32), img=img, uv=uv,
                     feat_valid=np.ones(3, bool), lm_id=np.array([0, -1, 2]), state="NORMAL")
        assert len(v.snapshot()) == 2
    names = sorted(os.listdir(tmp_path / "hyslam_tpu.viz"))
    assert names == sorted(os.listdir(tmp_path / "hyslam_tpu_torch.viz"))
    assert len([n for n in names if n.startswith("features_")]) == 2
    for n in names:
        assert ((tmp_path / "hyslam_tpu_torch.viz" / n).read_bytes()
                == (tmp_path / "hyslam_tpu.viz" / n).read_bytes()), n


def test_viewer_threaded_loop(tmp_path):
    v = viz.Viewer(out_dir=str(tmp_path / "loop"), fps=20.0)
    v.update(ms_to_torch(test_viz.TestMapDrawer()._small_map()),
             current_Tcw=torch.eye(4), trajectory_centers=torch.zeros(3, 3))
    v.start()
    time.sleep(0.5)
    thread = v._thread
    v.stop()
    assert not thread.is_alive()
    files = os.listdir(tmp_path / "loop")
    assert len(files) >= 2 and all(f.startswith("view_") for f in files)


def test_system_frame_dumps_equal_jax(tmp_path):
    """With run_data_dir set, both Systems write the frame-0 dump of
    track_stereo, and _maybe_dump_frame on the tracked state (POSTINIT, one
    keyframe, the seeded landmarks) writes the same PNG in both; async
    mode writes none."""
    _, _, pairs = system_sequence(1)
    jcfg, tcfg = system_configs(run_data_dir=str(tmp_path / "j"))
    tcfg.run_data_dir = str(tmp_path / "t")
    js, ts = JSystem(jcfg), System(tcfg)
    js.track_stereo(pairs[0, 0], pairs[0, 1], 0.0, frame_id=0)
    ts.track_stereo(pairs[0, 0], pairs[0, 1], 0.0, frame_id=0)
    from hyslam_tpu.ops.pyramid import preprocess_image as j_pre

    jt, tt = js.trackers["SLAM"], ts.trackers["SLAM"]
    assert tt.state.name == jt.state.name == "POSTINIT"
    js._maybe_dump_frame("SLAM", j_pre(jnp.asarray(pairs[0, 0]), 1.0), jt.last_feats, every=1)
    ts._maybe_dump_frame("SLAM", ts._image(pairs[0, 0], 1.0), tt.last_feats, every=1)
    names = sorted(f for f in os.listdir(tmp_path / "j") if f.endswith(".png"))
    assert names == ["features_SLAM_000000.png", "features_SLAM_000001.png"]
    assert names == sorted(f for f in os.listdir(tmp_path / "t") if f.endswith(".png"))
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n
    js.shutdown()
    ts.shutdown()
    _, acfg = system_configs(async_tracking=True, run_data_dir=str(tmp_path / "a"))
    a = System(acfg)
    a.track_stereo(pairs[0, 0], pairs[0, 1], 0.0, frame_id=0)
    assert not [f for f in os.listdir(tmp_path / "a") if f.endswith(".png")]
