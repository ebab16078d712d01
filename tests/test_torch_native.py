"""The port's native library (trackdlo_tpu_torch.native) against the JAX
package's (trackdlo_tpu.native) on the same frames, and the frame feeder
over a .tdlo file and a FIFO, as tests/test_native.py holds the JAX one.

The JAX library is built here from its own source into a temporary
directory and loaded through the JAX module's wrapper, so this file never
races the JAX package's build beside its source."""

import os
import struct
import subprocess
import threading

import numpy as np
import pytest

import trackdlo_tpu.native as jnat
import trackdlo_tpu_torch.native as tnat
from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io.raw_sequence import write_raw_sequence
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame

SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's wrapper on a library built from its source here."""
    so = str(tmp_path_factory.mktemp("jnative") / "libtrackdlo_native.so")
    src = os.path.join(os.path.dirname(jnat.__file__), "preprocess.cpp")
    subprocess.run(["g++", *tnat.CXX_FLAGS, src, "-o", so], check=True, capture_output=True)
    saved = jnat._lib, jnat._LIB_PATH
    jnat._lib, jnat._LIB_PATH = None, so
    assert jnat._load() is not None
    yield jnat
    jnat._lib, jnat._LIB_PATH = saved


@pytest.fixture(scope="module")
def frames():
    rope = SyntheticRope()
    return [render_frame(rope, t, CameraIntrinsics()) for t in (0.0, 0.4)]


def test_library_builds_under_build_not_beside_the_source():
    path = tnat.build()
    assert tnat.available()
    assert path.parent == tnat.BUILD_DIR and path.parent.parent.name == "build"
    assert not list(tnat._SRC.parent.glob("*.so"))


@pytest.mark.parametrize("multi", [False, True])
def test_hsv_mask_equals_the_jax_library(jax_native, frames, multi):
    params = live_params()
    for rgb, _ in frames:
        got = tnat.hsv_mask(rgb, params.hsv_lower, params.hsv_upper, multi)
        assert np.array_equal(got, jax_native.hsv_mask(rgb, params.hsv_lower, params.hsv_upper,
                                                       multi))


@pytest.mark.parametrize("occluded", [False, True])
def test_preprocess_frame_equals_the_jax_library(jax_native, frames, occluded):
    params, intr = live_params(), CameraIntrinsics()
    occ = None
    if occluded:
        occ = np.ones((intr.height, intr.width), np.uint8)
        occ[:, 400:900] = 0
    for rgb, depth in frames:
        got = tnat.preprocess_frame(rgb, depth, params, intr, occlusion_mask=occ)
        want = jax_native.preprocess_frame(rgb, depth, params, intr, occlusion_mask=occ)
        assert got.dtype == np.float64 and len(got) > 0
        assert np.array_equal(got, want)


def test_native_cloud_through_the_points_step_matches_jax(jax_native):
    """preprocess_frame feeds Tracker.step_from_points: the port's step on
    the native cloud against the JAX package's on the JAX library's."""
    from trackdlo_tpu.models.trackdlo import Tracker as JaxTracker
    from trackdlo_tpu_torch.convert import state_from_numpy
    from trackdlo_tpu_torch.models.trackdlo import Tracker

    params = live_params(max_points=512, dlo_pixel_width=10)
    live = CameraIntrinsics()
    intr = CameraIntrinsics(fx=live.fx / 4, fy=live.fy / 4, cx=live.cx / 4, cy=live.cy / 4,
                            width=live.width // 4, height=live.height // 4)
    rope = SyntheticRope()
    rgb, depth = render_frame(rope, 1 / 15.0, intr)
    jt, tt = JaxTracker(params, intr), Tracker(params, intr, device="cpu")
    js = jt.init_from_nodes(rope.nodes(0.0, params.M))
    ts = state_from_numpy(np.asarray(js.y), np.asarray(js.sigma2), np.asarray(js.geodesic_coord),
                          device="cpu")
    cap = params.max_points
    cloud = tnat.preprocess_frame(rgb, depth, params, intr, max_points=cap)
    js, jo = jt.step_from_points(js, jax_native.preprocess_frame(rgb, depth, params, intr,
                                                                 max_points=cap))
    ts, to = tt.step_from_points(ts, cloud)
    assert int(to.n_points) == int(jo.n_points) == len(cloud) > 0
    assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= 5e-4


def test_frame_feeder_reads_a_raw_sequence_in_order(tmp_path):
    rope = SyntheticRope()
    frames = [render_frame(rope, i / 15.0, SMALL, rope_pixel_radius=3) for i in range(5)]
    path = write_raw_sequence(str(tmp_path / "seq.tdlo"), frames)
    with tnat.FrameFeeder(path, n_slots=3) as feeder:
        assert (feeder.n_frames, feeder.height, feeder.width) == (5, SMALL.height, SMALL.width)
        out = list(feeder)
    assert len(out) == 5
    for (r0, d0), (r1, d1) in zip(frames, out):
        assert np.array_equal(r0, r1) and np.array_equal(d0, d1)
    with pytest.raises(IOError):
        tnat.FrameFeeder(str(tmp_path / "missing.tdlo"))


def test_frame_feeder_close_releases_a_consumer_blocked_on_a_fifo(tmp_path):
    """A FIFO delivers the header and one frame, then stalls: the consumer
    blocks on frame 1 until close() releases it (the producer, stuck
    reading the FIFO, leaves when the writer closes)."""
    h, w, n_frames = 4, 4, 3
    fifo = str(tmp_path / "seq.tdlo")
    os.mkfifo(fifo)
    fds = {}

    def writer():
        fds["fd"] = os.open(fifo, os.O_WRONLY)
        os.write(fds["fd"], struct.pack("<5I", 0x4F4C4454, 1, n_frames, h, w))
        os.write(fds["fd"], b"\x07" * (h * w * 3 + h * w * 2))

    wt = threading.Thread(target=writer)
    wt.start()
    feeder = tnat.FrameFeeder(fifo, n_slots=2)
    wt.join(timeout=10)
    assert not wt.is_alive() and feeder.n_frames == n_frames
    got = []

    def consume():
        for rgb, _ in feeder:
            got.append(int(rgb[0, 0, 0]))

    ct = threading.Thread(target=consume)
    ct.start()
    for _ in range(500):
        if got:
            break
        threading.Event().wait(0.01)
    assert got == [7]
    closer = threading.Thread(target=feeder.close)
    closer.start()
    threading.Event().wait(0.05)
    os.close(fds["fd"])
    ct.join(timeout=10)
    closer.join(timeout=10)
    assert not ct.is_alive(), "consumer deadlocked"
    assert not closer.is_alive(), "close() never returned"
