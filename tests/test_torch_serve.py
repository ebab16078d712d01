"""The port's serving path on the CPU, mirroring tests/test_net.py and
tests/test_health.py: the TCP server (trackdlo_tpu_torch.io.net) with
concurrent clients, its results against direct ``Tracker.step`` calls, its
wire bytes against the JAX package's server and client, and the health
supervisor (trackdlo_tpu_torch.utils.health) against the JAX package's."""

import dataclasses
import socket
import threading

import numpy as np
import pytest
import torch

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io import net as jnet
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu.utils import health as jhealth
from trackdlo_tpu_torch.io import net as tnet
from trackdlo_tpu_torch.models.trackdlo import Tracker, init_state
from trackdlo_tpu_torch.utils import health as thealth

# tests/test_net.py's camera: enough pixels for the skeleton initializer.
INTR = CameraIntrinsics(fx=240.0, fy=240.0, cx=160.0, cy=120.0, width=320, height=240)
PARAMS = live_params(max_points=512, downsample_cell_px=4)
N_FRAMES = 4


@pytest.fixture(scope="module")
def server():
    srv = tnet.TrackerServer(params=PARAMS, intrinsics=INTR, host="127.0.0.1", port=0,
                             device="cpu")
    host, port = srv.start()
    yield srv, host, port
    srv.shutdown()


def _frames(offset):
    rope = SyntheticRope()
    return [render_frame(rope, i / 15.0 + offset, INTR, rope_pixel_radius=4)
            for i in range(N_FRAMES)]


def _direct(frames):
    """The results a connection should get, from direct Tracker calls."""
    tracker = Tracker(PARAMS, INTR, device="cpu")
    state = tracker.init_from_frame(*frames[0])
    out = [dict(y=state.y.numpy(), sigma2=np.float32(state.sigma2), iterations=0)]
    for rgb, depth in frames[1:]:
        state, o = tracker.step(state, rgb, depth)
        out.append(dict(y=o.y.numpy(), sigma2=np.float32(o.sigma2), iterations=int(o.iterations),
                        occlusion_state=int(o.occlusion_state), converged=bool(o.converged),
                        visible=o.visible_mask.numpy()))
    return out


def test_two_concurrent_clients_equal_direct_steps(server):
    _, host, port = server
    offsets = (0.0, 2 / 15.0)
    results, errors = {}, []

    def run(offset):
        try:
            with tnet.TrackerClient(host, port) as cli:
                results[offset] = [cli.track(rgb, depth) for rgb, depth in _frames(offset)]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(o,)) for o in offsets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for offset in offsets:
        for got, want in zip(results[offset], _direct(_frames(offset)), strict=True):
            assert np.array_equal(got["y"], want["y"])
            assert np.float32(got["sigma2"]) == want["sigma2"]
            assert got["iterations"] == want["iterations"]
            for k in ("occlusion_state", "converged", "visible"):
                if k in want:
                    assert np.array_equal(got[k], want[k]), k
    assert not np.allclose(results[offsets[0]][-1]["y"], results[offsets[1]][-1]["y"])


def _raw_reply(host, port, frames, m):
    """Each frame's reply bytes, as a JAX client sends and reads them."""
    with socket.create_connection((host, port)) as sock:
        replies = []
        for rgb, depth in frames:
            jnet.send_frame(sock, rgb, depth)
            replies.append(jnet._recv_exact(sock, jnet._RES_HDR.size + 13 * m))
    return replies


def test_wire_bytes_equal_the_jax_server(server):
    """The initialising frame's reply byte for byte against a JAX server's;
    a tracking frame's reply against the JAX package's layout of the same
    values."""
    _, host, port = server
    frames = _frames(0.0)[:2]
    m = PARAMS.M
    jsrv = jnet.TrackerServer(params=PARAMS, intrinsics=INTR, host="127.0.0.1", port=0)
    jhost, jport = jsrv.start()
    try:
        jax_init = _raw_reply(jhost, jport, frames[:1], m)[0]
    finally:
        jsrv.shutdown()
    init, tracked = _raw_reply(host, port, frames, m)
    assert init == jax_init
    want = _direct(frames)[1]
    layout = (jnet._RES_HDR.pack(jnet.MAGIC, jnet.MSG_RESULT, m, want["occlusion_state"],
                                 int(want["converged"]), want["iterations"], float(want["sigma2"]))
              + want["y"].astype("<f4").tobytes() + want["visible"].astype(np.uint8).tobytes())
    assert tracked == layout
    assert jnet._HDR.format == tnet._HDR.format and jnet._RES_HDR.format == tnet._RES_HDR.format


def test_clients_of_either_package_talk_to_servers_of_either(server):
    _, host, port = server
    rgb, depth = _frames(0.0)[0]
    jsrv = jnet.TrackerServer(params=PARAMS, intrinsics=INTR, host="127.0.0.1", port=0)
    jhost, jport = jsrv.start()
    try:
        with tnet.TrackerClient(jhost, jport) as cli:
            from_jax = cli.track(rgb, depth)
    finally:
        jsrv.shutdown()
    with jnet.TrackerClient(host, port) as cli:
        from_port = cli.track(rgb, depth)
        tracked = cli.track(*_frames(0.0)[1])
    assert from_jax["iterations"] == from_port["iterations"] == 0
    assert np.array_equal(from_jax["y"], from_port["y"]) and from_port["y"].shape == (PARAMS.M, 3)
    assert tracked["iterations"] > 0 and np.isfinite(tracked["y"]).all()


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        srv = tnet.TrackerServer(params=PARAMS, intrinsics=INTR, host="127.0.0.1", port=0)
        srv.start()
        srv.shutdown()
        assert srv.tracker.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tnet.TrackerServer(params=PARAMS, intrinsics=INTR, host="127.0.0.1", port=0)


def _corrupt(kind, y):
    y = y.copy()
    if kind == "nan":
        y[3, 1] = np.nan
    elif kind == "jump":
        y[0] += np.array([0.5, 0.0, 0.0], np.float32)
    elif kind == "length":
        y = y * 2.0
    return y


@pytest.mark.parametrize("kind", ["healthy", "nan", "jump", "length"])
def test_check_state_matches_jax(kind):
    """The supervisor's rules on the cases of tests/test_health.py: the port's
    report (from CPU tensors) field for field the JAX package's."""
    from trackdlo_tpu.models.trackdlo import init_state as jax_init_state

    params = live_params()
    nodes = SyntheticRope().nodes(0.0, params.M)
    kw = dict(max_jump=10.0) if kind == "length" else {}
    ts = init_state(nodes, params, device="cpu")
    ts = ts._replace(y=torch.from_numpy(_corrupt(kind, ts.y.numpy())))
    js = jax_init_state(nodes, params)
    js = js._replace(y=np.asarray(ts.y.numpy()))
    got = thealth.check_state(nodes.astype(np.float32), ts, **kw)
    want = jhealth.check_state(nodes.astype(np.float32), js, **kw)
    assert dataclasses.asdict(got) == pytest.approx(dataclasses.asdict(want), nan_ok=True)
    assert got.healthy == (kind == "healthy")
    assert kind in ("healthy", "nan") or kind in got.reason


def test_supervisor_reinitialises_a_corrupt_state():
    """tests/test_health.py's supervisor cases at its live profile and 720p
    camera: healthy frames pass through; a teleported chain is
    re-initialised from the live frame and lands on the rope."""
    params, intr, rope = live_params(), CameraIntrinsics(), SyntheticRope()
    sup = thealth.TrackingSupervisor(Tracker(params, intr, device="cpu"))
    state = sup.tracker.init_from_nodes(rope.nodes(0.0, params.M))
    for i in range(1, 3):
        state, out = sup.step(state, *render_frame(rope, i / 15.0, intr))
    assert sup.reinit_count == 0 and sup.last_report.healthy
    state = state._replace(y=state.y + 5.0)  # teleported far from the rope
    for i in range(3, 8):
        state, out = sup.step(state, *render_frame(rope, i / 15.0, intr))
        if sup.reinit_count:
            break
    assert sup.reinit_count >= 1
    gt = rope.nodes(i / 15.0, params.M)
    y = state.y.numpy()
    err = min(np.linalg.norm(y - gt, axis=1).mean(), np.linalg.norm(y[::-1] - gt, axis=1).mean())
    assert err < 0.02
