"""The port's model families and state files against the JAX package's, on
the CPU: ``build_step_fn`` (on the card one CUDA graph; on the CPU the eager
step), ``GltpTracker``, ``register_gmm`` and the checkpoint's npz files in
both directions. Seeded numpy inputs go to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame
from trackdlo_tpu_torch import _build
from trackdlo_tpu_torch.config import live_params as torch_live_params
from trackdlo_tpu_torch.convert import state_from_numpy, state_to_numpy
from trackdlo_tpu_torch.io.checkpoint import load_state, save_state
from trackdlo_tpu_torch.models import Tracker, TrackerState, build_step_fn
from trackdlo_tpu_torch.models.cpd import register_gmm
from trackdlo_tpu_torch.models.gltp import GltpTracker
from trackdlo_tpu_torch.models.trackdlo import (
    CompiledStep, StepOutputs, _copy_into, _copy_outputs, _host_tensor, _stage,
)

SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
SMALL_KW = dict(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)
PARAMS = live_params(**SMALL_KW)
TORCH_PARAMS = torch_live_params(**SMALL_KW)
# Per frame from one state: the open-loop step bound of
# tests/test_torch_tracker.py (two float32 realisations of the same step).
STEP_TOL_M = 5e-4
# 100 fixed EM iterations of the same float32 algorithm, sums in another order.
GMM_TOL_M = 1e-5


def _frames(intr, n=3):
    rope = SyntheticRope()
    out = []
    for i in range(1, n + 1):
        rgb, depth = render_frame(rope, i / 15.0, intr, rope_pixel_radius=3)
        occ = np.ones((intr.height, intr.width), bool)
        if i == 2:
            occ[:, 62:100] = False
        out.append((rgb, depth, occ))
    return out


def _to_torch(js):
    return state_from_numpy(np.asarray(js.y), np.asarray(js.sigma2), np.asarray(js.geodesic_coord),
                            device="cpu")


def test_build_step_fn_matches_jax():
    """Three frames, each from the JAX step's state."""
    from trackdlo_tpu.models.trackdlo import build_step_fn as jax_build_step_fn
    from trackdlo_tpu.models.trackdlo import init_state as jax_init_state

    jstep = jax_build_step_fn(PARAMS, SMALL, jit=True)
    tstep = build_step_fn(TORCH_PARAMS, SMALL, jit=True, device="cpu")
    js = jax_init_state(SyntheticRope().nodes(0.0, PARAMS.M), PARAMS)
    for rgb, depth, occ in _frames(SMALL):
        ts = _to_torch(js)
        js, jo = jstep(js, jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(occ))
        ts, to = tstep(ts, rgb, depth, occ)
        assert isinstance(to, StepOutputs)
        assert int(to.n_points) == int(jo.n_points)
        assert int(to.occlusion_state) == int(jo.occlusion_state)
        assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= STEP_TOL_M


def test_build_step_fn_on_the_cpu_is_the_trackers_eager_step():
    tracker = Tracker(TORCH_PARAMS, SMALL, device="cpu")
    step = build_step_fn(TORCH_PARAMS, SMALL, device="cpu")
    assert not isinstance(step, CompiledStep) and not isinstance(tracker._step, CompiledStep)
    a = b = tracker.init_from_nodes(SyntheticRope().nodes(0.0, TORCH_PARAMS.M))
    for rgb, depth, occ in _frames(SMALL, 2):
        a, oa = tracker.step(a, rgb, depth, occ)
        b, ob = step(b, rgb, depth, occ)
        for f in StepOutputs._fields:
            assert torch.equal(getattr(oa, f), getattr(ob, f)), f


def test_compiled_step_helpers(monkeypatch):
    """The graph step's input copies check shape and dtype (u16 depth as its
    int16 bits; a bool buffer takes a mask of its shape or with one channel
    axis more), through the host staging buffer (a plain CPU tensor here,
    pinned on the card); its output copies keep the outputs' aliasing (the
    state's y and the outputs' y stay one tensor, cloned once)."""
    dst, staging = torch.empty((2, 3), dtype=torch.int16), torch.empty((2, 3), dtype=torch.int16)
    _copy_into(dst, np.arange(6, dtype=np.uint16).reshape(2, 3) + 65530, "depth", staging)
    assert dst.view(torch.uint16).tolist() == [[65530, 65531, 65532], [65533, 65534, 65535]]
    assert torch.equal(staging, dst)
    with pytest.raises(ValueError, match="depth must be"):
        _copy_into(dst, np.zeros((2, 3), np.int32), "depth", staging)
    with pytest.raises(ValueError, match="depth must be"):
        _copy_into(dst, np.zeros((1, 3), np.uint16), "depth", staging)
    occ = torch.empty((2, 3), dtype=torch.bool)
    for bad in (np.ones((3, 2), bool), np.ones((2, 3, 1, 1), bool), np.ones((2,), bool)):
        with pytest.raises(ValueError, match="occ must be"):
            _copy_into(occ, bad, "occ", torch.empty((2, 3), dtype=torch.bool))
    y = torch.zeros(3)
    tree = (TrackerState(y, torch.ones(()), torch.arange(3.0)), (y, torch.zeros(2)))
    clones = []
    clone = torch.Tensor.clone
    monkeypatch.setattr(torch.Tensor, "clone", lambda t: clones.append(t) or clone(t))
    out = _copy_outputs(tree)
    assert isinstance(out[0], TrackerState)
    assert out[0].y is out[1][0] and out[0].y is not y
    assert len(clones) == 4


def _staging_cases():
    """Frame arrays as callers hand them over: (name, array, kind), kind
    "mask" for the occlusion mask, else the static buffer's name."""
    rng = np.random.default_rng(7)
    h, w = SMALL.height, SMALL.width
    keep = rng.random((h, w)) > 0.3
    wide = rng.integers(0, 256, (h + 8, w + 16, 4), dtype=np.uint8)
    return [
        ("bool", keep, "mask"),
        ("uint8_0_255", keep.astype(np.uint8) * 255, "mask"),
        ("int32", rng.integers(-2, 3, (h, w), dtype=np.int32), "mask"),
        ("float32", rng.standard_normal((h, w)).astype(np.float32) * keep, "mask"),
        ("bool_bytes_0_255", (keep.astype(np.uint8) * 255).view(bool), "mask"),
        ("channel_axis", rng.integers(0, 2, (h, w, 3), dtype=np.uint8), "mask"),
        ("channel_axis_bool", rng.random((h, w, 3)) > 0.8, "mask"),
        ("mask_slice", wide[4:4 + h, 8:8 + w, 1], "mask"),
        ("mask_reversed", keep[::-1], "mask"),
        ("mask_cpu_tensor", torch.from_numpy(wide[4:4 + h, 8:8 + w, 2]), "mask"),
        ("depth_u16", rng.integers(0, 65536, (h, w), dtype=np.uint16), "depth"),
        ("depth_slice", rng.integers(0, 65536, (h, w + 5), dtype=np.uint16)[:, 5:], "depth"),
        ("rgb", rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "rgb"),
        ("rgb_slice", wide[4:4 + h, 8:8 + w, :3], "rgb"),
        ("rgb_bgr_reversed", wide[:h, :w, 2::-1], "rgb"),
    ]


@pytest.mark.parametrize("case", _staging_cases(), ids=lambda c: c[0])
def test_staging_write_gives_the_eager_paths_bytes(case):
    """The graph step's one-pass write into its host staging buffer (a plain
    CPU tensor here) gives, byte for byte, what the eager path hands the
    card: the occlusion mask of ``Tracker._occ`` (nonzero keeps a pixel, a
    trailing channel axis any-reduced, as canonical bools), the frames'
    ``_host_tensor`` bits (u16 depth as int16), whatever the strides."""
    _, src, kind = case
    shapes = {"mask": ((SMALL.height, SMALL.width), torch.bool),
              "depth": ((SMALL.height, SMALL.width), torch.int16),
              "rgb": ((SMALL.height, SMALL.width, 3), torch.uint8)}
    shape, dtype = shapes[kind]
    buf = torch.empty(shape, dtype=dtype)
    _stage(buf, src, kind)
    if kind == "mask":
        tracker = Tracker(TORCH_PARAMS, SMALL, device="cpu")
        state = tracker.init_from_nodes(SyntheticRope().nodes(0.0, TORCH_PARAMS.M))
        rgb, depth = np.zeros((*shape, 3), np.uint8), np.zeros(shape, np.uint16)
        want = tracker._occ(state, rgb, depth, src)
        assert torch.equal(buf.view(torch.uint8), want.view(torch.uint8))
    else:
        want = _host_tensor(src, torch.device("cpu"))
        assert want.dtype == buf.dtype and torch.equal(buf, want)


def test_gltp_tracker_matches_jax():
    """Three frames, each from the JAX GLTP step's state, on the JAX
    package's kernel route (the whole-loop kernel B1 interpreted, which
    kernel E ports). Its XLA route lands up to 5.6e-4 m from that route on
    these frames (the GLTP pass solves systems with cond(A) near 4e6)."""
    import dataclasses

    from trackdlo_tpu.models.gltp import GltpTracker as JaxGltpTracker

    jt = JaxGltpTracker(dataclasses.replace(PARAMS, use_pallas_estep=True), SMALL)
    tt = GltpTracker(TORCH_PARAMS, SMALL, device="cpu")
    js = jt.init_from_nodes(SyntheticRope().nodes(0.0, PARAMS.M))
    for rgb, depth, occ in _frames(SMALL):
        ts = _to_torch(js)
        js, jres = jt.step(js, rgb, depth, occ)
        ts, tres = tt.step(ts, rgb, depth, occ)
        # The pass exits at a 0.2 mm mean move, so two float32 routes may
        # stop one iteration apart (frame 2 here: 3.1e-4 m apart).
        assert abs(int(tres.iterations) - int(jres.iterations)) <= 1
        assert np.abs(ts.y.numpy() - np.asarray(js.y)).max() <= STEP_TOL_M
        assert torch.equal(ts.geodesic_coord, torch.from_numpy(np.asarray(js.geodesic_coord)))


@pytest.mark.parametrize("seed", [0, 1])
def test_register_gmm_matches_jax(seed):
    from trackdlo_tpu.models.cpd import register_gmm as jax_register_gmm

    rng = np.random.default_rng(seed)
    curve = SyntheticRope().curve(1 / 15.0)
    x = np.zeros((300, 3), np.float32)
    x[:250] = curve[rng.integers(0, len(curve), 250)] + rng.normal(0, 0.002, (250, 3))
    xm = np.arange(300) < 250
    jy, js2 = jax_register_gmm(jnp.asarray(x), jnp.asarray(xm), m=40, mu=0.05, max_iter=100)
    ty, ts2 = register_gmm(x, xm, m=40, mu=0.05, max_iter=100, device="cpu")
    assert ty.shape == (40, 3) and ty.dtype == torch.float32
    assert np.abs(ty.numpy() - np.asarray(jy)).max() <= GMM_TOL_M
    assert abs(float(ts2) - float(js2)) <= 1e-7


def test_checkpoints_load_in_either_package(tmp_path):
    from trackdlo_tpu.io.checkpoint import load_state as jax_load_state
    from trackdlo_tpu.io.checkpoint import save_state as jax_save_state
    from trackdlo_tpu.models.trackdlo import init_state as jax_init_state

    nodes = SyntheticRope().nodes(0.3, PARAMS.M)
    js = jax_init_state(nodes, PARAMS)._replace(sigma2=jnp.asarray(np.float32(3.3e-4)))
    jax_save_state(str(tmp_path / "jax.npz"), js)
    ts = load_state(str(tmp_path / "jax.npz"), device="cpu")
    for a, b in zip(state_to_numpy(ts), js):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))

    path = save_state(str(tmp_path / "port.npz"), ts)
    back = jax_load_state(path)
    for a, b in zip(back, js):
        assert np.asarray(a).dtype == np.float32 and np.array_equal(np.asarray(a), np.asarray(b))

    batched = TrackerState(*(torch.stack([v, v + 1]) for v in ts))
    again = load_state(save_state(str(tmp_path / "b.npz"), batched), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, batched))


def test_load_state_defaults_to_the_card(tmp_path):
    path = save_state(str(tmp_path / "s.npz"),
                      state_from_numpy(np.zeros((4, 3)), 1e-3, np.arange(4.0), device="cpu"))
    if torch.cuda.is_available():
        assert load_state(path).y.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_state(path)


@pytest.mark.parametrize("m", [45, 64])
@pytest.mark.parametrize("profile", [{}, {"parity_split": False}, {"exact_voxels": False}])
def test_step_reads_no_device_value_on_the_host(m, profile):
    """A CUDA graph cannot hold a read of a device value by the host
    (``.item()``, ``bool(t)``, a 0-dim tensor used as an index): it breaks
    the capture. On the CPU, every such read of the step and of the GLTP
    step goes through ``aten._local_scalar_dense``; the only one allowed is
    the plain EM loop's early exit, which runs only on the CPU."""
    import dataclasses
    import traceback

    from torch.utils._python_dispatch import TorchDispatchMode

    reads = []

    class HostReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                frames = [f for f in traceback.extract_stack() if "trackdlo_tpu_torch" in f.filename]
                reads.append(f"{frames[-1].filename.rsplit('/', 1)[-1]}:{frames[-1].name}")
            return func(*args, **(kwargs or {}))

    params = dataclasses.replace(torch_live_params(num_of_nodes=m, **SMALL_KW), **profile)
    rgb, depth, occ = _frames(SMALL, 2)[1]
    tracker = Tracker(params, SMALL, device="cpu")
    gltp = GltpTracker(params, SMALL, device="cpu")
    nodes = SyntheticRope().nodes(0.0, m)
    with HostReads():
        tracker.step(tracker.init_from_nodes(nodes), rgb, depth, occ)
        gltp.step(gltp.init_from_nodes(nodes), rgb, depth, occ)
    assert reads and set(reads) == {"hopper_kernels.py:fused_em_loop_plain"}, set(reads)
