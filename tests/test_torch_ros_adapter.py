"""The port's ROS adapter (trackdlo_tpu_torch.io.ros_adapter) with a stubbed
ROS runtime, as tests/test_ros_adapter.py drives the JAX package's: the
camera-info wiring, the init nodes, one step from the init nodes and every topic's
message, against the JAX node's messages on the same frames (the step's
tolerance of tests/test_torch_tracker.py)."""

import sys
import types

import numpy as np
import pytest

from trackdlo_tpu.config import CameraIntrinsics, live_params
from trackdlo_tpu.io.sequence import SyntheticRope, render_frame

SMALL = CameraIntrinsics(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)
# tests/test_torch_tracker.py's small-camera profile and per-step bound: the
# painter's line scaled to the small camera, so some nodes stay visible.
SMALL_PARAMS = live_params(max_points=256, downsample_cell_px=4, dlo_pixel_width=5)
STEP_TOL_M = 5e-4


class _Sub:
    def __init__(self, topic, msg_type, cb=None):
        self.topic, self.cb = topic, cb

    def unregister(self):
        pass


class _Pub:
    def __init__(self, topic, msg_type, queue_size=0):
        self.topic, self.published = topic, []

    def publish(self, msg):
        self.published.append(msg)


class _Msg:
    def __init__(self, arr=None, **attrs):
        self.arr = arr
        self.header = types.SimpleNamespace(stamp=123, frame_id="")
        for k, v in attrs.items():
            setattr(self, k, v)


class _Marker:
    SPHERE, CYLINDER, ADD = 2, 3, 0

    def __init__(self):
        ns = types.SimpleNamespace
        self.header = ns(stamp=None, frame_id="")
        self.pose = ns(position=ns(x=0.0, y=0.0, z=0.0), orientation=ns(w=1.0, x=0.0, y=0.0, z=0.0))
        self.scale = ns(x=0.0, y=0.0, z=0.0)
        self.color = ns(r=0.0, g=0.0, b=0.0, a=0.0)


class _MarkerArray:
    def __init__(self):
        self.markers = []


@pytest.fixture()
def ros(monkeypatch):
    class Sync:
        last = None

        def __init__(self, subs, queue):
            self.cb = None
            Sync.last = self

        def registerCallback(self, cb):
            self.cb = cb

    mod = types.ModuleType
    rospy, mf, sm, smm, vm, vmm, rn = (mod(n) for n in (
        "rospy", "message_filters", "sensor_msgs", "sensor_msgs.msg", "visualization_msgs",
        "visualization_msgs.msg", "ros_numpy"))
    rospy.Subscriber, rospy.Publisher = _Sub, _Pub
    mf.Subscriber, mf.TimeSynchronizer = _Sub, Sync
    smm.CameraInfo = smm.Image = smm.PointCloud2 = _Msg
    sm.msg = smm
    vmm.Marker, vmm.MarkerArray = _Marker, _MarkerArray
    vm.msg = vmm
    rn.numpify = lambda msg: msg.arr
    rn.msgify = lambda msg_type, arr, **kw: _Msg(arr)
    rn.point_cloud2 = types.SimpleNamespace(pointcloud2_to_xyz_array=lambda msg: msg.arr)
    for name, m in {"rospy": rospy, "message_filters": mf, "sensor_msgs": sm,
                    "sensor_msgs.msg": smm, "visualization_msgs": vm,
                    "visualization_msgs.msg": vmm, "ros_numpy": rn}.items():
        monkeypatch.setitem(sys.modules, name, m)
    return Sync


def _drive(node, sync, params, occ=None, n_frames=2):
    p = np.asarray(SMALL.proj_matrix(), np.float64)
    node._on_info(_Msg(P=p.ravel().tolist(), width=SMALL.width, height=SMALL.height))
    rope = SyntheticRope()
    node._on_init_nodes(_Msg(arr=rope.nodes(0.0, params.M)))
    if occ is not None:
        node._on_occlusion_mask(_Msg(arr=occ))
    for i in range(n_frames):
        rgb, depth = render_frame(rope, i / 15.0, SMALL, rope_pixel_radius=3)
        sync.last.cb(_Msg(arr=rgb), _Msg(arr=depth))
    return node


def _xyz(msg):
    return np.stack([msg.arr["x"], msg.arr["y"], msg.arr["z"]], axis=-1)


@pytest.mark.parametrize("occluded", [False, True])
def test_port_node_publishes_what_the_jax_node_publishes(ros, occluded):
    from trackdlo_tpu.io.ros_adapter import RosTrackerNode as JaxNode
    from trackdlo_tpu_torch.io.ros_adapter import RosTrackerNode

    params = SMALL_PARAMS
    occ = None
    if occluded:
        occ = np.full((SMALL.height, SMALL.width), 255, np.uint8)
        occ[:, : SMALL.width // 2] = 0
    jnode = _drive(JaxNode(params), ros, params, occ)
    tnode = _drive(RosTrackerNode(params, device="cpu"), ros, params, occ)
    assert tnode.tracker.device.type == "cpu"
    pubs = ("pub_results_pc", "pub_filtered_pc", "pub_img", "pub_results_marker",
            "pub_guide_nodes", "pub_corr_priors")
    for name in pubs:
        got, want = getattr(tnode, name), getattr(jnode, name)
        assert got.topic == want.topic
        assert len(got.published) == len(want.published) == 1, name
    for a, b in zip(tnode.pub_results_pc.published, jnode.pub_results_pc.published):
        assert a.header.stamp == b.header.stamp == 123
        assert np.abs(_xyz(a) - _xyz(b)).max() <= STEP_TOL_M
    for a, b in zip(tnode.pub_filtered_pc.published, jnode.pub_filtered_pc.published):
        assert len(a.arr) == len(b.arr) > 0
        assert np.abs(_xyz(a) - _xyz(b)).max() <= 1e-6
    for name in ("pub_guide_nodes", "pub_corr_priors"):
        for a, b in zip(getattr(tnode, name).published, getattr(jnode, name).published):
            assert len(a.arr) == len(b.arr)
    for a, b in zip(tnode.pub_results_marker.published, jnode.pub_results_marker.published):
        assert len(a.markers) == len(b.markers) == 2 * params.M - 1
        assert [m.ns for m in a.markers] == [m.ns for m in b.markers]
    for a, b in zip(tnode.pub_img.published, jnode.pub_img.published):
        assert a.arr.shape == b.arr.shape == (SMALL.height, SMALL.width, 3)


def test_port_node_defaults_to_the_card(ros):
    import torch

    from trackdlo_tpu_torch.io.ros_adapter import RosTrackerNode

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    params = live_params(max_points=256, downsample_cell_px=2)
    node = RosTrackerNode(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _drive(node, ros, params, n_frames=1)
