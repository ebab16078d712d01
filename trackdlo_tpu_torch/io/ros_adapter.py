"""Optional thin ROS1 adapter of the port.

Counterpart of trackdlo_tpu/io/ros_adapter.py, on the port's ``Tracker``
(its step one CUDA graph on the card), with the same topics and messages.

The core framework is ROS-free by design (BASELINE.json: "ROS node plumbing
is replaced by a framework-agnostic Python API"); this adapter reproduces the
reference node's topic surface for drop-in use on a robot:

- subscribes synchronized ``rgb_topic`` + ``depth_topic``
  (message_filters.TimeSynchronizer, trackdlo_node.cpp:614-616),
  ``camera_info_topic`` (once), ``/trackdlo/init_nodes`` (once), and
  ``/mask_with_occlusion`` (trackdlo_node.cpp:596-601);
- publishes ``/trackdlo/results_pc``, ``/trackdlo/results_marker``,
  ``/trackdlo/guide_nodes``, ``/trackdlo/corr_priors``,
  ``/trackdlo/filtered_pointcloud``, and ``/trackdlo/results_img``
  (trackdlo_node.cpp:603-612).

Import requires rospy (imported when the node is made); everything else in
the package works without it. The tracker runs on ``device`` (the CUDA card
unless the caller names the CPU); its outputs come back to the host for the
messages.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class RosTrackerNode:  # covered by tests/test_ros_adapter.py with stubbed ROS
    def __init__(
        self,
        params,
        rgb_topic="/camera/color/image_raw",
        depth_topic="/camera/aligned_depth_to_color/image_raw",
        camera_info_topic="/camera/aligned_depth_to_color/camera_info",
        result_frame_id="camera_color_optical_frame",
        device=None,
    ):
        import message_filters
        import rospy
        from sensor_msgs.msg import CameraInfo, Image, PointCloud2

        self.rospy = rospy
        self.params = params
        self.device = device
        self.result_frame_id = result_frame_id
        self.tracker = None
        self.state = None
        self.intrinsics = None
        self.init_nodes = None
        self.occlusion_mask = None

        self._info_sub = rospy.Subscriber(camera_info_topic, CameraInfo, self._on_info)
        self._init_sub = rospy.Subscriber(
            "/trackdlo/init_nodes", PointCloud2, self._on_init_nodes
        )
        rospy.Subscriber("/mask_with_occlusion", Image, self._on_occlusion_mask)

        from visualization_msgs.msg import MarkerArray

        self.pub_results_pc = rospy.Publisher(
            "/trackdlo/results_pc", PointCloud2, queue_size=30
        )
        self.pub_filtered_pc = rospy.Publisher(
            "/trackdlo/filtered_pointcloud", PointCloud2, queue_size=30
        )
        self.pub_img = rospy.Publisher("/trackdlo/results_img", Image, queue_size=30)
        # Diagnostic topics (trackdlo_node.cpp:455-458, 503-508, 603-612):
        # guide nodes and correspondence priors are published specifically so
        # tracking failures can be diagnosed live in RViz.
        self.pub_results_marker = rospy.Publisher(
            "/trackdlo/results_marker", MarkerArray, queue_size=30
        )
        self.pub_guide_nodes = rospy.Publisher(
            "/trackdlo/guide_nodes", PointCloud2, queue_size=30
        )
        self.pub_corr_priors = rospy.Publisher(
            "/trackdlo/corr_priors", PointCloud2, queue_size=30
        )

        rgb_sub = message_filters.Subscriber(rgb_topic, Image)
        depth_sub = message_filters.Subscriber(depth_topic, Image)
        sync = message_filters.TimeSynchronizer([rgb_sub, depth_sub], 10)
        sync.registerCallback(self._on_frame)

    # -- one-shot wiring ---------------------------------------------------
    def _on_info(self, msg):
        from trackdlo_tpu_torch.config import CameraIntrinsics

        p = np.array(msg.P).reshape(3, 4)
        self.intrinsics = CameraIntrinsics(
            fx=p[0, 0], fy=p[1, 1], cx=p[0, 2], cy=p[1, 2],
            width=msg.width, height=msg.height,
        )
        self._info_sub.unregister()

    def _on_init_nodes(self, msg):
        import ros_numpy

        pc = ros_numpy.point_cloud2.pointcloud2_to_xyz_array(msg)
        self.init_nodes = np.asarray(pc, np.float32)
        self._init_sub.unregister()

    def _on_occlusion_mask(self, msg):
        import ros_numpy

        self.occlusion_mask = ros_numpy.numpify(msg)

    # -- per-frame ---------------------------------------------------------
    def _on_frame(self, rgb_msg, depth_msg):
        import ros_numpy

        if self.intrinsics is None:
            return
        rgb = ros_numpy.numpify(rgb_msg)
        depth = ros_numpy.numpify(depth_msg)

        if self.tracker is None:
            from trackdlo_tpu_torch.models.trackdlo import Tracker

            self.tracker = Tracker(self.params, self.intrinsics, device=self.device)
            if self.init_nodes is not None:
                self.state = self.tracker.init_from_nodes(self.init_nodes)
            else:
                self.state = self.tracker.init_from_frame(rgb, depth)
            return

        self.state, out = self.tracker.step(
            self.state, rgb, depth, self.occlusion_mask
        )
        self._publish(rgb, rgb_msg.header.stamp, out)

    def _xyz_cloud_msg(self, pts, stamp):
        import ros_numpy
        from sensor_msgs.msg import PointCloud2

        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        cloud = np.zeros(
            len(pts), dtype=[("x", np.float32), ("y", np.float32), ("z", np.float32)]
        )
        cloud["x"], cloud["y"], cloud["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        msg = ros_numpy.msgify(PointCloud2, cloud)
        msg.header.frame_id = self.result_frame_id
        msg.header.stamp = stamp
        return msg

    def _marker_array_msg(self, y, visible, stamp):
        """MarkerArray from viz.geometry_markers dicts
        (MatrixXd2MarkerArray twin, utils.cpp:244-357)."""
        from visualization_msgs.msg import Marker, MarkerArray

        from trackdlo_tpu_torch.utils.viz import geometry_markers

        arr = MarkerArray()
        markers = []
        for i, d in enumerate(
            geometry_markers(y, frame_id=self.result_frame_id, visible=visible)
        ):
            m = Marker()
            m.header.frame_id = self.result_frame_id
            m.header.stamp = stamp
            m.ns = d["ns"]
            m.id = d["id"]
            m.type = Marker.SPHERE if d["type"] == "sphere" else Marker.CYLINDER
            m.action = Marker.ADD
            px, py, pz = d["position"]
            m.pose.position.x, m.pose.position.y, m.pose.position.z = px, py, pz
            qw, qx, qy, qz = d["orientation"]
            m.pose.orientation.w = qw
            m.pose.orientation.x = qx
            m.pose.orientation.y = qy
            m.pose.orientation.z = qz
            m.scale.x, m.scale.y, m.scale.z = d["scale"]
            m.color.r, m.color.g, m.color.b, m.color.a = d["color"]
            markers.append(m)
        arr.markers = markers
        return arr

    def _publish(self, rgb, stamp, out):
        import ros_numpy

        y = _np(out.y)
        # Result nodes: stamped with the input stamp for eval sync
        # (trackdlo_node.cpp:499).
        self.pub_results_pc.publish(self._xyz_cloud_msg(y, stamp))

        # Downsampled input cloud (trackdlo_node.cpp:603 filtered_pointcloud).
        pts_mask = _np(out.points_mask).astype(bool)
        self.pub_filtered_pc.publish(
            self._xyz_cloud_msg(_np(out.points)[pts_mask], stamp)
        )

        # Diagnostic surface: guide nodes from the pre-registration pass and
        # the correspondence priors fed to the main EM
        # (trackdlo_node.cpp:455-458, 503-508).
        n_guide = int(_np(out.guide_count))
        self.pub_guide_nodes.publish(
            self._xyz_cloud_msg(_np(out.guide_nodes)[:n_guide], stamp)
        )
        prior_mask = _np(out.prior_mask).astype(bool)
        self.pub_corr_priors.publish(
            self._xyz_cloud_msg(_np(out.prior_pos)[prior_mask], stamp)
        )

        visible = _np(out.not_self_occluded)
        self.pub_results_marker.publish(self._marker_array_msg(y, visible, stamp))

        from sensor_msgs.msg import Image

        from trackdlo_tpu_torch.utils.viz import draw_tracking_overlay

        overlay = draw_tracking_overlay(
            rgb, y, self.intrinsics.proj_matrix(),
            visible=visible,
            occlusion_mask=self.occlusion_mask,
        )
        self.pub_img.publish(ros_numpy.msgify(Image, overlay, encoding="rgb8"))
