"""Operator tooling of the port — the reference's utils/ scripts, ROS-free
(counterpart of trackdlo_tpu/tools).

- :mod:`color_picker` — HSV threshold analysis/tuning (utils/color_picker.py)
- :mod:`mask_preview` — segmentation-mask preview (utils/mask.py)
- :mod:`simulate_occlusion` — occlusion-mask injection, programmatic or
  interactive (utils/simulate_occlusion.py, simulate_occlusion_eval.py)
- :mod:`record` — sequence recorder (utils/collect_pointcloud.py)
- :mod:`render_results` — overlay arbitrary result trajectories on frames
  (utils/tracking_result_img_from_pointcloud_topic.py)
- :mod:`live_view` — the RViz surfaces drawn per frame (rviz/tracking.rviz)
- :mod:`serve` — the TCP tracker service and its replay client
"""
