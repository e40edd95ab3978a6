"""PointcloudPreprocessorNode: the node/API layer over the engine on the card.

Port of ``autodriver_pointcloud_preprocessor_tpu/runtime/node.py`` (the
reference), with the same parameters, callback order and reconfigure
protocol. The reference's own parity notes follow.

Capability parity with the reference node (reference:
pointcloud_preprocessor.py:120-1063): same ~60 parameter names and defaults
(:129-199), same topic surface (PointCloud2 in/out), QoS selection
(:324-335), TF resolution with static caching (:704-760), header override
semantics (:628-641), the 0-subscriber short-circuit (:645), per-stage
timing keys, PCD saving (:1010-1022), frame counting, and the full dynamic
reconfigure protocol (:817-1004) including its validation behaviors
(bad ROI length rejected :955-957, unknown params rejected :1001-1002).

Differences by design:
* the engine runs on ``device`` (default ``cuda:0`` through
  ``core.scan.resolve_device``; it raises without a card unless the caller
  asks for the CPU), with the hand-written CUDA kernels on the card.
  ``use_gpu`` (and the ``cpu_backend``/``gpu_backend`` selectors) are
  accepted and reported, and move the engine nowhere: the device is the
  constructor's.
* transport is the in-process TopicBus unless a ROS adapter wires real
  rclpy pub/sub around this class (runtime/bus.py docstring).
* per-scan visualization opens no window; with
  ``visualize.save_visualizer_image`` it renders top-down PNGs via
  matplotlib when available.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.codec import pointcloud_to_dict, soa_to_structured
from ..core.fields import FIELD_DTYPE_MAP
from ..core.msg import (
    Header,
    Marker,
    MarkerArray,
    PointCloud2,
    PointField,
    Time,
    make_pointcloud2,
)
from ..core.timing import (
    ThrottledWarner,
    get_current_time,
    get_time_difference,
)
from ..core.codec import build_pointfields
from ..models.preprocessor import Preprocessor
from .bus import TopicBus, qos_from_name
from .params import Parameter, ParameterStore, SetParametersResult
from .tf import (
    ConnectivityException,
    ExtrapolationException,
    LookupException,
    TransformBuffer,
)

__all__ = ["PointcloudPreprocessorNode"]

_IDENTITY16 = [1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
               0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]

#: (name, default) for every declared parameter, matching reference
#: pointcloud_preprocessor.py:129-199 order and values.
PARAMETER_DEFAULTS = [
    ("input_topic", "/velodyne_front/velodyne_points"),
    ("output_topic", "/lidar1/velodyne_points/processed"),
    ("qos", "SENSOR_DATA"),
    ("pointcloud_fields", []),
    ("queue_size", 1),
    ("use_gpu", False),
    ("cpu_backend", "torch"),
    ("gpu_backend", "open3d"),
    ("robot_frame", ""),
    ("static_camera_to_robot_tf", True),
    ("transform_timeout", 0.1),
    ("offset_pointcloud_matrix", _IDENTITY16),
    ("offset_pointcloud_frame", ""),
    ("organize_cloud", False),
    ("save_pointcloud", False),
    ("pointcloud_save_directory", "./pointclouds/"),
    ("pointcloud_save_prepend_str", ""),
    ("pointcloud_save_extension", ".pcd"),
    ("pointcloud_save_ascii", False),
    ("pointcloud_save_compressed", False),
    ("remove_duplicates", True),
    ("remove_nans", True),
    ("remove_infs", True),
    ("crop_to_roi", True),
    ("crop_to_roi.invert", False),
    ("roi_min", [-60.0, -60.0, -20.0]),
    ("roi_max", [60.0, 60.0, 20.0]),
    ("voxel_size", 0.01),
    ("remove_statistical_outliers", False),
    ("remove_statistical_outliers.nb_neighbors", 20),
    ("remove_statistical_outliers.std_ratio", 2.0),
    # extensions beyond the reference surface (its declared TODOs made real)
    ("remove_radius_outliers", False),
    ("remove_radius_outliers.nb_points", 16),
    ("remove_radius_outliers.search_radius", 0.05),
    ("downsample_method", "voxel"),
    ("downsample.sampling_ratio", 0.5),
    ("downsample.every_k_points", 5),
    ("downsample.num_samples", 4096),
    ("downsample.max_points", 0),
    ("downsample.pre_voxel_capacity", 0),
    ("voxel_first_attrs", True),
    ("remove_ground.method", "ransac"),
    ("remove_ground.before_neighborhood", False),
    ("remove_ground.before_voxel", False),
    ("estimate_normals", True),
    ("estimate_normals.search_radius", 0.1),
    ("estimate_normals.max_neighbors", 30),
    ("remove_ground", False),
    ("remove_ground.distance_threshold", 0.2),
    ("remove_ground.ransac_number", 5),
    ("remove_ground.num_iterations", 100),
    ("remove_ground.probability", 0.99),
    # performance knob: RANSAC hypothesis vote on a strided subsample (0 = every
    # point); winner refit + inlier mask always full-N (ops/ground.py)
    ("remove_ground.score_subsample", 0),
    # declared-but-DEAD in the reference (:184-185, :985-988); real here:
    # ground_plane is the live device plane for remove_ground.method=
    # 'height', and reconfiguring use_height switches the ground method
    # (True -> 'height', False -> 'ransac')
    ("ground_plane", [0.0, 1.0, 0.0, 0.0]),
    ("use_height", True),
    # performance knobs beyond the reference surface (the shipped
    # bench profile is reachable through these; models/presets.py)
    ("knn_method", "auto"),
    ("neighborhood_passes", 2),
    ("window_blocks", [1]),     # int array: one entry per pass, or [n]
    ("knn_kmode", "sweep"),
    ("knn_d2mode", "highest"),
    ("fuse_neighborhood", True),
    ("normals_merge_passes", True),
    ("override_header", False),
    ("override_header.stamp_source", "latest"),
    ("publish_normals_markers", False),
    ("normals_marker_topic", "/normals_markers"),
    ("normals_marker_stride", 50),
    ("normals_marker_length", 0.3),
    ("visualize", False),
    ("visualize.window_name", "Open3D"),
    ("visualize.window_width", 1920),
    ("visualize.window_height", 1080),
    ("visualize.zoom", 0.0),
    ("visualize.front", []),
    ("visualize.lookat", []),
    ("visualize.up", []),
    ("visualize.save_visualizer_image", False),
    ("visualize.visualizer_image_path", "./images"),
]

#: engine-relevant keys forwarded into Preprocessor.config
_ENGINE_KEYS = {
    "remove_duplicates", "remove_nans", "remove_infs",
    "crop_to_roi", "crop_to_roi.invert", "roi_min", "roi_max", "voxel_size",
    "remove_statistical_outliers", "remove_statistical_outliers.nb_neighbors",
    "remove_statistical_outliers.std_ratio",
    "remove_radius_outliers", "remove_radius_outliers.nb_points",
    "remove_radius_outliers.search_radius",
    "downsample_method", "downsample.sampling_ratio",
    "downsample.every_k_points", "downsample.num_samples",
    "downsample.max_points", "downsample.pre_voxel_capacity",
    "voxel_first_attrs",
    "remove_ground.method", "remove_ground.before_neighborhood",
    "remove_ground.before_voxel",
    "estimate_normals", "estimate_normals.search_radius",
    "estimate_normals.max_neighbors",
    "remove_ground", "remove_ground.distance_threshold",
    "remove_ground.ransac_number", "remove_ground.num_iterations",
    "remove_ground.probability", "remove_ground.score_subsample",
    "ground_plane",
    "offset_pointcloud_matrix", "offset_pointcloud_frame",
    "knn_method", "neighborhood_passes", "window_blocks",
    "knn_kmode", "knn_d2mode", "fuse_neighborhood",
    "normals_merge_passes",
}


class PointcloudPreprocessorNode:
    """Subscribe PointCloud2 -> preprocess on the card -> republish.

    ``device``: where the engine runs (default ``cuda:0``; raises without a
    card unless a device is given).
    """

    def __init__(
        self,
        node_name: str = "pointcloud_preprocessor",
        enabled: bool = True,
        parameter_namespace: str = "",
        bus: Optional[TopicBus] = None,
        overrides: Optional[Dict[str, object]] = None,
        profile: bool = False,
        pipelined: bool = False,
        device: torch.device | str | None = None,
    ):
        self.node_name = node_name
        self.logger = logging.getLogger(node_name)
        self._warner = ThrottledWarner(self.logger, period=60.0)
        self.bus = bus if bus is not None else TopicBus()

        # -- parameters (declare + read, reference :128-269) ------------------
        self.params = ParameterStore(parameter_namespace)
        self.parameter_namespace = self.params.namespace
        for name, default in PARAMETER_DEFAULTS:
            value = default
            if overrides and name in overrides:
                value = overrides[name]
            self.params.declare(name, value)

        g = self.params.get
        self.input_topic = g("input_topic")
        self.output_topic = g("output_topic")
        self.qos = g("qos")
        self.pointcloud_fields = g("pointcloud_fields")
        self.queue_size = g("queue_size")
        self.use_gpu = g("use_gpu")
        self.cpu_backend = g("cpu_backend")
        self.gpu_backend = g("gpu_backend")
        self.robot_frame = g("robot_frame")
        self.static_camera_to_robot_tf = g("static_camera_to_robot_tf")
        self.transform_timeout = g("transform_timeout")
        self.offset_pointcloud_frame = g("offset_pointcloud_frame")
        self.organize_cloud = g("organize_cloud")
        self.save_pointcloud = g("save_pointcloud")
        self.pointcloud_save_directory = g("pointcloud_save_directory")
        if self.save_pointcloud:
            os.makedirs(self.pointcloud_save_directory, exist_ok=True)
        if not self.pointcloud_save_directory:
            self.pointcloud_save_directory = "."
        self.pointcloud_save_prepend_str = g("pointcloud_save_prepend_str")
        self.pointcloud_save_extension = g("pointcloud_save_extension")
        self.pointcloud_save_ascii = g("pointcloud_save_ascii")
        self.pointcloud_save_compressed = g("pointcloud_save_compressed")
        self.remove_nans = g("remove_nans")
        self.remove_infs = g("remove_infs")
        self.override_header = g("override_header")
        if self.override_header:
            self.new_header_data = {
                "frame_id": self.robot_frame,
                "stamp_source": g("override_header.stamp_source"),
            }
        self.visualize = g("visualize")
        self.visualizer_options = {
            "save_visualizer_image": bool(g("visualize.save_visualizer_image")),
            "visualizer_image_path": str(g("visualize.visualizer_image_path")) or ".",
        }
        if self.visualize and self.visualizer_options["save_visualizer_image"]:
            os.makedirs(self.visualizer_options["visualizer_image_path"], exist_ok=True)

        # -- engine -----------------------------------------------------------
        #: pipelined=True overlaps scan N's device work/egress with scan
        #: N+1's ingest: outputs publish one callback later (adds one scan
        #: of latency, removes the per-scan device sync from the callback)
        self.pipelined = pipelined
        self._pending = None  # (resolver, source msg) awaiting egress
        self.engine = Preprocessor(self._engine_config(), profile=profile, device=device)
        self.processing_times = self.engine.processing_times  # shared dict

        # -- TF ---------------------------------------------------------------
        self.tf_buffer = TransformBuffer()
        self.camera_to_robot_tf: Optional[np.ndarray] = None

        # -- message-schema cache (reference :317-319) ------------------------
        self.pointcloud_metadata: Optional[dict] = None
        self.pointfields: Optional[List[PointField]] = None
        self.point_offset: Optional[int] = None
        self.new_dtype = None
        self.reset_fields = False
        self.frame_count = 0
        self.latest_output: Optional[PointCloud2] = None

        self.publish_normals_markers = g("publish_normals_markers")

        # -- transport --------------------------------------------------------
        self.qos_profile = qos_from_name(self.qos, self.queue_size)
        self.enabled = enabled
        if self.enabled:
            self.params.add_on_set_parameters_callback(self.parameter_change_callback)
            self.pointcloud_sub = self.bus.create_subscription(
                self.input_topic, self.callback, self.qos_profile
            )
            self.pointcloud_pub = self.bus.create_publisher(
                self.output_topic, self.qos_profile
            )
            self.normals_marker_pub = self.bus.create_publisher(
                g("normals_marker_topic"), self.qos_profile
            )
            self.logger.info(
                "%s node started on device: %s", self.node_name,
                _device_name(self.engine.device),
            )

    # ------------------------------------------------------------------ config

    def _engine_config(self) -> Dict[str, object]:
        return {k: self.params.get(k) for k, _ in PARAMETER_DEFAULTS if k in _ENGINE_KEYS}

    # --------------------------------------------------------------- hot path

    def callback(self, ros_cloud: PointCloud2) -> None:
        """Per-scan hot path (reference :643-702): extract -> preprocess ->
        prepare -> publish -> save -> visualize; errors drop the scan."""
        if self.pointcloud_pub.get_subscription_count() == 0:
            return
        try:
            callback_start = get_current_time(monotonic=False)
            soa = self.extract_pointcloud(ros_cloud)
            if soa is None:
                return

            # TF lookup (cached when static, reference :704-732)
            start = get_current_time(monotonic=True)
            self.get_camera_to_robot_tf(
                self.pointcloud_metadata["header"].frame_id,
                self.pointcloud_metadata["header"].stamp.to_float(),
            )
            self.processing_times["tf_lookup"] = get_time_difference(
                start, get_current_time(monotonic=True)
            )

            if self.pipelined:
                resolver = self.engine.process_soa_async(
                    soa, self.pointcloud_metadata
                )
                pending, self._pending = self._pending, (resolver, ros_cloud)
                if pending is None:
                    return  # first scan: nothing to publish yet
                prev_resolver, ros_cloud = pending
                out_soa, self.pointcloud_metadata = prev_resolver()
            else:
                out_soa, self.pointcloud_metadata = self.engine.process_soa(
                    soa, self.pointcloud_metadata
                )

            start = get_current_time(monotonic=True)
            processed_struct = self.prepare_pointcloud(ros_cloud, out_soa)
            new_header = self.create_header(ros_cloud)
            pc_msg = make_pointcloud2(
                processed_struct,
                self.pointfields,
                header=new_header,
                is_dense=ros_cloud.is_dense and self.remove_nans and self.remove_infs,
            )
            self.processing_times["pointcloud_msg_parsing"] = get_time_difference(
                start, get_current_time(monotonic=True)
            )

            start = get_current_time(monotonic=True)
            self.pointcloud_pub.publish(pc_msg)
            self.latest_output = pc_msg
            self.processing_times["pointcloud_pub"] = get_time_difference(
                start, get_current_time(monotonic=True)
            )

            pcd_number = str(self.frame_count).zfill(8)
            self.pointcloud_saver(pcd_number, out_soa)
            self.pointcloud_visualizer(pcd_number, out_soa)
            self.publish_normals_marker_array(out_soa, new_header)

            self.frame_count += 1
            self.processing_times["total_callback_time"] = get_time_difference(
                callback_start, get_current_time(monotonic=False)
            )
        except Exception as e:  # reference :701-702: log and drop the scan
            self.logger.error("Error processing point cloud: %s", e)

    def extract_pointcloud(self, ros_cloud: PointCloud2):
        """Message -> SoA dict + metadata (reference :394-445)."""
        try:
            start = get_current_time(monotonic=True)
            field_names = self.pointcloud_fields if self.pointcloud_fields else None
            soa, self.pointcloud_metadata = pointcloud_to_dict(
                ros_cloud,
                field_names,
                self.remove_nans,
                self.organize_cloud,
                self.pointcloud_metadata,
            )
        except Exception as e:
            self.logger.error(
                "Failed to convert PointCloud2 message to numpy: %s", e
            )
            return None

        if soa["positions"].size == 0:
            self.logger.warning("Received an empty PointCloud. Skipping...")
            return None
        if not {"x", "y", "z"}.issubset(self.pointcloud_metadata["field_names"]):
            self.logger.error("Incoming PointCloud does not have x, y, z fields.")
            return None

        self.processing_times["ros_to_numpy"] = get_time_difference(
            start, get_current_time(monotonic=True)
        )
        # reference key parity (:421-422): the reference clears its reused
        # Open3D cloud object here. The functional ScanBuffer design has no
        # persistent device cloud to clear, so the stage genuinely costs
        # nothing — the key is emitted (as 0) so timing-dict consumers see
        # the full reference key set (core/timing.REFERENCE_STAGE_KEYS).
        self.processing_times["point_clearing"] = 0.0
        return soa

    def get_camera_to_robot_tf(self, source_frame_id: str, timestamp=None) -> None:
        """Resolve robot_frame <- cloud frame, cached when static (:704-732)."""
        if self.camera_to_robot_tf is not None and self.static_camera_to_robot_tf:
            return
        if not self.robot_frame:
            return
        try:
            matrix = self.tf_buffer.lookup_transform(
                self.robot_frame, source_frame_id, timestamp, self.transform_timeout
            )
        except LookupException as e:
            self.logger.error("TF Lookup Error: %s", e)
            return
        except ConnectivityException as e:
            self.logger.error("TF Connectivity Error: %s", e)
            return
        except ExtrapolationException as e:
            self.logger.error("TF Extrapolation Error: %s", e)
            return
        self.camera_to_robot_tf = matrix
        self.engine.set_tf_matrix(matrix)

    def set_fields(self, ros_cloud: PointCloud2) -> None:
        """Build the output PointField schema once (reference :546-574)."""
        orig_names = [f.name for f in ros_cloud.fields]
        orig_types = [f.datatype for f in ros_cloud.fields]
        self.new_dtype = [
            (name, FIELD_DTYPE_MAP[t]) for name, t in zip(orig_names, orig_types)
        ]
        if self.params.get("estimate_normals"):
            orig_names += ["normal_x", "normal_y", "normal_z"]
            orig_types += [PointField.FLOAT32] * 3
            self.new_dtype += [
                ("normal_x", np.float32),
                ("normal_y", np.float32),
                ("normal_z", np.float32),
            ]
        self.pointfields, self.point_offset = build_pointfields(orig_names, orig_types)
        self.reset_fields = False

    def prepare_pointcloud(self, ros_cloud: PointCloud2, out_soa) -> np.ndarray:
        """Device output -> structured array for publishing (:576-625)."""
        if self.pointfields is None or self.reset_fields:
            self.set_fields(ros_cloud)
        out = soa_to_structured(
            out_soa,
            self.pointcloud_metadata,
            self.new_dtype,
            include_normals=self.pointcloud_metadata.get("has_normals", False),
        )
        # throttled missing-field warning (reference :806-807, 60 s throttle):
        # schema fields that no SoA attribute backs are zero-filled silently
        # by the codec; surface that once a minute per field.
        provided = {"x", "y", "z", "rgb", "normal_x", "normal_y", "normal_z"}
        for name, arr in out_soa.items():
            if arr is None or name in ("positions", "rgb", "normals"):
                continue
            provided.add(
                self.pointcloud_metadata.get(f"{name}_field_name") or name
            )
        for field in out.dtype.names:
            if field not in provided:
                self._warner.warn(
                    f"missing_field:{field}",
                    f"output field '{field}' has no backing attribute in the "
                    "processed cloud; publishing zeros",
                )
        return out

    def create_header(self, ros_cloud: PointCloud2, frame_id=None) -> Header:
        """Frame override + stamp source semantics (reference :628-641)."""
        new_header = Header(stamp=ros_cloud.header.stamp, frame_id=ros_cloud.header.frame_id)
        if frame_id is None:
            if (
                self.camera_to_robot_tf is not None
                and self.robot_frame
                and self.robot_frame != ros_cloud.header.frame_id
            ):
                new_header.frame_id = self.robot_frame
        if self.override_header:
            if self.new_header_data["stamp_source"].lower() == "latest":
                new_header.stamp = Time.now()
        return new_header

    # ------------------------------------------------------------ aux outputs

    def pointcloud_saver(self, pcd_number: str, out_soa) -> None:
        """Frame-numbered PCD/PLY writing (reference :1010-1022)."""
        if not self.save_pointcloud:
            return
        from ..io.pcd import write_point_cloud

        ext = self.pointcloud_save_extension.strip(".")
        path = os.path.join(
            self.pointcloud_save_directory,
            f"{self.pointcloud_save_prepend_str}{pcd_number}.{ext}",
        )
        write_point_cloud(
            path,
            out_soa,
            ascii=self.pointcloud_save_ascii,
            compressed=self.pointcloud_save_compressed,
        )

    def _view_projection(self, pos: np.ndarray):
        """Camera basis from the visualize.front/lookat/up/zoom parameters
        (Open3D ViewControl semantics, reference :337-367, :1024-1050):
        orthographic projection onto the (right, up) plane of a camera whose
        front vector points from the scene toward the camera; zoom scales
        the view extent (smaller = closer). Returns (sx, sy, depth, half)."""
        front = np.asarray(
            self.params.get("visualize.front") or (0.0, 0.0, 1.0), float
        )
        up = np.asarray(self.params.get("visualize.up") or (0.0, 1.0, 0.0), float)
        lookat_param = self.params.get("visualize.lookat")
        lookat = (
            np.asarray(lookat_param, float)
            if lookat_param
            else pos.mean(axis=0)
        )
        zoom = float(self.params.get("visualize.zoom")) or 1.0

        f = front / max(np.linalg.norm(front), 1e-12)
        r = np.cross(up, f)
        if np.linalg.norm(r) < 1e-9:  # up parallel to front: pick any right
            r = np.cross((1.0, 0.0, 0.0), f)
            if np.linalg.norm(r) < 1e-9:
                r = np.cross((0.0, 1.0, 0.0), f)
        r = r / np.linalg.norm(r)
        u2 = np.cross(f, r)

        rel = pos - lookat
        sx, sy, depth = rel @ r, rel @ u2, rel @ f
        extent = pos.max(axis=0) - pos.min(axis=0) if len(pos) else np.ones(3)
        half = max(float(np.linalg.norm(extent)) * 0.5 * zoom, 1e-6)
        return sx, sy, depth, half

    def pointcloud_visualizer(self, pcd_number: str, out_soa) -> None:
        """Headless stand-in for the Open3D window (reference :1024-1050):
        per-frame PNG rendering honoring the declared view parameters
        (visualize.front/lookat/up/zoom/window_width/window_height)."""
        if not self.visualize:
            return
        if not self.visualizer_options["save_visualizer_image"]:
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            self.logger.warning("matplotlib unavailable; cannot save visualizer image")
            return
        pos = out_soa["positions"]
        sx, sy, depth, half = self._view_projection(pos)
        w = int(self.params.get("visualize.window_width") or 1920)
        h = int(self.params.get("visualize.window_height") or 1080)
        fig, ax = plt.subplots(figsize=(w / 240.0, h / 240.0))
        ax.scatter(sx, sy, s=0.2, c=depth, cmap="viridis")
        ax.set_xlim(-half, half)
        ax.set_ylim(-half * h / max(w, 1), half * h / max(w, 1))
        ax.set_aspect("equal")
        ax.set_title(str(self.params.get("visualize.window_name") or ""))
        fig.savefig(
            os.path.join(
                self.visualizer_options["visualizer_image_path"],
                f"{self.pointcloud_save_prepend_str}{pcd_number}.png",
            )
        )
        plt.close(fig)

    def publish_normals_marker_array(self, out_soa, header) -> None:
        """Publish normals as ARROW markers (the reference declared this
        capability as an empty stub, pointcloud_preprocessor.py:814-815,
        with visualization_msgs in package.xml:13)."""
        if not self.publish_normals_markers:
            return
        normals = out_soa.get("normals")
        if normals is None:
            return
        stride = max(int(self.params.get("normals_marker_stride")), 1)
        length = float(self.params.get("normals_marker_length"))
        pos = out_soa["positions"][::stride]
        nrm = normals[::stride]
        markers = [
            Marker(
                header=header,
                ns="normals",
                id=i,
                type=Marker.ARROW,
                points=[tuple(p), tuple(p + length * v)],
            )
            for i, (p, v) in enumerate(zip(pos, nrm))
        ]
        self.normals_marker_pub.publish(MarkerArray(markers=markers))

    # -------------------------------------------------------------- reconfigure

    def set_parameters(self, params: List[Parameter]) -> List[SetParametersResult]:
        """Public reconfigure entry (rclpy set_parameters analog)."""
        return self.params.set_parameters(params)

    def set_parameters_atomically(
        self, params: List[Parameter]
    ) -> SetParametersResult:
        """All-or-nothing reconfigure: the whole list reaches the callback
        in ONE invocation, so coupled statics (``neighborhood_passes`` +
        a per-pass ``window_blocks`` tuple) can change together."""
        return self.params.set_parameters_atomically(params)

    def parameter_change_callback(self, params: List[Parameter]) -> SetParametersResult:
        """Live update of nearly every parameter (reference :817-1004).

        Where the reference re-creates rclpy subscriptions (and documents
        the destroy race, :27), the bus supports clean destroy+create.
        """
        result = SetParametersResult(successful=True)
        ns = self.parameter_namespace
        # engine-config changes are collected and applied as ONE batch
        # after the loop: coupled statics (a per-pass window_blocks tuple
        # and neighborhood_passes) can then change together in a single
        # set_parameters call, like rclpy's atomic parameter sets
        engine_delta: Dict[str, object] = {}
        for param in params:
            name = param.name[len(ns):] if param.name.startswith(ns) else param.name
            value = param.value
            if name == "input_topic":
                if value != self.input_topic:
                    self.pointcloud_sub.destroy()
                    self.input_topic = value
                    if self.pointcloud_metadata:
                        self.pointcloud_metadata.pop("has_intensity", None)
                    self.pointcloud_sub = self.bus.create_subscription(
                        self.input_topic, self.callback, self.qos_profile
                    )
            elif name == "output_topic":
                if value != self.output_topic:
                    self.pointcloud_pub.destroy()
                    self.output_topic = value
                    if self.pointcloud_metadata:
                        self.pointcloud_metadata.pop("has_intensity", None)
                    self.pointcloud_pub = self.bus.create_publisher(
                        self.output_topic, self.qos_profile
                    )
            elif name == "use_gpu":
                # reference probes CUDA (:857-881); the engine's device is
                # the constructor's — accept the flag, report reality.
                self.use_gpu = bool(value)
                if self.use_gpu:
                    self.logger.info(
                        "use_gpu accepted; engine runs on %s",
                        _device_name(self.engine.device),
                    )
            elif name == "cpu_backend":
                self.cpu_backend = value
            elif name == "gpu_backend":
                self.gpu_backend = value
            elif name == "robot_frame":
                if str(value).lower() != str(self.robot_frame).lower():
                    self.camera_to_robot_tf = None
                    self.engine.set_tf_matrix(None)
                self.robot_frame = value
                if hasattr(self, "new_header_data"):
                    self.new_header_data["frame_id"] = value
            elif name == "static_camera_to_robot_tf":
                self.static_camera_to_robot_tf = value
            elif name == "transform_timeout":
                self.transform_timeout = value
            elif name == "offset_pointcloud_matrix":
                if len(value) != 16:
                    result.successful = False
                    result.reason = "offset matrix must have 16 elements"
                else:
                    engine_delta["offset_pointcloud_matrix"] = list(value)
            elif name == "offset_pointcloud_frame":
                self.offset_pointcloud_frame = value
                engine_delta["offset_pointcloud_frame"] = value
            elif name == "organize_cloud":
                self.organize_cloud = value
            elif name == "save_pointcloud":
                self.save_pointcloud = value
                if value:
                    os.makedirs(self.pointcloud_save_directory, exist_ok=True)
            elif name == "pointcloud_save_directory":
                self.pointcloud_save_directory = value
            elif name == "pointcloud_save_prepend_str":
                self.pointcloud_save_prepend_str = value
            elif name == "pointcloud_save_extension":
                self.pointcloud_save_extension = value
            elif name == "pointcloud_save_ascii":
                self.pointcloud_save_ascii = value
            elif name == "pointcloud_save_compressed":
                self.pointcloud_save_compressed = value
            elif name in ("remove_duplicates", "remove_nans", "remove_infs",
                          "crop_to_roi", "crop_to_roi.invert", "voxel_size",
                          "remove_statistical_outliers",
                          "remove_statistical_outliers.nb_neighbors",
                          "remove_statistical_outliers.std_ratio",
                          "remove_radius_outliers",
                          "remove_radius_outliers.nb_points",
                          "remove_radius_outliers.search_radius",
                          "downsample_method", "downsample.sampling_ratio",
                          "downsample.every_k_points", "downsample.num_samples",
                          "remove_ground.method", "remove_ground.before_neighborhood",
                          "remove_ground.before_voxel",
                          "estimate_normals.search_radius",
                          "estimate_normals.max_neighbors",
                          "remove_ground", "remove_ground.distance_threshold",
                          "remove_ground.ransac_number",
                          "remove_ground.num_iterations",
                          "remove_ground.probability",
                          "remove_ground.score_subsample",
                          "knn_method", "neighborhood_passes",
                          "window_blocks", "knn_kmode", "knn_d2mode",
                          "fuse_neighborhood", "normals_merge_passes",
                          "voxel_first_attrs"):
                if name in ("remove_nans", "remove_infs"):
                    setattr(self, name, value)
                engine_delta[name] = value
            elif name in ("downsample.max_points",
                          "downsample.pre_voxel_capacity"):
                # the kernels' buckets are 512-multiple capacities; that is
                # an internal constraint, not part of the reference-shaped
                # parameter surface — accept ANY non-negative value and
                # round UP internally (settings_from_config), logging the
                # effective capacity. Only negatives are rejected.
                if int(value) >= 0:
                    engine_delta[name] = int(value)
                    eff = -(-int(value) // 512) * 512
                    if eff != int(value):
                        self.logger.info(
                            "%s=%d rounded up to the effective capacity "
                            "%d (512-aligned buckets)",
                            name, int(value), eff,
                        )
                else:
                    result.successful = False
                    result.reason = f"{name} must be >= 0"
            elif name in ("roi_min", "roi_max"):
                if len(value) == 3:
                    engine_delta[name] = list(value)
                else:
                    result.successful = False
                    result.reason = "ROI min/max must be of length 3"
            elif name == "estimate_normals":
                engine_delta[name] = value
                self.reset_fields = True  # output schema changes (:966-970)
                if not value and self.pointcloud_metadata:
                    self.pointcloud_metadata.pop("has_normals", None)
            elif name == "ground_plane":
                # dead in the reference (:985-986); LIVE here: the plane is
                # a device param consumed by remove_ground.method='height'
                # (ops.remove_ground_by_height) — reconfigure moves the cut
                # without a new pipeline
                if len(value) == 4:
                    engine_delta["ground_plane"] = list(value)
                else:
                    result.successful = False
                    result.reason = "ground_plane must be [a, b, c, d]"
            elif name == "use_height":
                # dead in the reference (:987-988); here an explicit
                # reconfigure switches the ground-removal method (True ->
                # fixed-plane height cut against ground_plane, False ->
                # RANSAC). Only an explicit set flips it — the declared
                # default (True, matching the reference) does not override
                # remove_ground.method at startup.
                engine_delta["remove_ground.method"] = (
                    "height" if value else "ransac"
                )
            elif name == "override_header":
                self.override_header = value
                if value:
                    self.new_header_data = {
                        "frame_id": self.robot_frame,
                        "stamp_source": self.params.get("override_header.stamp_source"),
                    }
            elif name == "override_header.stamp_source":
                if hasattr(self, "new_header_data"):
                    self.new_header_data["stamp_source"] = value
            elif name == "publish_normals_markers":
                self.publish_normals_markers = value
            elif name in ("normals_marker_topic", "normals_marker_stride",
                          "normals_marker_length"):
                pass  # read from the store on use
            elif name == "visualize":
                self.visualize = value
            elif name.startswith("visualize."):
                key = name.split(".", 1)[1]
                if key in self.visualizer_options:
                    self.visualizer_options[key] = value
            elif name in ("qos", "pointcloud_fields", "queue_size"):
                setattr(self, name if name != "pointcloud_fields" else "pointcloud_fields", value)
            else:
                result.successful = False  # unknown param (:1001-1002)
            self.logger.info(
                "Success = %s for param %s to value %s", result.successful, param.name, value
            )
        if engine_delta and result.successful:
            # one atomic engine update, gated on the whole batch being
            # valid: if any param in the batch already failed (e.g. a bad
            # roi length), the parameter store rolls back every value, so
            # the engine must stay untouched too or config and declared
            # params diverge (all-or-nothing contract of
            # set_parameters_atomically). Engine-side validation failures
            # (e.g. a window_blocks tuple whose length mismatches
            # neighborhood_passes) are rolled back by the engine
            # (Preprocessor.update_config) and reported, leaving the
            # previous configuration live
            try:
                self.engine.update_config(engine_delta)
            except (ValueError, TypeError) as e:
                result.successful = False
                result.reason = str(e)
                self.logger.error("engine reconfigure rejected: %s", e)
        return result

    def flush_pipeline(self) -> None:
        """Pipelined mode: publish the final in-flight scan."""
        if self._pending is None:
            return
        resolver, ros_cloud = self._pending
        self._pending = None
        out_soa, self.pointcloud_metadata = resolver()
        processed_struct = self.prepare_pointcloud(ros_cloud, out_soa)
        pc_msg = make_pointcloud2(
            processed_struct,
            self.pointfields,
            header=self.create_header(ros_cloud),
            is_dense=ros_cloud.is_dense and self.remove_nans and self.remove_infs,
        )
        self.pointcloud_pub.publish(pc_msg)
        self.latest_output = pc_msg
        self.frame_count += 1

    def destroy_node(self) -> None:
        if self.enabled:
            self.pointcloud_sub.destroy()
            self.pointcloud_pub.destroy()


def _device_name(device: torch.device) -> str:
    """The engine's device, with the card's name on CUDA."""
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)
