"""Optional ROS 2 (rclpy) adapter: run the engine as a real ROS node.

Port of ``autodriver_pointcloud_preprocessor_tpu/ros2_adapter.py`` over the
port's node and bus; the engine runs on ``cuda:0`` (``device`` to change
it).

The engine keeps ROS strictly at the host edges (SURVEY.md layer L4). When
rclpy and sensor_msgs are installed, this module exposes the same topic +
parameter surface as the reference node (reference:
pointcloud_preprocessor.py:120-391) while delegating all processing to
runtime/node.py: ROS messages are converted field-for-field to the wire-
compatible dataclasses in core/msg.py.

Import-guarded: importing this module without ROS raises ImportError with
a clear message; the rest of the framework never touches rclpy.
"""
from __future__ import annotations

try:
    import rclpy
    from rclpy.node import Node as _RosNode
    from sensor_msgs.msg import PointCloud2 as RosPointCloud2
    from sensor_msgs.msg import PointField as RosPointField
    from rclpy.qos import QoSHistoryPolicy, QoSProfile, QoSReliabilityPolicy
except ImportError as e:  # pragma: no cover - exercised only under ROS
    raise ImportError(
        "ros2_adapter requires rclpy + sensor_msgs (a ROS 2 environment); "
        "outside ROS use runtime.PointcloudPreprocessorNode with the "
        "in-process TopicBus instead"
    ) from e

from .core.msg import Header, PointCloud2, PointField, Time
from .runtime.bus import TopicBus
from .runtime.node import PointcloudPreprocessorNode
from .runtime.params import Parameter as EngineParameter, ParameterType


def from_ros(msg: RosPointCloud2) -> PointCloud2:
    """rclpy PointCloud2 -> wire-compatible dataclass (zero re-encode)."""
    return PointCloud2(
        header=Header(
            stamp=Time(msg.header.stamp.sec, msg.header.stamp.nanosec),
            frame_id=msg.header.frame_id,
        ),
        height=msg.height,
        width=msg.width,
        fields=[
            PointField(f.name, f.offset, f.datatype, f.count) for f in msg.fields
        ],
        is_bigendian=msg.is_bigendian,
        point_step=msg.point_step,
        row_step=msg.row_step,
        data=bytes(msg.data),
        is_dense=msg.is_dense,
    )


def to_ros(msg: PointCloud2) -> RosPointCloud2:
    """Wire-compatible dataclass -> rclpy PointCloud2."""
    out = RosPointCloud2()
    out.header.stamp.sec = msg.header.stamp.sec
    out.header.stamp.nanosec = msg.header.stamp.nanosec
    out.header.frame_id = msg.header.frame_id
    out.height = msg.height
    out.width = msg.width
    out.fields = [
        RosPointField(
            name=f.name, offset=f.offset, datatype=f.datatype, count=f.count
        )
        for f in msg.fields
    ]
    out.is_bigendian = msg.is_bigendian
    out.point_step = msg.point_step
    out.row_step = msg.row_step
    out.data = msg.data
    out.is_dense = msg.is_dense
    return out


class RosPointcloudPreprocessor(_RosNode):
    """ROS 2 shell: real DDS topics + parameters around the engine."""

    def __init__(self, node_name: str = "pointcloud_preprocessor",
                 parameter_namespace: str = "", device=None):
        super().__init__(node_name)
        self._bus = TopicBus()
        self.engine_node = PointcloudPreprocessorNode(
            node_name=f"{node_name}_engine",
            bus=self._bus,
            parameter_namespace=parameter_namespace,
            device=device,
        )

        # mirror engine parameters into ROS declared parameters
        for name in self.engine_node.params.names():
            self.declare_parameter(name, self.engine_node.params.get(name, namespaced=False))
        self.add_on_set_parameters_callback(self._on_ros_params)

        qos = QoSProfile(
            reliability=(
                QoSReliabilityPolicy.BEST_EFFORT
                if self.engine_node.qos.lower() == "sensor_data"
                else QoSReliabilityPolicy.RELIABLE
            ),
            history=QoSHistoryPolicy.KEEP_LAST,
            depth=self.engine_node.queue_size,
        )
        self._ros_pub = self.create_publisher(
            RosPointCloud2, self.engine_node.output_topic, qos
        )
        self._ros_sub = self.create_subscription(
            RosPointCloud2, self.engine_node.input_topic, self._on_cloud, qos
        )
        # forward engine output to DDS
        self._bus.create_subscription(
            self.engine_node.output_topic,
            lambda m: self._ros_pub.publish(to_ros(m)),
        )
        # keep the 0-subscriber short-circuit meaningful under DDS
        self.engine_node.pointcloud_pub.get_subscription_count = (
            lambda: self._ros_pub.get_subscription_count()
        )

    def _on_cloud(self, ros_msg: RosPointCloud2) -> None:
        self.engine_node.callback(from_ros(ros_msg))

    def _on_ros_params(self, params):
        from rcl_interfaces.msg import SetParametersResult

        engine_params = [
            EngineParameter(p.name, p.value) for p in params
        ]
        results = self.engine_node.set_parameters(engine_params)
        ok = all(r.successful for r in results)
        reason = "; ".join(r.reason for r in results if r.reason)
        return SetParametersResult(successful=ok, reason=reason)


def main(args=None):  # pragma: no cover - requires ROS runtime
    rclpy.init(args=args)
    node = RosPointcloudPreprocessor()
    try:
        rclpy.spin(node)
    except (KeyboardInterrupt, SystemExit):
        node.get_logger().info("Shutting down node...")
    finally:
        node.destroy_node()
        rclpy.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
