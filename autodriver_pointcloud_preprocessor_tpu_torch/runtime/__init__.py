"""Runtime layer: node API, parameter store, topic bus, TF graph."""
from .bus import Publisher, QoSProfile, Subscription, TopicBus, qos_from_name
from .node import PointcloudPreprocessorNode
from .params import Parameter, ParameterStore, ParameterType, SetParametersResult
from .tf import (
    ConnectivityException,
    ExtrapolationException,
    LookupException,
    TransformBuffer,
    transform_to_matrix,
)
