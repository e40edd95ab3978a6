"""Runtime layer: the in-process topic bus (the node, TF graph and
parameter store are not ported yet)."""
from .bus import Publisher, QoSProfile, Subscription, TopicBus, qos_from_name
