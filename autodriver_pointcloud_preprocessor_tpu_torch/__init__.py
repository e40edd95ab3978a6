"""autodriver_pointcloud_preprocessor_tpu_torch: the PyTorch + CUDA port.

The same LiDAR preprocessing pipeline as the JAX package
``autodriver_pointcloud_preprocessor_tpu`` (the reference), with the same
``ScanBuffer`` contract, configuration surface and stage semantics, run
eagerly in PyTorch. The reference's Pallas TPU kernels are replaced by
hand-written CUDA C++ kernels for Hopper (``csrc/``), each with a plain
PyTorch version of the same contract beside it that CPU tensors use.
``io`` carries the data path around the pipeline: PCAP and UDP packet
sources, PCD/PLY/KITTI files, the compressed-cloud codec, and the
``StreamingEngine`` that decodes packets, runs the pipeline and quantizes
on the device; its host loops are C++ sidecars (``native/``). ``runtime``
carries the node layer (``PointcloudPreprocessorNode``, its parameter
store and TF graph, the topic bus), ``parallel`` the multi-LiDAR
concatenator, and ``cli`` the console commands.

This package never imports ``jax``.
"""

__version__ = "0.1.0"

from . import convert, core, io, models, ops, parallel, runtime
from .core import ScanBuffer
from .models import Preprocessor
from .runtime import PointcloudPreprocessorNode

__all__ = [
    "convert",
    "core",
    "io",
    "models",
    "ops",
    "parallel",
    "runtime",
    "ScanBuffer",
    "Preprocessor",
    "PointcloudPreprocessorNode",
    "__version__",
]
