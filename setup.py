"""Packaging for autodriver_pointcloud_preprocessor_tpu.

Console entry points mirror the reference's (reference setup.py:63-68
registers pointcloud_preprocessor + pointcloud_compressor) and add the
loader/concatenator commands the reference declared as stubs. The native
sidecars build via ``make -C autodriver_pointcloud_preprocessor_tpu/native``
(optional; numpy fallbacks are wire-identical).

The PyTorch + CUDA port ``autodriver_pointcloud_preprocessor_tpu_torch``
ships its kernel sources (``csrc/*.cu``, ``*.cuh``) and its host sidecars
(``native/*.cc``); they are compiled by nvcc and g++ at first use
(``pip install .[torch]`` for its dependency). Its console commands carry
a ``_torch`` suffix (``pointcloud_preprocessor_torch`` and so on).
"""
from setuptools import find_packages, setup

setup(
    name="autodriver_pointcloud_preprocessor_tpu",
    version="0.1.0",
    description=(
        "TPU-native LiDAR point-cloud preprocessing framework "
        "(JAX/XLA): crop, voxel, outlier removal, normals, RANSAC ground "
        "segmentation, multi-LiDAR concat, PCAP replay, compression"
    ),
    packages=find_packages(exclude=("tests",)),
    package_data={
        "autodriver_pointcloud_preprocessor_tpu.native": ["*.cc", "Makefile", "*.so"],
        "autodriver_pointcloud_preprocessor_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
        "autodriver_pointcloud_preprocessor_tpu_torch.native": ["*.cc"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={
        "test": ["pytest", "scipy"],
        "viz": ["matplotlib"],
        "torch": ["torch"],
    },
    entry_points={
        "console_scripts": [
            "pointcloud_preprocessor = autodriver_pointcloud_preprocessor_tpu.cli:preprocessor_main",
            "pointcloud_compressor = autodriver_pointcloud_preprocessor_tpu.cli:compressor_main",
            "pointcloud_loader = autodriver_pointcloud_preprocessor_tpu.cli:loader_main",
            "pointcloud_concatenator = autodriver_pointcloud_preprocessor_tpu.cli:concatenator_main",
            "pointcloud_warmup = autodriver_pointcloud_preprocessor_tpu.cli:warmup_main",
            "pointcloud_preprocessor_torch = autodriver_pointcloud_preprocessor_tpu_torch.cli:preprocessor_main",
            "pointcloud_compressor_torch = autodriver_pointcloud_preprocessor_tpu_torch.cli:compressor_main",
            "pointcloud_loader_torch = autodriver_pointcloud_preprocessor_tpu_torch.cli:loader_main",
            "pointcloud_concatenator_torch = autodriver_pointcloud_preprocessor_tpu_torch.cli:concatenator_main",
            "pointcloud_warmup_torch = autodriver_pointcloud_preprocessor_tpu_torch.cli:warmup_main",
        ],
    },
)
