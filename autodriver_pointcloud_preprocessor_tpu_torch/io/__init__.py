"""Sources and sinks: file IO, loaders, packet decoding, compression, and
the streaming engine (packets in, compressed clouds out)."""
from .loader import PointcloudLoader, soa_to_pointcloud2
from .pcd import lzf_compress, lzf_decompress, read_point_cloud, write_point_cloud
