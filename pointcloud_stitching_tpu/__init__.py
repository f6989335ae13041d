"""pointcloud_stitching_tpu — multi-camera point-cloud stitching on an accelerator.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
``conix-center/pointcloud_stitching`` (C++/PCL/librealsense): N depth-camera
streams → deprojection → per-camera SE(3) extrinsics → fusion → voxel
downsample → live stitched cloud, with on-device brute-force-NN ICP for
registration refinement. See SURVEY.md for the layer-by-layer mapping.
"""

from .utils.types import DistortionModel, Intrinsics, PointCloud
from . import ops

__version__ = "0.1.0"

__all__ = ["DistortionModel", "Intrinsics", "PointCloud", "ops", "__version__"]
