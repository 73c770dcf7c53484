"""Geometry library: raymaps, poses, pointmaps, alignment, smoothing.

Port of ``aether_tpu/geometry``, exporting the same names. The device pieces
(raymap codec, ray casting, pointmap lifting, scale fitting, depth edges) are
torch; the cold-path pieces that the reference also keeps on the host (SVD
alignment, SLERP/Kalman pose smoothing) are copies of the JAX package's numpy
modules, in float64.
"""

from aether_tpu_torch.geometry.alignment import (  # noqa: F401
    align_camera_extrinsics,
    align_rigid,
    apply_transformation,
)
from aether_tpu_torch.geometry.edges import depth_edge  # noqa: F401
from aether_tpu_torch.geometry.rays import (  # noqa: F401
    fov_to_focal,
    get_intrinsics,
    get_pixel,
    get_rays,
    project,
)
from aether_tpu_torch.geometry.raymap import (  # noqa: F401
    camera_pose_to_raymap,
    postprocess_pointmap,
    raymap_to_poses,
)
from aether_tpu_torch.geometry.smoothing import (  # noqa: F401
    adaptive_pose_smoothing,
    detect_static_sequence,
    interpolate_poses,
    slerp,
    smooth_poses,
    smooth_trajectory,
)
from aether_tpu_torch.geometry.transforms import (  # noqa: F401
    compute_scale,
    depth_to_disparity,
    disparity_to_depth,
    signed_log1p,
    signed_log1p_inverse,
)
