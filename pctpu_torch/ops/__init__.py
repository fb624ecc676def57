"""Point-cloud ops (port of `pctpu/ops/__init__.py`): the names the
reference exports here that are not also the names of this package's
modules (`knn`, `fps`, `ball_query`, `eigh3` come from their modules, so
that `from pctpu_torch.ops import ball_query` stays the module)."""
from pctpu_torch.ops.box3d import (  # noqa: F401
    bev_corners, corners3d, iou3d, iou_bev, nms_rotated, points_in_boxes,
    roipool3d)
from pctpu_torch.ops.eigh3 import eigvalsh3  # noqa: F401
from pctpu_torch.ops.gather import (  # noqa: F401
    gather_points, group_points, mask_group)
from pctpu_torch.ops.grid_hash import (  # noqa: F401
    HashGrid, build_grid, grid_knn, grid_nearest, grid_radius)
from pctpu_torch.ops.interpolate import (  # noqa: F401
    interpolation_weights, three_interpolate, three_nn)
from pctpu_torch.ops.knn import (  # noqa: F401
    NeighborSet, nearest, radius_search)
from pctpu_torch.ops.morton import morton_codes, morton_sort  # noqa: F401
from pctpu_torch.ops.normals import (  # noqa: F401
    estimate_normals, neighborhood_covariances, pca, pca_project)
from pctpu_torch.ops.pairwise import (  # noqa: F401
    chunked_min_argmin, pairwise_sqdist)
from pctpu_torch.ops.pallas_banded import build_banded, nearest_banded  # noqa: F401
from pctpu_torch.ops.voxel import (  # noqa: F401
    voxel_downsample, voxel_downsample_cloud)
