"""Keypoints and descriptors (port of `pctpu/features/__init__.py`): the
names the reference exports here, apart from those that are also the
names of this package's modules (`fpfh`, `fpfh_dense`), which come from
their modules, so that `from pctpu_torch.features import fpfh_dense`
stays the module."""
from pctpu_torch.features.fpfh_dense import normals_radius_dense  # noqa: F401
from pctpu_torch.features.harris import (  # noqa: F401
    HarrisResult, harris3d_keypoints, harris6d_keypoints, intensity_gradients,
    rgb_to_intensity)
from pctpu_torch.features.iss import ISSResult, iss_keypoints  # noqa: F401
from pctpu_torch.features.matching import Matches, match_features  # noqa: F401
from pctpu_torch.features.nms import radius_nms, top_k_mask  # noqa: F401
from pctpu_torch.features.shot import shot352  # noqa: F401
from pctpu_torch.features.sift3d import (  # noqa: F401
    SIFT3DResult, sift3d_keypoints)
