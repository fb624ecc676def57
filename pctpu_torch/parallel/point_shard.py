"""Point-sharded ICP: one large cloud's source points split over the ranks
(port of `pctpu/parallel/point_shard.py`).

The source points are sharded over the mesh's point axis and the target is
replicated (a full KITTI scan is ~1.5 MB; the work is the O(N M)
association). Each rank associates its shard (K1, `ops.knn.nearest`,
where the reference calls `chunked_min_argmin`), takes the weighted
Procrustes moments of it, and one `all_reduce` a iteration sums the 16
floats (sw, sa, sb, H); the 3x3 solve then runs replicated, by the
reference's SVD with the reflection fix:

    H = sum w b a^T - (sum w b)(sum w a)^T / sum w
"""
from __future__ import annotations

import torch

from pctpu_torch.core import se3
from pctpu_torch.device import DeviceLike, f32_square, resolve_device
from pctpu_torch.ops.knn import nearest
from pctpu_torch.parallel.mesh import Mesh, all_reduce, shard_batch


def _local_moments(src_t, src_mask, dst, dst_mask, thresh2: float,
                   query_chunk: int):
    """(sw, sa [3], sb [3], H [3,3]) of one shard: H = sum w b a^T over its
    inlier associations (d2 < thresh2)."""
    d2, idx = nearest(src_t, dst, dst_mask, query_chunk)
    w = (src_mask & (d2 < thresh2)).float()
    b = dst[idx.long()]
    bw = b * w[:, None]
    return (torch.sum(w), torch.sum(src_t * w[:, None], dim=0),
            torch.sum(bw, dim=0), bw.t() @ src_t)


def _solve_from_moments(sw, sa, sb, H):
    """R, t from the summed moments: the SVD of the centred H, its last
    singular direction flipped where det(U V^T) < 0."""
    swc = torch.clamp_min(sw, 1e-12)
    Hc = H - torch.outer(sb, sa) / swc
    U, _, Vt = torch.linalg.svd(Hc)
    d = torch.linalg.det(U @ Vt)
    S = torch.diag(torch.cat([torch.ones(2, dtype=H.dtype, device=H.device),
                              d[None]]))
    R = U @ S @ Vt
    t = sb / swc - R @ (sa / swc)
    return R, t


def make_point_sharded_icp(mesh: Mesh, point_axis: str = "point",
                           iters: int = 30, dist_thresh: float = 5.0,
                           query_chunk: int = 2048,
                           device: DeviceLike = None):
    """f(src, src_mask, dst, dst_mask) -> T [4,4] (src -> dst), `iters`
    fixed iterations from the identity. Every rank passes the whole clouds
    and takes its contiguous block of the source; N must divide by the
    axis size. Runs on CUDA unless `device="cpu"` is asked for."""
    dev = resolve_device(device)
    group = mesh.group(point_axis)
    shard = shard_batch(mesh, point_axis)
    thresh2 = f32_square(dist_thresh)

    def f(src, src_mask, dst, dst_mask):
        src = torch.as_tensor(shard.take(src)).to(dev).float()
        src_mask = torch.as_tensor(shard.take(src_mask)).to(dev)
        dst = torch.as_tensor(dst).to(dev).float()
        dst_mask = torch.as_tensor(dst_mask).to(dev)
        T = torch.eye(4, dtype=torch.float32, device=dev)
        for _ in range(iters):
            src_t = se3.apply_transform(T, src)
            sw, sa, sb, H = _local_moments(src_t, src_mask, dst, dst_mask,
                                           thresh2, query_chunk)
            m = all_reduce(torch.cat([sw[None], sa, sb, H.reshape(9)]),
                           group)
            R, t = _solve_from_moments(m[0], m[1:4], m[4:7],
                                       m[7:].reshape(3, 3))
            T = se3.make_transform(R, t) @ T
        return T

    return f
