from pctpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, multihost_init, shard_batch, replicated)
from pctpu_torch.parallel.pair_sweep import (  # noqa: F401
    batched_icp, batched_icp_mega, make_pair_sweep, make_full_pipeline_sweep)
from pctpu_torch.parallel.point_shard import make_point_sharded_icp  # noqa: F401
from pctpu_torch.parallel.posegraph import (  # noqa: F401
    optimize_pose_graph, optimize_pose_graph_sparse,
    optimize_pose_graph_sparse_f64,
    make_sharded_pose_graph_step, make_sharded_pose_graph_step_sparse,
    PoseGraphResult)
from pctpu_torch.parallel.halo import (  # noqa: F401
    make_halo_nearest, partition_by_axis)
