"""End-to-end pipelines of the port: the SLAM loop (`odometry`), the
registration-dataset driver (`registration_driver`), ground removal and
object clustering (`segmentation`), the KITTI chain (`kitti_etl`,
`trainset`, `analytics`, `detect`, `kitti_eval`, `kitti_frames`,
`miniworld`) and the clustering harness (`cluster_compare`)."""
