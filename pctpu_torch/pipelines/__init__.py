"""End-to-end pipelines of the port: the SLAM loop (`odometry`) and the
registration-dataset driver (`registration_driver`)."""
