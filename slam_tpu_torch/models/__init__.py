"""Pipeline stages: frontend odometry, bundle adjustment, pose graph,
loop closure. The track store is shared with the JAX package
(``slam_tpu.models.trackstore``)."""
