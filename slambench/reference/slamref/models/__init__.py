"""Pipeline stages: frontend odometry, bundle adjustment, pose graph,
loop closure, and the track store (a numpy copy of the JAX package's)."""
