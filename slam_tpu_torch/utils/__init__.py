"""Synthetic scenes (numpy). Metrics are shared with the JAX package
(``slam_tpu.utils.metrics``)."""
