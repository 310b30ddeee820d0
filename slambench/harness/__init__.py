"""The benchmark's yardstick: inputs, the run, its reduction to metrics
and the comparison that decides ``correct``. Nothing here imports the
program at module level; ``runner`` imports it inside the run."""
