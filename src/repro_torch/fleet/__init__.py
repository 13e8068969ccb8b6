"""Fleet serve path: worker pool, control plane and the fused serve loop."""
