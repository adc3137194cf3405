"""flow_moments: per-flow Table-I register accumulation (CUDA kernel K4)."""
