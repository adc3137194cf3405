"""derived_features: standalone per-flow feature derivation (CUDA kernel K5)."""
