"""flash_attention: causal (or full) softmax attention forward (CUDA kernel K6)."""
