"""Optimizer and learning-rate schedule (the port of ``repro.optim``):
AdamW with global-norm clipping (``adamw``) and linear warmup + cosine
decay (``schedule``). Gradient compression (``repro.optim.compression``)
is ROADMAP §1 item 14c."""
