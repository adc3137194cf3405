"""Optimizer and learning-rate schedule (the port of ``repro.optim``):
AdamW with global-norm clipping (``adamw``), linear warmup + cosine
decay (``schedule``) and int8 error-feedback gradient compression over
emulated ranks (``compression``)."""
