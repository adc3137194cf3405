"""PyTorch + CUDA port of the DFA telemetry pipeline (single-shard slice).

The package mirrors ``repro``'s layout (``configs``, ``core``,
``kernels/<family>``, ``models``, ``data``) and imports neither JAX nor
the reference package. Entry point:
:class:`repro_torch.core.pipeline.DFASystem`, which runs on the CUDA card
by default (``device="cpu"`` runs the plain PyTorch versions of every
kernel, which is what the differential tests do).
"""
