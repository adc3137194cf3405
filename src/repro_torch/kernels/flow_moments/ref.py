"""Plain PyTorch version of flow_moments: the reporter's scatter-accumulate
oracle (``repro_torch.core.reporter.accumulate_ref``)."""
from repro_torch.core.reporter import accumulate_ref as flow_moments_ref  # noqa: F401
