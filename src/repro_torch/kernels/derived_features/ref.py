"""Plain PyTorch version of derived_features: the enrichment oracle
``repro_torch.core.enrich.derive_ref``."""
from repro_torch.core.enrich import derive_ref as derived_features_ref  # noqa: F401
