"""repro_torch.hetero — the integer-hash draw family of ``repro.hetero``
(the compute-time models and the async engine come in a later slice)."""
from repro_torch.hetero.models import (hetero_hash, hetero_normal,  # noqa: F401
                                       hetero_uniform)
