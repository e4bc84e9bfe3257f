"""Rule modules self-register on import (see framework.register)."""
from . import (  # noqa: F401
    cuda_kernel,
    device_isolation,
    generator_discipline,
    host_sync_hazard,
    obs_coverage,
    resilience_seams,
    sanitizer_coverage,
)
