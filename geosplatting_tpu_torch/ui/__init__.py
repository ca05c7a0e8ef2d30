"""Console UI (counterpart of ``geosplatting_tpu/ui``)."""
from .console import console  # noqa: F401
