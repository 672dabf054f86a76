"""Model zoo of the port (counterpart of ``repro.models``): the dense decoder
so far."""
from repro_torch.models.model import Model, build  # noqa: F401
