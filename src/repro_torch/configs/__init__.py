"""Architecture registry: ``--arch <id>`` selects one of the ported archs."""
from repro_torch.configs.registry import ARCHS, ArchDef, get_arch  # noqa: F401
