from .io import load_pytree, save_pytree  # noqa: F401
from .manager import CheckpointManager  # noqa: F401
