"""Token-mixer backends; importing the package registers them."""
from repro_torch.mixers import gla  # noqa: F401  (registers "gla")
from repro_torch.mixers import linear  # noqa: F401  (registers "linear")
from repro_torch.mixers import mamba2  # noqa: F401  (registers "mamba2")
from repro_torch.mixers import softmax  # noqa: F401  (registers "softmax")
from repro_torch.mixers.base import AttentionBackend, get_backend, \
    register_backend, registered_backends, resolve_backend_name

__all__ = ["AttentionBackend", "get_backend", "register_backend",
           "registered_backends", "resolve_backend_name"]
