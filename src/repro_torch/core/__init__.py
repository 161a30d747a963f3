"""Control-plane algorithms the serving path needs: GBP-CR placement, GCA
cache allocation, chain composition with a tuned c, and the queueing
bounds the tuner minimises.  Framework-free copies of the JAX package's
``core`` modules."""
from .cache_alloc import Allocation
from .chains import Chain
from .classes import DEFAULT_CLASS, RequestClass
from .servers import Server, ServiceSpec
from .tuning import compose_best_effort

__all__ = [
    "Allocation", "Chain", "DEFAULT_CLASS", "RequestClass", "Server",
    "ServiceSpec", "compose_best_effort",
]
