"""RPC transport: length-prefixed frames over asyncio streams.

Counterpart of ``dragonfly2_tpu/rpc``: the same service and method names,
the same four call kinds and the same message bytes, over a transport of
the standard library's (the card's machine has no ``grpc``).
"""

from .server import RPCServer, ServiceDef  # noqa: F401
from .client import Channel, ChannelPool, ServiceClient, RPCError  # noqa: F401
from .balancer import HashRing  # noqa: F401
