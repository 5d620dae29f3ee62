"""ray_tpu_torch.client: thin-client proxy mode (`ray_tpu_torch.init("ray://...")`).

reference parity: python/ray/util/client — a remote driver connects to a
proxy server inside the cluster over ONE connection; the proxy hosts the
actual core-worker state and translates client calls into the core API
(client worker.py / server/proxier.py). Use it when the driver machine
can reach only the proxy, not every node's RPC endpoints.
"""

from ray_tpu_torch.client.server import ClientProxyServer, serve_forever  # noqa: F401
from ray_tpu_torch.client.worker import (ClientActorHandle,  # noqa: F401
                                   ClientContext, ClientObjectRef,
                                   connect)

__all__ = ["ClientProxyServer", "serve_forever", "connect",
           "ClientContext", "ClientObjectRef", "ClientActorHandle"]
