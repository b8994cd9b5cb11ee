"""Request refusal errors (counterpart of mxnet_tpu/serving/batcher.py:64
and :70). The dynamic batcher itself is not ported yet."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["RequestRejected", "ServerClosed"]


class RequestRejected(MXNetError):
    """The request was refused without being computed (queue full under
    the `reject` policy, evicted under `drop_oldest`, or submitted
    while the server is draining)."""


class ServerClosed(RequestRejected):
    """The server is closed or draining; no new work accepted. `server`
    names the refusing server/engine when known."""

    def __init__(self, msg, server=None):
        super().__init__(msg)
        self.server = server
