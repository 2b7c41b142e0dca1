"""Origin ("back-to-source") clients, keyed by URL scheme. This slice
registers ``file://`` (and bare paths)."""

from .client import (  # noqa: F401
    SourceRequest, SourceResponse, ResourceClient,
    register_client, client_for, download,
)
from . import file_client  # noqa: F401
