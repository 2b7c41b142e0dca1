"""Origin ("back-to-source") clients, keyed by URL scheme: ``file://``
(and bare paths) and ``http://`` / ``https://`` on the standard library."""

from .client import (  # noqa: F401
    SourceRequest, SourceResponse, ResourceClient,
    register_client, client_for, content_length, supports_range, download,
    close_clients,
)
from . import file_client, http_client  # noqa: F401
