"""Origin ("back-to-source") clients, keyed by URL scheme: ``file://``
(and bare paths), ``http://`` / ``https://`` and ``s3://`` (with
``s3+http://`` / ``s3+https://``) on the standard library; a source
plugin (``common/plugins.py``) registers more."""

from .client import (  # noqa: F401
    SourceRequest, SourceResponse, ResourceClient, ListEntry,
    register_client, client_for, content_length, supports_range, download,
    close_clients,
)
from . import file_client, http_client, s3_client  # noqa: F401
