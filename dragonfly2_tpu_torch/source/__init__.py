"""Origin ("back-to-source") clients, keyed by URL scheme: ``file://``
(and bare paths), ``http://`` / ``https://``, ``s3://`` (with
``s3+http://`` / ``s3+https://``), ``gs://``, ``oras://``, ``hdfs://``
and ``memory://``, all on the standard library; a source plugin
(``common/plugins.py``) registers more. ``client.walk`` lists a tree for
recursive downloads."""

from .client import (  # noqa: F401
    SourceRequest, SourceResponse, ResourceClient, ListEntry,
    register_client, client_for, content_length, supports_range, download,
    close_clients, walk,
)
from . import (file_client, http_client, memory_client,  # noqa: F401
               gcs_client, s3_client, hdfs_client, oras_client)
