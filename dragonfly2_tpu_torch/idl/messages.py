"""The wire messages this slice uses.

Counterpart of ``dragonfly2_tpu/idl/messages.py``: same class names, same
field names, same defaults, so one field dict builds either package's
message. ``DeviceSink`` describes a device-memory placement target for a
download; ``ShardManifest`` names the tensors of a sharded checkpoint.
"""

from __future__ import annotations

import enum

from .base import message


class TaskType(enum.IntEnum):
    STANDARD = 0       # downloaded file, GC-able
    PERSISTENT = 1     # dfcache import: pinned until deleted
    PERSISTENT_CACHE = 2


class Priority(enum.IntEnum):
    LEVEL0 = 0  # highest
    LEVEL1 = 1
    LEVEL2 = 2
    LEVEL3 = 3
    LEVEL4 = 4
    LEVEL5 = 5
    LEVEL6 = 6  # lowest


@message
class UrlMeta:
    """Download-relevant metadata; participates in the task id."""

    digest: str = ""                 # "sha256:..." expected digest of whole file
    tag: str = ""                    # task isolation tag
    range: str = ""                  # "bytes=a-b" sub-range request
    filtered_query_params: list[str] | None = None
    header: dict | None = None       # extra origin request headers
    application: str = ""
    priority: Priority = Priority.LEVEL0
    tenant: str = ""
    qos_class: str = ""
    # comma-joined names of the manifest shards this host needs ("" = the
    # whole task); not part of the task id
    shards: str = ""


@message
class PieceInfo:
    piece_num: int = 0
    range_start: int = 0
    range_size: int = 0
    digest: str = ""               # per-piece "crc32:..." / "md5:..."
    download_cost_ms: int = 0      # filled by downloader when reporting


@message
class ShardInfo:
    """One named array shard of a sharded task: a contiguous byte range of
    the content plus the array geometry it is viewed with on the device.
    ``digest`` is an OPTIONAL whole-shard digest checked at task finalize."""

    name: str = ""                   # e.g. "layers.17.mlp.w1"
    range_start: int = 0             # byte offset within the content
    range_size: int = 0
    dtype: str = "uint8"             # dtype string for the tensor view
    shape: list[int] | None = None   # tensor shape; None = flat bytes
    digest: str = ""                 # optional "sha256:..." of the shard


@message
class ShardManifest:
    """A sharded task's shard table. Shards are disjoint contiguous ranges;
    gaps are legal (unnamed bytes still ride the task, they just never
    become named tensors)."""

    shards: list[ShardInfo] | None = None


@message
class DeviceSink:
    """Optional terminal sink describing how verified bytes land in device
    memory."""

    enabled: bool = False
    dtype: str = "uint8"
    shard_index: int = 0
    shard_count: int = 1
    donate: bool = True
    pipeline_shards: int = 0       # copy units per device; 0 = auto (~32MiB each)


@message
class DownloadRequest:
    url: str = ""
    output: str = ""                # abs path; "" = stream/cache only
    url_meta: UrlMeta | None = None
    timeout_s: float = 0.0
    rate_limit_bps: int = 0
    disable_back_source: bool = False
    recursive: bool = False
    recursive_concurrency: int = 8
    keep_original_offset: bool = False
    device_sink: DeviceSink | None = None
    task_type: TaskType = TaskType.STANDARD
    # sharded tasks: the checkpoint's shard table. With a manifest the
    # daemon maps pieces -> shards as they verify and hands each complete
    # shard to the device sink incrementally.
    shard_manifest: ShardManifest | None = None


@message
class DownloadResponse:
    task_id: str = ""
    peer_id: str = ""
    completed_length: int = 0
    content_length: int = -1
    done: bool = False
    output: str = ""                # echo of where this entry landed (recursive)
    code: int = 0
    message: str = ""
    # sharded tasks: a ``shard_ready`` progress frame — this named shard's
    # bytes all verified and (with a device sink) its copy is enqueued
    shard: str = ""
    shard_src: str = ""
    shards_ready: int = 0
    shards_total: int = 0
