"""Coded errors.

Counterpart of ``dragonfly2_tpu/common/errors.py``: the same ``Code``
values, so a failed task reports the same code in both packages.
"""

from __future__ import annotations

import enum


class Code(enum.IntEnum):
    """Wire error codes. Stable values — part of the IDL."""

    OK = 0

    # generic
    UNKNOWN = 1000
    INVALID_ARGUMENT = 1001
    NOT_FOUND = 1002
    ALREADY_EXISTS = 1003
    PERMISSION_DENIED = 1004
    UNAVAILABLE = 1005
    DEADLINE_EXCEEDED = 1006
    RESOURCE_EXHAUSTED = 1007
    INTERNAL = 1008

    # scheduler → peer control verbs
    SCHED_NEED_BACK_SOURCE = 2000   # peer must fetch from origin itself
    SCHED_PEER_GONE = 2001          # peer was evicted; re-register
    SCHED_TASK_STATUS_ERROR = 2002  # task failed upstream
    SCHED_FORBIDDEN = 2003          # blocklisted / over limits
    SCHED_REREGISTER = 2004         # scheduler lost state; register again

    # data-plane
    CLIENT_PEER_BUSY = 2999         # parent at upload concurrency limit; not a failure
    CLIENT_PIECE_DOWNLOAD_FAIL = 3000
    CLIENT_PIECE_NOT_FOUND = 3001
    CLIENT_BACK_SOURCE_ERROR = 3002
    CLIENT_CONTEXT_CANCELED = 3003
    CLIENT_DIGEST_MISMATCH = 3004
    CLIENT_STORAGE_ERROR = 3005

    # origin
    SOURCE_ERROR = 4000
    SOURCE_NOT_FOUND = 4004
    SOURCE_RANGE_UNSUPPORTED = 4005
    SOURCE_AUTH_ERROR = 4006

    # manager / control plane
    MANAGER_STORE_ERROR = 5000
    MANAGER_KEEPALIVE_EXPIRED = 5001


class DFError(Exception):
    """An error carrying a wire ``Code``."""

    def __init__(self, code: Code, message: str = ""):
        super().__init__(message or code.name)
        self.code = Code(code)
        self.message = message or code.name

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"DFError({self.code.name}, {self.message!r})"

    @staticmethod
    def wrap(exc: BaseException, default: Code = Code.UNKNOWN) -> "DFError":
        if isinstance(exc, DFError):
            return exc
        return DFError(default, f"{type(exc).__name__}: {exc}")
