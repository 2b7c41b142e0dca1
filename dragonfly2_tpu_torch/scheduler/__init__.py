"""The scheduler: cluster state, parent scoring and the RPC service that
places each downloading peer on parents."""

from .server import Scheduler, SchedulerConfig  # noqa: F401
