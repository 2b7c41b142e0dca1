"""Wire messages: dataclass registry and the messages this slice uses."""

from .base import message, encode, decode, dumps, loads  # noqa: F401
from . import messages  # noqa: F401  (registers all message types)
