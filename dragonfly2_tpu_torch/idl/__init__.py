"""Wire messages: dataclass registry and the messages this slice uses."""
