"""The scheduler: cluster state, parent scoring and the RPC service that
places each downloading peer on parents."""
