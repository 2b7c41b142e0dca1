"""Per-task piece storage on local disk."""
