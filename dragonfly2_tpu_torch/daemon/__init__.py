"""The daemon: back-source conductor, piece manager, task manager."""
