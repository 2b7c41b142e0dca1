"""The daemon: task conductor, back-source and P2P piece paths, upload
and RPC servers, scheduler session."""
