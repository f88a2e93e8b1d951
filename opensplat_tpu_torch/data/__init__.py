"""Project loaders and point-cloud I/O (host side, numpy)."""
