"""Native (C++) host-side parsing, built at first use (see loader.py)."""
