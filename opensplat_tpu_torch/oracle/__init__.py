"""NumPy conformance oracle (host side): the CLI's --oracle-check."""
