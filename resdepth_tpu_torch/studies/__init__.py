"""Studies that measure the port (run as modules)."""
