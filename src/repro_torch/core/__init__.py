"""Core of the port: the function-block registry."""
