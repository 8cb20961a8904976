"""Models of the port: the dense decoder LM and its layers."""
