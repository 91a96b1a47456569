"""Training pieces of the port: the single-device train step."""
