"""Ops of the port: each kernel's wrapper with its plain version beside it."""
