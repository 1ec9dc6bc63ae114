"""Backing-media subsystem of the port (the device catalog so far)."""
