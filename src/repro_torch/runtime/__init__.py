"""The tiered decode step of the port."""
