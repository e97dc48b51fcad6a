"""Render backend package of the port (layer L1)."""
