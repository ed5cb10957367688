"""Helpers below every layer of the port (no torch)."""
