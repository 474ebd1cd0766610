"""Logging, input checks, z-projection and table parity helpers."""
