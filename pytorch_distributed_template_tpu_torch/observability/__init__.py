"""Logging for the port's entry points."""
