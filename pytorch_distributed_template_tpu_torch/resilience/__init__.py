"""Fault injection for the port's training path (``faults``)."""
