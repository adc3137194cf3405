"""Fault-tolerance runtime pieces of the port (``monitor``)."""
