"""Distributed runtime pieces of the port: the fault-tolerance monitor
(``monitor``) and the pod-axis pipeline schedule (``pipeline``), emulated
on one device."""
