"""Drivers of the measured window, one module a kind, found by the
``driver`` key of a traffic file."""
