"""Data sources of the port (port of ``repro.data``)."""
