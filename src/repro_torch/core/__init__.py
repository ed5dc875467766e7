"""Core simulator of the port (mirrors ``repro.core``)."""
