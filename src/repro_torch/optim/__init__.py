"""Optimiser of the port: AdamW, learning-rate schedules and int8
error-feedback gradient compression (port of ``repro.optim``)."""
