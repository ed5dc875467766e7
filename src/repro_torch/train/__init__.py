"""LM training of the port: the train step and checkpoints (port of
``repro.train``)."""
