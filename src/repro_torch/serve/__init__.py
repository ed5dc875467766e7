"""Batched serving of the port's LM stack."""
