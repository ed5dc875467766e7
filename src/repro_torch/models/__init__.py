"""LM stack of the port: common blocks, attention, Mamba, MoE, the stack."""
