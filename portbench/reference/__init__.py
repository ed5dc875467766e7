"""The plain reference of the benchmark: NumPy only."""
