"""Plain float32 PyTorch reference of what the benchmark measures. It imports
nothing of the measured package."""
