"""Plain float32 PyTorch references of the benchmark's model families.
They import nothing of the port."""
