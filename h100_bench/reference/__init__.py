"""The plain reference: PyTorch and NumPy only, nothing of the program."""
