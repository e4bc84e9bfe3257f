"""Plain PyTorch and NumPy reference of what the windows compute; it
imports nothing of the program."""
