"""Plain PyTorch references the benchmark compares the port with; they import
nothing of the program."""
