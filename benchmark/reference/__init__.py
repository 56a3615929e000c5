"""Plain PyTorch references of what the timed paths compute; they import nothing of the program."""
