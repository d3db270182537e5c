"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
frozen copies of the port's plain paths.  Imports nothing of the port."""
