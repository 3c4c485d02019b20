"""metrics of the PyTorch port (see the module docstrings)."""
