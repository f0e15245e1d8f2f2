"""parallel (PyTorch port)."""
