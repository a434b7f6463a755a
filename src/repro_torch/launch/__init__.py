"""Launch helpers of the PyTorch port (so far: building a device mesh)."""
