"""The benchmark harness of the PyTorch port (see ../README.md)."""
