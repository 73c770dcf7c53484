"""Applications of the PyTorch port: the inference demo CLI."""
