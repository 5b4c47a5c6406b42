"""obs of the PyTorch port: the drift observatory (see the package docstring)."""
