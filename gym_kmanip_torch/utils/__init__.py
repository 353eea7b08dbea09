"""Host and tensor utilities of the PyTorch port."""
