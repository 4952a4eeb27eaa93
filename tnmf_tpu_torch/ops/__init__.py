"""Conv-NMF operators of the PyTorch port."""
