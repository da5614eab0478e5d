"""Batched device codec ops of the PyTorch port."""
