"""FL models (``nn.Module``) and the model registry."""
