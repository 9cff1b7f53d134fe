"""Command-line scripts of the PyTorch port (``python -m
count_pipnet_tpu_torch.scripts.<name>``)."""
