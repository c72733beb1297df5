"""Command-line entry points of the port (``python -m neuralampmodelercore_tpu_torch.cli.<tool>``)."""
