"""Model architectures of the port (WaveNet so far)."""
