"""Command-line entry points: ``python -m canonswap_torch.cli.main``."""
