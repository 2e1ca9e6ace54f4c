"""The dense GQA transformer's serving path in PyTorch."""
