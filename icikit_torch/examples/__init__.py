"""Runnable examples of the port (``python -m icikit_torch.examples.NAME``)."""
