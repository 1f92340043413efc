"""Probes run on the card: ``python -m csm_torch.scripts.<name>``."""
