"""Command-line entry points: ``python -m pdanet_tpu_torch.tools.train`` and
``python -m pdanet_tpu_torch.tools.test``."""
