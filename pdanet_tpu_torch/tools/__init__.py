"""Command-line entry points: ``python -m pdanet_tpu_torch.tools.train``,
``.test``, ``.export`` and ``.serve``."""
