"""The repo's measuring and tuning scripts, ported: each module keeps the
name of its counterpart in ``scripts/`` and runs as ``python -m
blockpuzzle_tpu_torch.scripts.<name>``."""
