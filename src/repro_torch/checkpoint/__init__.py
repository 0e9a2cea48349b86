from .checkpointer import AsyncCheckpointer, latest_step, prune_old, restore, save  # noqa: F401
