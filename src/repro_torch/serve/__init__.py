"""Serving: prefill + batched decode steps."""
from .decode import generate, make_prefill, make_serve_step  # noqa: F401
