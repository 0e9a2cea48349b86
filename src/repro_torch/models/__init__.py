"""The LM substrate of the port: dense GQA decoder, prefill and decode."""
from .transformer import Model, build_segments  # noqa: F401
