"""The LM substrate of the port: the decoder (GQA or MLA attention, dense or MoE FFN), prefill and decode."""
from .transformer import Model, build_segments  # noqa: F401
