"""The LM substrate of the port: the decoder (GQA or MLA attention, Mamba or RWKV-6 mixers; dense, MoE or
RWKV channel-mix FFN), prefill and decode."""
from .transformer import Model, build_segments  # noqa: F401
