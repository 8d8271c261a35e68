"""The LM stack's serving path (the port of ``repro.models``): configs'
dataclass, layers, attention, MoE, Mamba-2, blocks and the model's init,
prefill and decode, over the reference's stacked parameter tree."""
