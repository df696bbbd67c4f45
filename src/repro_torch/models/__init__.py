"""The port's language models (``repro.models`` counterparts): layers,
attention and the model stack of the dense family."""
