"""The port's language models (``repro.models`` counterparts): layers,
attention, the xLSTM, moe and Mamba2 blocks and the model stack of all six
families."""
