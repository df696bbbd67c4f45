"""The port's language models (``repro.models`` counterparts): layers,
attention, the xLSTM blocks and the model stack of the dense and ssm
families."""
