"""The LSTM language models, the port's counterparts of ``examples/rnn/``."""
