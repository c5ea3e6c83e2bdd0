"""Data loading, tokenization, folds and packing of the port: its own copies
of tst.data's jax-free modules, and a numpy packer (``packing``)."""
