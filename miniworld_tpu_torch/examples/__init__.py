"""Runnable examples of the port (``python -m miniworld_tpu_torch.examples.train_a2c``)."""
