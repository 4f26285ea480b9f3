"""Training of the port: step, loop, checkpoints (``nylon_amt_tpu/train``)."""
