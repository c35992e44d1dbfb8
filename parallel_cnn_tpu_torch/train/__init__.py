"""Training: steps, epoch loops and checkpoints (the port of
``parallel_cnn_tpu/train``)."""
