"""The reference LeNet model (the port of ``parallel_cnn_tpu/models``)."""
