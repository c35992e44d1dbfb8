"""Gradient buckets (the port of ``parallel_cnn_tpu/parallel``; the
collectives themselves come with the data-parallel slice)."""
