"""Data and model parallelism (the port of ``parallel_cnn_tpu/parallel``):
the rank's mesh (mesh.py), the launcher of a world of ranks
(distributed.py), the bucketed collectives (collectives.py), and the
LeNet-ref steps over the data axis (data_parallel.py) and the (data,
model) mesh (intra_op.py). The hierarchical ring, pipeline stages and
JAX's GSPMD zoo path come with later slices."""
