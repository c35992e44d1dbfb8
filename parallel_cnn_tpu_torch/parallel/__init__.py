"""Data and model parallelism (the port of ``parallel_cnn_tpu/parallel``):
the rank's mesh (mesh.py), the launcher of a world of ranks
(distributed.py), the bucketed collectives (collectives.py), and the
LeNet-ref steps over the data axis (data_parallel.py) and the (data,
model) mesh (intra_op.py), and the zoo's model-axis placement for JAX's
GSPMD path (zoo_sharding.py). The hierarchical ring and pipeline stages
come with later slices."""
