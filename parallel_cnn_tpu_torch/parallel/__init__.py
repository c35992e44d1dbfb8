"""Data and model parallelism (the port of ``parallel_cnn_tpu/parallel``):
the rank's mesh (mesh.py), the launcher of a world of ranks
(distributed.py), the bucketed collectives (collectives.py), and the
LeNet-ref steps over the data axis (data_parallel.py) and the (data,
model) mesh (intra_op.py), the zoo's model-axis placement for JAX's
GSPMD path (zoo_sharding.py), and the pipeline's 1F1B tables, stage split
and wire buffers (pipeline.py). The hierarchical ring comes with a later
slice."""
