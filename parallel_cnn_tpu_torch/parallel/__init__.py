"""Data parallelism (the port of ``parallel_cnn_tpu/parallel``): the
rank's mesh (mesh.py), the launcher of a world of ranks
(distributed.py) and the bucketed collectives (collectives.py). The
hierarchical ring and the model axis come with later slices."""
