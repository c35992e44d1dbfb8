"""The port's analysis package (the counterpart of
``parallel_cnn_tpu/analysis/``): the named hardware roofline profiles
(``hw_profiles``), the cost report's file format (``cost_model``) and the
plan autotuner (``autotune``) that ranks the parallelism-plan space
against a profile and writes the chosen plan into the report.

Import-light: nothing here imports torch at module scope, so ``tune`` and
``--autotune`` resolve a plan in a process that never touches a GPU.
"""
