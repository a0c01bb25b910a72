"""Parallelism (counterpart of ``automodel_tpu/parallel/``): the mesh sizes, process-group
init, and ring (context-parallel) attention over the ``cp`` axis."""
