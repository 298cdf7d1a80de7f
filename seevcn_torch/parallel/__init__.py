"""Data parallelism across processes (port of seevcn_tpu/parallel/): the
process-group bring-up (``distributed``), the cross-process merges
(``collectives``) and the ``dp`` axis of the mesh with the cross-rank
reductions that make a world-W train step the world-1 step on the same
global batch (``mesh``)."""
