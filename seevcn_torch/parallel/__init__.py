"""Data and model parallelism across processes (port of
seevcn_tpu/parallel/): the process-group bring-up (``distributed``), the
cross-process merges (``collectives``), the (``dp``, ``mp``) mesh with the
cross-rank reductions that make a world-W train step the world-1 step on
the same global batch (``mesh``), and the BEV map's W split over the
``mp`` axis with its halo exchanges (``spatial``)."""
