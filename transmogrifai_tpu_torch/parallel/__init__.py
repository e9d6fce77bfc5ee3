"""Scale paths of the port, on one device.

``stats.py``: the streamed column moments, correlations and rank transform
of ``transmogrifai_tpu/parallel/stats.py``.  ``sweep.py``: the fold masks
and the logistic grid sweep of ``transmogrifai_tpu/parallel/sweep.py``
(``sharded_logistic_sweep``, its validation errors on K-AE).  The
reference's meshes, multi-host runtime and sharded launchers
(``parallel/{mesh,distributed,spec_partition}.py``, the grid sharding of
``sweep.py``) wait for the multi-GPU port through ``torch.distributed``
(ROADMAP Queue 1 item 7): a mesh of several devices raises.
"""
