"""Scale paths of the port.

Only ``stats.py`` is ported: the streamed column moments, correlations and
rank transform of ``transmogrifai_tpu/parallel/stats.py``, on one device.
The reference's meshes, multi-host runtime and sharded sweeps
(``parallel/{mesh,distributed,spec_partition,sweep}.py``) wait for the
multi-GPU port through ``torch.distributed`` (ROADMAP Queue 1 item 9).
"""
