"""Several sequences on one device and the mesh paths (port of
``ur_mvo_tpu.parallel``): :class:`~ur_mvo_tpu_torch.parallel.multi_seq.MultiSequenceVO`,
``mesh`` (process groups and the 1-D ``DeviceMesh``), ``dist_ba`` (the
sharded global BA) and ``dist_matching`` (the sharded batched matcher)."""
