"""Running several sequences on one device at once (port of
``ur_mvo_tpu.parallel``): :class:`~ur_mvo_tpu_torch.parallel.multi_seq.MultiSequenceVO`."""
