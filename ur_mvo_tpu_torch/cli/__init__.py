"""Command-line entry points of the port, each run as
``python -m ur_mvo_tpu_torch.cli.<name>`` and callable in-process as
``main(argv)``: ``run_vo`` (one sequence), ``run_vo_multi`` (several
sequences lock-step on one device) and ``make_synthetic_dataset``."""
