"""Front door of the PyTorch port: ``RunSpec``/``build_run`` and the ``qmc_run`` CLI."""
