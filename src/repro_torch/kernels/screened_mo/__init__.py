"""Screened MO product from packed candidate lists (port of
``repro.kernels.screened_mo``)."""
