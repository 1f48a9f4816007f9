"""Block-sparse MO product (port of ``repro.kernels.sparse_mo``)."""
