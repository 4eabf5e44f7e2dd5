"""File formats: ``.h5ad`` (``io.h5ad``)."""
