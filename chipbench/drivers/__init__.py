"""How each kind of cell is driven: ``serve`` and ``train``."""
