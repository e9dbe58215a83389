"""One module per kind of traffic: ``setup``, ``window`` and ``check``."""
