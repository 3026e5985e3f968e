"""Traffic drivers, one a kind (``<kind>.py``: ``setup``, ``window``,
``release``, ``check``), and traffic mixes, one a name (``<name>.json``)."""
