"""Traffic: the mixes (``<name>.json``, a cell's ``traffic``) and the
general drivers of their kinds (``<kind>.py``, each a ``Driver``)."""
