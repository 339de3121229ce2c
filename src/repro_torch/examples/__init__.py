"""The port's own copies of ``examples/quickstart.py`` and
``examples/train_100m.py`` (run them with ``python -m``)."""
