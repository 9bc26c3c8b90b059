"""The port's benchmark (``BENCHMARK.json`` at the repository's root).

``run.py`` runs one cell. Everything that belongs to one configuration,
traffic mix, cell or metric is a file of its own under this folder, found
by the name ``BENCHMARK.json`` gives it (``README.md``)."""
