"""The swap pipelines: a session that builds every component once, and the
swap / v2i / multi / stream paths over it (``cli/main.py`` runs them)."""
