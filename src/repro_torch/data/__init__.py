"""Token sources for training: ``pipeline`` is a copy of the reference's
``src/repro/data/pipeline.py`` (numpy only)."""
