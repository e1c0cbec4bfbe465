"""The port of ``repro.launch``: ``serve.py`` (batched prefill, then decode)."""
