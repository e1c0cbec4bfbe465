"""The port of ``repro.launch``: ``serve.py`` (batched prefill, then
decode), ``train.py`` (train steps with checkpoint/restart) and their step
functions, ``steps.py``."""
