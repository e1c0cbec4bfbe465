"""The port of ``repro.launch``: ``serve.py`` (batched prefill, then
decode), ``train.py`` (train steps with checkpoint/restart) and their step
functions, ``steps.py``; ``dryrun.py`` (every arch x shape cell traced on
the meta device), with its input shapes, ``shapes.py``, and its roofline
terms, ``roofline.py``, at the H100 constants of ``hardware.py``; the
mesh builders over ``torch.distributed`` ranks, ``mesh.py``."""
