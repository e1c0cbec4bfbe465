"""Finding the harness's files by the names in ``BENCHMARK.json``: a
configuration's generator (``configs/<generator>.py``), a traffic file's
arrival process (``traffic/<generator>.py``) and a metric's reader
(``metrics/<name>.py``, else ``metrics/<name up to its first dot>.py``)."""
from __future__ import annotations

import importlib.util
from pathlib import Path


def load_module(path: Path, kind: str):
    """A harness file found by name, loaded from its path."""
    name = "snnbench._found." + kind + "." + path.stem.replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(base: Path, name: str):
    for stem in (name, name.split(".")[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path, "metrics")
    raise FileNotFoundError(f"no reader for metric {name!r} under {base / 'metrics'}")
