"""The system under test: the port (``repro_torch``) built from the
benchmark's own graph, compiled by the port's compilers, and the compile
cache that keeps a later run from paying the compile again.

Only this module and ``serve.py`` import the port.
"""
from __future__ import annotations

import hashlib
import json
import pickle
import time
import types
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the harness's compile cache: the generated graph and the port's
#: CompileReports (and the trained classifier), one file a configuration
CACHE_DIR = Path(__file__).resolve().parent / ".cache" / "compile"
#: what the cache key hashes besides the configuration: the port's compilers
PROGRAM_SOURCES = ("src/repro_torch/core", "src/repro_torch/scaffold")


def port_network(graph: dict):
    """The port's ``SNNNetwork`` over the same arrays the reference reads."""
    from repro_torch.core.layer import (
        LIFParams, Population, SNNLayer, SNNNetwork, SparseProjection,
    )

    pops = graph["populations"]
    if graph["chain"]:
        layers = []
        for e, post in zip(graph["projections"], pops[1:]):
            w, d = e["dense"]
            layers.append(SNNLayer(
                weights=w, delays=d, delay_range=e["delay_range"],
                lif=LIFParams(alpha=post["alpha"], v_th=post["v_th"]),
                name=e["name"]))
        return SNNNetwork(layers=layers, name=graph["name"])
    lif = {p["name"]: LIFParams(alpha=p["alpha"], v_th=p["v_th"])
           for p in pops if p["alpha"] is not None}
    populations = [Population(p["name"], p["size"], lif=lif.get(p["name"]))
                   for p in pops]
    projections = []
    for e in graph["projections"]:
        proj = SparseProjection(
            n_source=e["n_source"], n_target=e["n_target"],
            indptr=e["indptr"], indices=e["indices"], values=e["weights"],
            delay_values=e["delays"], delay_range=e["delay_range"],
            name=e["name"], pre=e["pre"], post=e["post"])
        proj.lif = lif[e["post"]]
        projections.append(proj)
    return SNNNetwork(populations=populations, projections=projections,
                      name=graph["name"])


def compile_tenants(cfg: dict, net) -> tuple:
    """Each tenant's ``CompileReport`` by the port's own compilers, and the
    trained classifier (``None`` where no tenant needs one)."""
    from repro_torch.core import (
        SwitchingCompiler, generate_dataset, train_switch_classifier,
    )
    from repro_torch.scaffold import compile_scaffold

    clf, reports = None, {}
    for name, tenant in cfg["tenants"].items():
        how = tenant["compile"]
        if how == "classifier":
            if clf is None:
                grid = cfg["classifier"]
                ds = generate_dataset(
                    source_grid=tuple(grid["source_grid"]),
                    target_grid=tuple(grid["target_grid"]),
                    density_grid=tuple(grid["density_grid"]),
                    delay_grid=tuple(grid["delay_grid"]), seed=grid["seed"])
                clf, _ = train_switch_classifier(ds, seed=grid["seed"])
            reports[name] = SwitchingCompiler("classifier", clf).compile_network(net)
        elif how in ("serial", "parallel", "ideal"):
            reports[name] = SwitchingCompiler(how).compile_network(net)
        elif how == "scaffold":
            # compile_scaffold reads only the scaffold's network
            reports[name] = compile_scaffold(types.SimpleNamespace(network=net))
        else:
            raise ValueError(f"tenant {name!r}: unknown compile {how!r}")
    return reports, clf


def cache_key(cfg_path: Path, cfg: dict) -> str:
    h = hashlib.sha256(Path(cfg_path).read_bytes())
    h.update(json.dumps(cfg.get("seed")).encode())
    for top in PROGRAM_SOURCES:
        for f in sorted((ROOT / top).rglob("*.py")):
            h.update(str(f.relative_to(ROOT)).encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:20]


def load(cfg_path: Path, cfg: dict, generator: Path, *, fresh: bool):
    """``(graph, reports, compile_s)`` from the cache.  Where the cache has
    no entry, or ``fresh`` asks for a compile, a spawned process generates
    the graph, compiles it (timed: ``compile_s``, else ``None``) and writes
    the entry first, so that the measuring process holds the same objects,
    loaded the same way, whether or not this run compiled."""
    path = CACHE_DIR / f"{cfg['name']}-{cache_key(cfg_path, cfg)}.pkl"
    compile_s = None
    if fresh or not path.exists():
        with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
            compile_s = pool.submit(compile_to_cache, cfg, str(generator),
                                    str(path)).result()
    with open(path, "rb") as f:              # written by this harness only
        graph, reports, _ = pickle.load(f)
    return graph, reports, compile_s


def compile_to_cache(cfg: dict, generator: str, path: str) -> float:
    """Generate the configuration's graph, compile every tenant, write the
    cache entry; returns the compile's seconds (run in a spawned process)."""
    from snnbench.lookup import load_module

    graph = load_module(Path(generator), "configs").generate(cfg)
    net = port_network(graph)
    t0 = time.perf_counter()
    reports, clf = compile_tenants(cfg, net)
    compile_s = time.perf_counter() - t0
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump((graph, reports, clf), f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)
    return compile_s
