"""The port's training loop against the reference package, on the CPU:
the loss chunked over the sequence and the bf16 gradient barrier, AdamW (``apply_updates``, ``schedule``, ``global_norm``, ``init_state``),
the train step (``repro_torch.launch.steps``), the checkpoint manager (a
checkpoint written by either package restores in the other) and the
launcher ``repro_torch.launch.train`` with its checkpoint/restart.  Every
input is made with NumPy from a seed; the loss and its gradients are held
in ``tests/test_torch_train.py``, whose helpers this file shares.

Tolerances: AdamW's f32 leaves within ``rtol = 1e-6`` plus ``1e-6`` of the
leaf's scale (``update_close``), bf16 leaves equal or one bf16 ulp apart
(the f32 update may round to either neighbour); the global norm exact on
dyadic gradients, ``rtol = 1e-5`` on normal ones (the sums run in other
orders).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import steps as jax_steps
from repro.models import init as jax_init
from repro.models import model as jax_model
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, smoke_config
from repro_torch.launch import steps, train
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_keys, leaves
from test_torch_train import GRAD_TOL, both_grads, configs, grad_share, make_batch, to_torch


# -- the loss chunked, the bf16 gradient barrier ------------------------------------
def test_loss_chunk_matches_unchunked_and_the_reference():
    cfg, jcfg = configs("llama3.2-3b", loss_chunk=8)
    batch = make_batch(cfg, 2, 32)
    tl, tg, jl, jg, tp = both_grads(cfg, jcfg, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    grad_share(tg, jg)
    whole = M.train_loss(tp, dataclasses.replace(cfg, loss_chunk=0),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(whole), rtol=1e-5)


@pytest.mark.parametrize("arch,tol", [("llama3.2-3b", GRAD_TOL),
                                      ("recurrentgemma-2b", GRAD_TOL),
                                      ("mamba2-130m", 2e-3)])
def test_grad_bf16_barrier_matches_the_reference_and_is_active(arch, tol):
    """The barrier rounds each layer's cotangent to bf16, so an element
    whose f32 cotangent differs between the packages in its last bits may
    round to the other bf16 neighbour, 2^-8 of it apart.  mamba2's f32
    gradients differ by ~1e-5 of scale (A_log and dt_bias sum over every
    position), and such flips move its gradients by up to 5.7e-4 of scale
    (measured): held at 2e-3, about half a bf16 ulp; the barrier itself
    moves them by 3.8e-3."""
    cfg, jcfg = configs(arch, grad_bf16=True)
    batch = make_batch(cfg)
    tl, tg, jl, jg, tp = both_grads(cfg, jcfg, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    grad_share(tg, jg, tol)
    _, plain = M.value_and_grad(tp, dataclasses.replace(cfg, grad_bf16=False),
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    moved = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(leaves(tg), leaves(plain)) if b.any())
    assert moved > 1e-3          # measured 3.8e-3 to 8.5e-3


# -- AdamW --------------------------------------------------------------------------
def update_close(got, want):
    """rtol 1e-6 and an atol of 1e-6 of the leaf's scale: the packages may
    round a multiply-add by an ulp (XLA contracts them), and a cancelling
    difference such as ``p - lr * delta`` at a small ``p`` keeps the
    absolute error of its terms (1.2e-10 at lr 1e-3 measured)."""
    want = np.asarray(want, np.float64)
    diff = np.abs(np.asarray(got, np.float64) - want)
    assert (diff <= 1e-6 * (np.abs(want) + np.abs(want).max())).all(), diff.max()


def opt_inputs(dtype, seed, grad_scale, dyadic=True):
    """Mamba2 smoke params in ``dtype``, gradients, and AdamW moments, as
    NumPy trees.  Dyadic gradients (``grad_scale`` times +-2^-k, k in 0..2)
    make every sum of squares exact in f32 in any order, so the global norm
    is the same in both packages and the comparison holds the elementwise
    update; otherwise normal draws."""
    jcfg = dataclasses.replace(jax_smoke_config("mamba2-130m"), dtype=dtype)
    params = jax.tree.map(np.asarray, jax_init.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    draw = ((lambda shape: rng.choice([-1, 1], shape) * 2.0 ** -rng.integers(0, 3, shape))
            if dyadic else rng.normal)
    grads = jax.tree.map(lambda p: (draw(p.shape) * grad_scale).astype(p.dtype), params)
    m = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 1e-3).astype(np.float32), params)
    v = jax.tree.map(lambda p: (rng.random(p.shape) * 1e-5).astype(np.float32), params)
    return params, grads, m, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [2.0 ** -14, 0.25])     # unclipped, clipped
@pytest.mark.parametrize("step", [0, 5])
def test_apply_updates_matches_the_reference(dtype, grad_scale, step):
    params, grads, m, v = opt_inputs(dtype, seed=7, grad_scale=grad_scale)
    cfg = adamw.AdamWConfig(warmup_steps=3, total_steps=20)
    jstate = jax_adamw.AdamWState(jnp.int32(step), jax.tree.map(jnp.asarray, m),
                                  jax.tree.map(jnp.asarray, v))
    jp, js, jmet = jax_adamw.apply_updates(jax.tree.map(jnp.asarray, params),
                                           jax.tree.map(jnp.asarray, grads),
                                           jstate, jax_adamw.AdamWConfig(warmup_steps=3,
                                                                         total_steps=20))
    tstate = adamw.AdamWState(torch.tensor(step, dtype=torch.int32), to_torch(m), to_torch(v))
    tp, ts, tmet = adamw.apply_updates(to_torch(params), to_torch(grads), tstate, cfg)
    assert int(ts.step) == int(js.step) == step + 1
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
    assert float(tmet["grad_norm"]) == float(jmet["grad_norm"])   # dyadic: exact
    assert (float(jmet["grad_norm"]) > 1.0) == (grad_scale > 0.01)     # clipped
    for tree, jtree in ((ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(leaves(tree), jax.tree.leaves(jtree)):
            update_close(a.numpy(), b)
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        if dtype == "float32":
            update_close(a.numpy(), b)
        else:   # bf16 bit patterns equal or one ulp apart
            bits = a.view(torch.int16).numpy().astype(np.int32)
            ulps = np.abs(bits - np.asarray(b).view(np.int16).astype(np.int32))
            assert ulps.max() <= 1


@pytest.mark.parametrize("cfg", [
    adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    adamw.AdamWConfig(warmup_steps=1, total_steps=30),
    adamw.AdamWConfig(warmup_steps=100, total_steps=50),
])
def test_schedule_matches_the_reference(cfg):
    jcfg = jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    for step in range(0, 120, 3):
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jax_adamw.schedule(
            jcfg, jnp.int32(step))), rtol=1e-6)
    assert float(adamw.schedule(cfg, 0)) == pytest.approx(float(
        jax_adamw.schedule(jcfg, 0)), rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dyadic", [True, False])
def test_global_norm_matches_the_reference(dtype, dyadic):
    """Exact on dyadic gradients; on normal draws the two sums of 2^17
    squares run in other orders: rtol 1e-5 (1.4e-6 measured)."""
    _, grads, _, _ = opt_inputs(dtype, seed=8, grad_scale=1.0, dyadic=dyadic)
    got = float(adamw.global_norm(to_torch(grads)))
    want = float(jax_adamw.global_norm(jax.tree.map(jnp.asarray, grads)))
    if dyadic:
        assert got == want
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.init_state(params)
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
    loss = lambda p: torch.sum(p["w"] ** 2)
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, opt, _ = adamw.apply_updates(params, g, opt, cfg)
    assert float(loss(params)) < 1e-2
    assert int(opt.step) == 150 and opt.m["w"].dtype == torch.float32


def test_init_state_is_the_references():
    jcfg = jax_smoke_config("olmoe-1b-7b")
    jp = jax_init.init_params(jcfg, jax.random.PRNGKey(0))
    js = jax_adamw.init_state(jp)
    ts = adamw.init_state(to_torch(jp))
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    assert [k for k, _ in flatten_with_keys(ts)] == [
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(js)[0]]
    assert all(t.dtype == torch.float32 and not t.any() for t in leaves((ts.m, ts.v)))


# -- the train step -------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2-130m", "olmoe-1b-7b"])
def test_three_train_steps_match_the_reference(arch):
    """Each step starts from the reference's state carried into the port:
    the loss, grad norm, lr and gradients of the port's step against the
    reference's, and the update on identical inputs (the reference's
    gradients).  The reference's step is taken as its two halves, as its
    ``make_train_step`` composes them (``src/repro/launch/steps.py``
    23-30), so its value_and_grad compiles once."""
    cfg, jcfg = configs(arch)
    # the clip off: its norm sums in another order in each package (the
    # clip is held on dyadic gradients above)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3, clip_norm=1e3)
    jopt_cfg = jax_adamw.AdamWConfig(**dataclasses.asdict(opt_cfg))
    jvg = jax.jit(jax.value_and_grad(lambda p, b: jax_model.train_loss(p, jcfg, b)))
    tstep = steps.make_train_step(cfg, opt_cfg)
    jp = jax_init.init_params(jcfg, jax.random.PRNGKey(0))
    js = jax_adamw.init_state(jp)
    for k in range(3):
        batch = make_batch(cfg, 2, 32, seed=k)
        jbatch = {n: jnp.asarray(v) for n, v in batch.items()}
        tbatch = {n: torch.from_numpy(v) for n, v in batch.items()}
        tp, ts = to_torch(jp), adamw.AdamWState(
            torch.tensor(int(js.step), dtype=torch.int32), to_torch(js.m), to_torch(js.v))
        # the reference's train_step, its two halves apart
        jl, jg = jvg(jp, jbatch)
        jp2, js2, jmet = jax_adamw.apply_updates(jp, jg, js, jopt_cfg)
        jmet["loss"] = jl
        _, tg = M.value_and_grad(tp, cfg, tbatch)
        grad_share(tg, jg)
        _, _, tmet = tstep(tp, ts, tbatch)
        assert set(tmet) == set(jmet) == {"loss", "grad_norm", "lr"}
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-4)     # the gradients' own tolerance
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
        # the update on the reference's gradients
        up, us, umet = adamw.apply_updates(tp, to_torch(jg), ts, opt_cfg)
        assert float(umet["grad_norm"]) < opt_cfg.clip_norm
        for a, b in zip(leaves((up, us)), jax.tree.leaves((jp2, js2))):
            update_close(a.numpy(), b)
        jp, js = jp2, js2


def test_mesh_step_functions_return_the_references_trees():
    """The four sharding trees of llama3.2-3b's smoke config on a 2 x 2
    mesh give the reference's ``spec_for_shape`` leaf for leaf (the
    reference's own trees need devices; its rules read only the mesh's
    sizes), and ``make_train_step_compressed`` builds a step over a
    ``(pod, data, model)`` mesh and refuses a mesh without pods."""
    import repro.distributed.sharding as RS
    from repro.launch import shapes as jax_shapes
    from repro_torch.distributed import sharding as PS
    from repro_torch.launch.mesh import fake_world, make_mesh

    class Sizes:
        shape = {"data": 2, "model": 2}

    cfg, jcfg = configs("llama3.2-3b")
    rules = PS.make_rules()
    spec = lambda axes, shape: tuple(RS.spec_for_shape(axes, rules, shape, Sizes()))
    flat = lambda tree: [x for x in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, (tuple, PS.NamedSharding)))]
    p_sh = steps.param_shardings(cfg, Sizes.shape, rules)
    shapes = jax.tree.leaves(jax.eval_shape(
        lambda: jax_init.init_params(jcfg, jax.random.PRNGKey(0))))
    want = [spec(a, s.shape) for a, s in zip(flat(jax_init.param_specs(jcfg)), shapes)]
    assert [tuple(s.spec) for s in flat(p_sh)] == want
    o_sh = steps.opt_shardings(cfg, Sizes.shape, rules)
    assert tuple(o_sh.step.spec) == () and o_sh.m == o_sh.v == p_sh
    b_sh = steps.batch_shardings(cfg, Sizes.shape, rules, "train_4k")
    assert {k: tuple(v.spec) for k, v in b_sh.items()} == {
        k: spec(steps.BATCH_AXES[k], v.shape)
        for k, v in jax_shapes.batch_specs(jcfg, "train_4k").items()}
    c_sh = steps.cache_shardings(cfg, Sizes.shape, rules, "decode_32k")
    c_want = [spec(a, s.shape) for a, s in zip(
        flat(jax_steps.cache_logical_specs(jcfg)),
        jax.tree.leaves(jax_shapes.cache_specs(jcfg, "decode_32k")))]
    assert [tuple(s.spec) for s in flat(c_sh)] == c_want
    with fake_world(4):
        step = steps.make_train_step_compressed(
            cfg, adamw.AdamWConfig(), make_mesh((2, 1, 2), ("pod", "data", "model")))
        assert callable(step)
        with pytest.raises(ValueError, match="first axis is pod"):
            steps.make_train_step_compressed(
                cfg, adamw.AdamWConfig(), make_mesh((2, 2), ("data", "model")))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_logical_specs_and_step_wrappers_match_the_reference(arch):
    cfg, jcfg = configs(arch)
    assert steps.cache_logical_specs(cfg) == jax_steps.cache_logical_specs(jcfg)
    assert steps.make_opt_cfg(lr=0.5) == adamw.AdamWConfig(lr=0.5)
    params = to_torch(jax_init.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 2, 12).items()}
    with torch.inference_mode():
        logits, caches = steps.make_prefill_step(cfg, 16)(params, batch)
        want, _ = M.prefill(params, cfg, batch, 16)
        assert torch.equal(logits, want)
        pos = 12 + cfg.n_frontend_tokens
        out, _ = steps.make_serve_step(cfg, 16)(params, caches, torch.zeros(
            (2, 1), dtype=torch.int64), pos)
        assert out.shape == (2, 1, cfg.vocab)


# -- checkpoints --------------------------------------------------------------------
def ckpt_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones((4,), dtype=torch.bfloat16) * 1.5,
                  torch.zeros((), dtype=torch.int32)]}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = ckpt_tree()
    for step in (10, 20, 30):
        mgr.save(step, {"a": tree["a"] + step, "b": [tree["b"][0] + step,
                                                     tree["b"][1] + step]})
    assert mgr.list_steps() == [20, 30]          # keep=2
    restored = mgr.restore(tree, 30)
    assert torch.equal(restored["a"], tree["a"] + 30)
    assert restored["b"][0].dtype == torch.bfloat16
    assert torch.equal(restored["b"][0], tree["b"][0] + 30)
    assert restored["b"][1].dtype == torch.int32 and int(restored["b"][1]) == 30
    manifest = json.loads((tmp_path / "step_30" / "manifest.json").read_text())
    assert manifest["leaves"]["b/0"] == {"file": "shard_0.npz", "shape": [4],
                                         "dtype": "bfloat16"}
    assert not list(tmp_path.glob(".tmp_*"))     # published by rename


def test_checkpoint_async_write_and_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(5, {"x": torch.ones((8, 8))})
    mgr.wait()
    assert mgr.latest_step() == 5

    def fail(step, flat):
        raise OSError("disk full")

    mgr._write = fail
    mgr.save(6, {"x": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                   # the error is raised once


def test_checkpoint_restores_across_packages(tmp_path):
    """(params, AdamW state) of the mamba2 smoke config in bf16: written by
    either package, restored by the other, with identical manifest keys."""
    jcfg = dataclasses.replace(jax_smoke_config("mamba2-130m"), dtype="bfloat16")
    jp = jax_init.init_params(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    js = jax_adamw.AdamWState(jnp.int32(7), *(jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), jp) for _ in "mv"))
    tree_j = (jp, js)
    tree_t = (to_torch(jp), adamw.AdamWState(torch.tensor(7, dtype=torch.int32),
                                             to_torch(js.m), to_torch(js.v)))
    JaxCheckpointManager(str(tmp_path / "jax"), async_write=False).save(3, tree_j)
    CheckpointManager(str(tmp_path / "torch"), async_write=False).save(3, tree_t)
    manifests = [json.loads((tmp_path / d / "step_3" / "manifest.json").read_text())
                 for d in ("jax", "torch")]
    assert list(manifests[0]["leaves"]) == list(manifests[1]["leaves"])
    assert "0/groups/0/0/A_log" in manifests[0]["leaves"]
    assert "1/.step" in manifests[0]["leaves"]
    for key, meta in manifests[0]["leaves"].items():
        assert manifests[1]["leaves"][key] == meta, key

    template = jax.tree.map(torch.zeros_like, tree_t, is_leaf=torch.is_tensor)
    into_torch = CheckpointManager(str(tmp_path / "jax")).restore(template)
    into_jax = JaxCheckpointManager(str(tmp_path / "torch")).restore(
        jax.tree.map(jnp.zeros_like, tree_j))
    for t, j, ref in zip(leaves(into_torch), jax.tree.leaves(into_jax),
                         jax.tree.leaves(tree_j)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype) == str(ref.dtype)
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(ref, np.float32))
        np.testing.assert_array_equal(np.asarray(j, np.float32), np.asarray(ref, np.float32))
    assert isinstance(into_torch[1], adamw.AdamWState)


def test_fault_tolerant_driver_restores_through_the_manager(tmp_path):
    from repro_torch.distributed import FaultTolerantDriver, HostFailure, RestartPolicy

    mgr = CheckpointManager(str(tmp_path), async_write=False)
    calls = {"n": 0}

    def step_fn(state, step):
        calls["n"] += 1
        if step == 7 and calls["n"] == 8:      # fail once at step 7
            raise HostFailure("boom")
        return {"v": state["v"] + 1}

    drv = FaultTolerantDriver(mgr, RestartPolicy(max_retries=2), ckpt_every=5)
    out = drv.run({"v": np.zeros(3)}, step_fn, steps=10)
    np.testing.assert_allclose(out["v"], 10)  # exactly 10 effective steps


# -- the launcher ---------------------------------------------------------------------
LAUNCH = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps", "30",
          "--batch", "4", "--seq", "32", "--ckpt-every", "10"]


def test_train_main_restores_after_a_failure_and_matches_the_clean_run(tmp_path, capsys):
    clean = train.main(LAUNCH + ["--ckpt-dir", str(tmp_path / "clean")])
    failed = train.main(LAUNCH + ["--ckpt-dir", str(tmp_path / "failed"),
                                  "--simulate-failure", "15"])
    out = capsys.readouterr().out
    assert "FAILURE: injected failure at step 15" in out and "restored step 10" in out
    assert set(failed) == {"first_loss", "last_loss", "steps"} and failed["steps"] == 30
    assert failed["last_loss"] < failed["first_loss"]
    assert failed["first_loss"] == clean["first_loss"]
    cfg = smoke_config("llama3.2-3b")
    from repro_torch.models import init as minit
    params = minit.init_params(cfg, device="cpu")
    template = (params, adamw.init_state(params))
    a, b = (CheckpointManager(str(tmp_path / d)).restore(template, 30)
            for d in ("clean", "failed"))
    assert int(a[1].step) == int(b[1].step) == 30
    for x, y in zip(leaves(a), leaves(b)):
        assert float((x.float() - y.float()).abs().max()) <= (
            1e-6 * float(y.float().abs().max()))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_main_runs_every_arch_on_the_cpu(arch, tmp_path, capsys):
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert capsys.readouterr().out.startswith(f"arch={arch}-smoke params=")
    assert CheckpointManager(str(tmp_path)).list_steps() == [2]


def test_train_main_defaults(monkeypatch, tmp_path):
    """The reference's default arch; its own checkpoint directory; the
    card when no device is given (none here: it raises)."""
    seen = {}

    class Stop(Exception):
        pass

    def manager(directory, keep):
        seen["dir"] = directory
        raise Stop

    monkeypatch.setattr(train, "CheckpointManager", manager)
    with pytest.raises(Stop):
        train.main(["--smoke", "--device", "cpu", "--steps", "1"])
    assert seen["dir"].endswith("repro_torch_ckpt") and seen["dir"] != "/tmp/repro_ckpt"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
