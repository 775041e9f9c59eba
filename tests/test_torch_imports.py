"""Boundaries of the port: it imports neither jax nor the reference package
(the subprocess check; tests that compare the two import both), it runs on
the CPU only when asked, and the surfaces ported since the first slice
work."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.engine import EngineConfig
from repro_torch.session import GraphSession

SRC = str(Path(__file__).resolve().parents[1] / "src")


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.session, repro_torch.state\n"
        "import repro_torch.kernels.spmv.ops, repro_torch.kernels.spmv.cuda\n"
        "import repro_torch.serve.graph_service, repro_torch.obs.metrics\n"
        "import repro_torch.core.distributed, repro_torch.dist.context\n"
        "import repro_torch.graph.pack, repro_torch.graph.compact\n"
        "import repro_torch.core.apps, repro_torch.baselines\n"
        "import repro_torch.baselines.esg, repro_torch.baselines.psw\n"
        "import repro_torch.obs, repro_torch.obs.controller\n"
        "import repro_torch.obs.trace, repro_torch.serve.bench\n"
        "import repro_torch.configs, repro_torch.models.model\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.models.xlstm, repro_torch.models.convert\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.train, repro_torch.train.checkpoint\n"
        "import repro_torch.train.data, repro_torch.launch.train\n"
        "import repro_torch.dist.spmd, repro_torch.launch.mesh\n"
        "import repro_torch.launch.shapes, repro_torch.launch.dryrun\n"
        "import repro_torch.examples, repro_torch.examples.quickstart\n"
        "import repro_torch.examples.graph_analytics\n"
        "import repro_torch.examples.serve_lm\n"
        "import repro_torch.examples.train_tiny_lm\n"
        "from repro_torch.serve import ServeEngine\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": SRC}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_session_without_device_needs_cuda(graph_store):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        GraphSession(str(graph_store.path))
    with pytest.raises(RuntimeError, match="cuda"):
        GraphSession(str(graph_store.path), device="cuda:0")


def test_train_cli_without_device_needs_cuda():
    """``python -m repro_torch.launch.train`` trains on the GPU unless
    ``--device cpu`` is given: without a GPU it raises, and trains
    nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "stablelm-1.6b", "--reduced", "--steps", "2", "--batch", "2",
         "--seq", "8"], capture_output=True, text=True,
        env={"PYTHONPATH": SRC}, timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "step" not in out.stdout


def test_mesh_without_device_needs_cuda():
    """``make_mesh(..., devices="cuda")`` wants one GPU a lane and raises
    with fewer; ``launch.train --mesh`` wants the GPUs unless given
    ``--device cpu``, and trains nothing on the CPU."""
    from repro_torch.launch.mesh import make_mesh
    if torch.cuda.device_count() >= 4:
        pytest.skip("four GPUs are present: the default lanes are usable")
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        make_mesh((2, 2), ("data", "model"), devices="cuda")
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        make_mesh((2, 2), ("data", "model"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "mixtral-8x22b", "--reduced", "--steps", "1", "--batch", "4",
           "--seq", "8", "--mesh", "2x2"]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         env={"PYTHONPATH": SRC}, timeout=120)
    assert out.returncode != 0
    assert "needs 4 CUDA devices" in out.stderr
    assert "step" not in out.stdout
    out = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                         text=True, env={"PYTHONPATH": SRC}, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done: 1 steps" in out.stdout


def test_use_kernel_true_on_cpu_raises(graph_store):
    with GraphSession(str(graph_store.path), device="cpu",
                      use_kernel=True) as s:
        with pytest.raises(ValueError, match="CUDA tensors"):
            s.run("bfs")


def test_config_validation_and_env(monkeypatch):
    with pytest.raises(ValueError, match="use_kernel"):
        EngineConfig(use_kernel="maybe")
    # the multi-device engine is ported: two lanes validate and build
    assert EngineConfig(num_devices=2).num_devices == 2
    monkeypatch.setenv("GRAPHMP_USE_KERNEL", "0")
    monkeypatch.setenv("GRAPHMP_PREFETCH", "3")
    cfg = EngineConfig.from_env()
    assert (cfg.use_kernel, cfg.prefetch_depth) == (False, 3)


def _service_attach_hub(s, hub):
    with s.service() as svc:
        assert svc.attach_hub(hub) is hub
        svc.submit("bfs", source=1, max_iters=3).result(timeout=60)
    return "serve"


def _session_attach_hub(s, hub):
    assert s.attach_hub(hub) is hub
    s.run("bfs", source=1, max_iters=3)
    return "session"


@pytest.mark.parametrize("call,item", [
    (_service_attach_hub, "A8"),
    (_session_attach_hub, "A8"),
])
def test_unported_session_surfaces_raise(graph_store, call, item):
    """The surfaces that raised until the telemetry hub (ROADMAP ``item``)
    was ported now work: ``attach_hub`` returns the hub, and its next
    snapshot carries the attached layer's metrics (held against the
    reference in tests/test_torch_obs.py)."""
    from repro_torch.obs import MetricsHub, validate_snapshot
    with GraphSession(str(graph_store.path), device="cpu") as s:
        hub = MetricsHub()
        prefix = call(s, hub)
    snap = hub.sample()
    validate_snapshot(snap)
    assert any(k.startswith(f"{prefix}.") for k in snap["gauges"])
    assert any(k.startswith(f"{prefix}.") for k in snap["histograms"])


def test_app_zoo_is_ported(graph_store):
    """``run_batch("lp")`` (ROADMAP A7) answers as the reference does."""
    from repro.session import GraphSession as RefSession
    with GraphSession(str(graph_store.path), device="cpu") as s, \
            RefSession(str(graph_store.path)) as ref:
        got = s.run_batch("lp", sources=[0, 5])
        want = ref.run_batch("lp", sources=[0, 5])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.values, w.values)
        assert g.iterations == w.iterations


def _mutate_and_continue(s):
    prev = s.run("sssp", source=0, max_iters=50)
    assert s.apply_mutations(inserts=[(0, 1)]) == 1
    inc = s.run_incremental("sssp", source=0, prev=prev, max_iters=50)
    assert inc.epoch == 1 and inc.converged
    assert inc.iterations <= prev.iterations


@pytest.mark.parametrize("kw,check", [
    (dict(backend="packed"),
     lambda s: type(s.store).__name__ == "PackedGraphStore"),
    (dict(backend="memory"),
     lambda s: type(s.store).__name__ == "MemoryGraphStore"),
    (dict(mutable=True),
     lambda s: type(s.store).__name__ == "DeltaGraphStore"),
    (dict(mutable=True), lambda s: s.apply_mutations(inserts=[(0, 1)]) == 1),
    (dict(mutable=True), _mutate_and_continue),
])
def test_ported_backends_and_mutation_work(graph_store, tmp_path, kw, check):
    """The packed and memory backends open, a mutable session commits at
    epoch 1 and ``run_incremental`` continues a run (each held against the
    reference in tests/test_torch_backends.py and test_torch_delta.py)."""
    import shutil
    store = tmp_path / "store"  # the packed file lands beside the store
    shutil.copytree(graph_store.path, store)
    with GraphSession(str(store), device="cpu", **kw) as s:
        assert check(s) in (True, None)
