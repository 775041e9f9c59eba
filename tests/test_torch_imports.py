"""Boundaries of the port: it imports neither jax nor the reference package,
it runs on the CPU only when asked, and what it has not ported raises."""
import subprocess
import sys
from pathlib import Path

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


def _service_attach_hub(s):
    with s.service() as svc:
        svc.attach_hub(None)


@pytest.mark.parametrize("call,item", [
    (lambda s: s.run_batch("lp", sources=[0]), "A7"),
    (lambda s: s.run_incremental("sssp", prev=None), "A5b"),
    (lambda s: s.apply_mutations(inserts=[(0, 1)]), "A5b"),
    (_service_attach_hub, "A8"),
    (lambda s: s.attach_hub(None), "A8"),
])
def test_unported_session_surfaces_raise(graph_store, call, item):
    with GraphSession(str(graph_store.path), device="cpu") as s:
        with pytest.raises(NotImplementedError, match=item):
            call(s)


@pytest.mark.parametrize("kw,item", [(dict(backend="packed"), "A5b"),
                                     (dict(backend="memory"), "A5b"),
                                     (dict(mutable=True), "A5b")])
def test_unported_backends_raise(graph_store, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        GraphSession(str(graph_store.path), device="cpu", **kw)
